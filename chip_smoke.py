#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--epochs 100] [--shape 100,500,500]

Run from the root of a checkout.  Phases, each fatal on failure:

1. environment: the card's name and power limit, torch and CUDA versions,
   the port's determinism settings;
2. build: every kernel of ``src/repro_torch/csrc`` with nvcc for sm_90a;
3. kernel parity and timing on the card, each kernel against its plain
   PyTorch version: ``conv2d3x3`` at every conv shape of the enhancer's
   forward (N=10 training batches and N=64 inference chunks of 512×512
   slices) plus odd sizes, stride 2 and Cout=1; ``fused_enhance`` byte for
   byte in float32 and float64, strict and relaxed, on the double-rounding
   canary and on a full field;
4. the main path at the paper's Hurricane-ISABEL size (three fields of
   100×500×500 float32, synthetic, from a seed): ``NeurLZ(device="cuda")
   .compress`` at rel_eb 1e-3 in strict mode, ``save``, ``Archive.open``,
   ``decode_all``; the 1× bound is checked on every field, and for one field
   the engine's encoder helpers are run again from the archived weights and
   the decode must equal the encoder's final field bit for bit;
5. the launch count of every kernel over the main path (each must be > 0);
6. a torch.profiler trace of ten training steps (device-busy share).

Times: ``ms``, ``plain_ms`` and ``library_ms`` are device time per call,
summed from a torch.profiler trace, so host time between launches is not in
them; ``wall_ms`` is the kernel wrapper's time per call back to back between
CUDA events, which holds the host's cost of a call where that is longer.

It prints a ``kernels`` JSON line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  Details go to ``--out`` (default
``build/chip_smoke/chip_smoke.json``), the archive to ``build/chip_smoke/``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
FP32_FLOPS = 67e12            # H100 SXM, float32 outside the tensor cores
FP64_FLOPS = 34e12            # H100 SXM, float64 outside the tensor cores

LAYERS_512 = [   # (layer, H, Cin, Cout, stride, relu) of one enhancer forward
    ("conv_in", 512, 1, 4, 1, True), ("down1", 512, 4, 4, 2, True),
    ("down2", 256, 4, 6, 2, True), ("down3", 128, 6, 6, 2, True),
    ("down4", 64, 6, 8, 2, True), ("conv_out", 512, 8, 1, 1, False)]
EXTRA_CONV = [   # (name, N, H, W, Cin, Cout, stride, relu)
    ("odd17x13", 2, 17, 13, 1, 4, 1, True),
    ("odd17x13_s2", 2, 17, 13, 4, 6, 2, True),
    ("even16x12_s2", 2, 16, 12, 6, 8, 2, False),
    ("cout1_17x13", 2, 17, 13, 8, 1, 1, False)]
CONV_TOL = 1e-5     # |kernel - plain| <= CONV_TOL * max(1, max|plain|):
#   float32 sums of <= 72 terms (9*Cin) in another order


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def wall_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time per call of ``iters`` back-to-back calls between two CUDA
    events: the device's time, or the host's where the host cannot enqueue
    the next call before the device has finished the last."""
    import torch
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20, warmup: int = 3, kernel: str | None = None
              ) -> float:
    """Mean device time of one call of ``fn``: the summed durations of the
    device activities (kernels, copies, fills) of ``iters`` calls in a
    torch.profiler trace, over ``iters``.  Host time between launches is not
    in it.  With ``kernel``, the trace must show exactly ``iters`` kernels
    whose name holds that string (one launch per call, each seen)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        raise AssertionError("the profiler saw no device activity")
    if kernel is not None:
        seen = sum(kernel in e.name for e in events)
        if seen != iters:
            raise AssertionError(f"the profiler saw {seen} {kernel} kernels "
                                 f"in {iters} calls")
    return sum(e.time_range.elapsed_us() for e in events) / 1e3 / iters


def bound(nbytes: float, ops: float, peak_ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def conv_phase(dev, report: dict) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import conv2d3x3 as conv

    gen = torch.Generator().manual_seed(1)
    cases = [(f"{name}_N{n}", n, h, h, cin, cout, s, relu, n == 10)
             for n in (10, 64) for name, h, cin, cout, s, relu in LAYERS_512]
    cases += [(*c, False) for c in EXTRA_CONV]
    rows, summary = [], {"ms": 0.0, "wall_ms": 0.0, "plain_ms": 0.0,
                         "bound_ms": 0.0, "library_ms": 0.0, "bytes_ms": 0.0,
                         "ops_ms": 0.0, "max_abs_err": 0.0}
    for name, n, h, w, cin, cout, s, relu, in_summary in cases:
        x = torch.randn((n, h, w, cin), generator=gen).to(dev)
        wt = (torch.randn((3, 3, cin, cout), generator=gen) * 0.3).to(dev)
        b = (torch.randn((cout,), generator=gen) * 0.1).to(dev)
        got = conv.conv2d3x3(x, wt, b, stride=s, relu=relu)
        want = conv.conv2d3x3_plain(x, wt, b, stride=s, relu=relu)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        scale = max(1.0, float(want.abs().max()))
        if not err <= CONV_TOL * scale:
            raise AssertionError(f"conv2d3x3 {name}: max |kernel - plain| "
                                 f"{err} > {CONV_TOL} * {scale}")
        row = {"case": name, "x": [n, h, w, cin], "cout": cout, "stride": s,
               "relu": relu, "max_abs_err": err}
        if h >= 64:
            ho, ylo, yhi = conv.same_pads(h, s)
            wo, xlo, xhi = conv.same_pads(w, s)
            # One library call over the same function: cuDNN on the same
            # NHWC data (a channels_last view), input pre-padded with XLA's
            # SAME pads (asymmetric at stride 2) outside the timed call.
            xl = F.pad(x, (0, 0, xlo, xhi, ylo, yhi)).permute(0, 3, 1, 2)
            wl = wt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            nbytes = 4 * (x.numel() + wt.numel() + b.numel() + n * ho * wo * cout)
            ops = 2 * 9 * cin * cout * n * ho * wo
            b_ms, by = bound(nbytes, ops, FP32_FLOPS)

            def run():
                return conv.conv2d3x3(x, wt, b, stride=s, relu=relu)
            row.update(
                ms=device_ms(run, kernel="conv3x3_kernel"),
                wall_ms=wall_ms(run),
                plain_ms=device_ms(lambda: conv.conv2d3x3_plain(
                    x, wt, b, stride=s, relu=relu), iters=5),
                library_ms=device_ms(lambda: F.conv2d(xl, wl, b, stride=s)),
                bound_ms=b_ms, bound_by=by, bytes=nbytes, ops=ops)
            if in_summary:
                for k in ("ms", "wall_ms", "plain_ms", "bound_ms", "library_ms"):
                    summary[k] += row[k]
                summary["bytes_ms"] += nbytes / HBM_BYTES_PER_S * 1e3
                summary["ops_ms"] += ops / FP32_FLOPS * 1e3
        summary["max_abs_err"] = max(summary["max_abs_err"], err)
        rows.append(row)
        print("conv2d3x3", json.dumps(row))
    report["conv2d3x3_cases"] = rows
    summary["bound_by"] = ("bytes" if summary.pop("bytes_ms") >= summary.pop("ops_ms")
                           else "operations")
    summary["timed_at"] = "sum of the six conv launches of one N=10 training forward"
    return summary


def enhance_phase(dev, shape, report: dict) -> dict:
    import numpy as np
    import torch
    from repro_torch.kernels import fused_enhance as fe

    def same(a, b):
        return a.cpu().numpy().tobytes() == b.cpu().numpy().tobytes()

    # The double-rounding canary: float64 add of (1, 2**-24 + 2**-48) rounds
    # to 1 + 2**-23 after the cast; an add in float32 (or a contracted FMA
    # in the wrong place) gives another value.
    rng = np.random.default_rng(7)
    dec = rng.standard_normal((3, 5, 7)).astype(np.float32)
    z = np.clip(rng.standard_normal((3, 5, 7)), -1, 1).astype(np.float32)
    orig = (dec + z * 1e-2 * rng.choice([0.5, 1.5], (3, 5, 7))).astype(np.float32)
    dec[0, 0, 0], z[0, 0, 0], orig[0, 0, 0] = 1.0, 2.0 ** -24, 1.0
    eb = 1.0 + 2.0 ** -24
    checks = []
    for dtype in (torch.float32, torch.float64):
        for strict in (True, False):
            args = (torch.from_numpy(z).to(dev),
                    torch.from_numpy(dec).to(dev, dtype),
                    torch.from_numpy(orig).to(dev, dtype))
            got = fe.fused_enhance(*args, eb, strict=strict)
            want = fe.fused_enhance_plain(*args, eb, strict=strict)
            ok = all(same(g, w) for g, w in zip(got, want))
            checks.append({"dtype": str(dtype), "strict": strict, "identical": ok})
            if not ok:
                raise AssertionError(f"fused_enhance differs from plain: "
                                     f"{dtype}, strict={strict}")
            if dtype == torch.float32 and float(got[0][0, 0, 0]) != 1.0 + 2.0 ** -23:
                raise AssertionError("fused_enhance double-rounding canary tripped")

    # Regulated head (off the main path): float64 sigmoid, compared with a
    # tolerance of 1e-12 * eb in case exp differs in its last ulp.
    gen = torch.Generator().manual_seed(2)
    zr = (torch.randn(10000, generator=gen) * 3).to(dev)
    dr = torch.randn(10000, generator=gen, dtype=torch.float64).to(dev)
    got = fe.fused_enhance(zr, dr, dr, 0.05, regulated=True, strict=False)[0]
    want = fe.fused_enhance_plain(zr, dr, dr, 0.05, regulated=True, strict=False)[0]
    reg_err = float((got - want).abs().max())
    if not reg_err <= 1e-12 * 0.05:
        raise AssertionError(f"fused_enhance regulated: max err {reg_err}")

    # A full field, float32 strict, as the main path calls it.
    n = int(np.prod(shape))
    zf = torch.randn(shape, generator=gen).clamp_(-1, 1).to(dev)
    decf = torch.randn(shape, generator=gen).to(dev)
    origf = (decf + 1e-3 * torch.randn(shape, generator=gen).to(dev)).contiguous()
    ebf = 1e-3
    got = fe.fused_enhance(zf, decf, origf, ebf, strict=True)
    want = fe.fused_enhance_plain(zf, decf, origf, ebf, strict=True)
    torch.cuda.synchronize()
    if not all(same(g, w) for g, w in zip(got, want)):
        raise AssertionError("fused_enhance differs from plain on the full field")
    nbytes = n * (4 + 4 + 4 + 4 + 1)
    b_ms, by = bound(nbytes, 6 * n, FP64_FLOPS)
    report["fused_enhance_checks"] = checks + [
        {"regulated_max_abs_err": reg_err}, {"full_field": list(shape),
                                            "identical": True}]
    def run():
        return fe.fused_enhance(zf, decf, origf, ebf)
    return {"max_abs_err": 0.0,
            "ms": device_ms(run, kernel="fused_enhance_kernel"),
            "wall_ms": wall_ms(run),
            "plain_ms": device_ms(lambda: fe.fused_enhance_plain(zf, decf, origf, ebf),
                                  iters=5),
            "bound_ms": b_ms, "bound_by": by, "library_ms": None,
            "timed_at": f"one float32 strict call over a {shape} field"}


def profile_train_steps(model, inputs, targets, steps: int = 10) -> dict:
    """Trace ``steps`` training steps (batch 10, full-size slices) with
    torch.profiler: wall time per step, device-busy time per step (the sum
    of the CUDA kernels' durations; one stream, so they do not overlap),
    kernels per step and the kernels that take the most time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import online_trainer
    from repro_torch.optim import AdamW

    dev = next(model.parameters()).device
    xs, ys = (torch.as_tensor(a, device=dev) for a in (inputs, targets))
    params = list(model.parameters())
    opt = AdamW(params)
    n = xs.shape[0]

    def step(i):
        idx = torch.arange(10 * i, 10 * i + 10, device=dev) % n
        loss = online_trainer.batch_loss(model, xs[idx], ys[idx])
        opt.step(torch.autograd.grad(loss, params), lr=1e-3)

    for i in range(3):
        step(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            step(i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_ms = sum(by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"steps": steps, "step_ms": wall * 1e3 / steps,
            "device_busy_ms_per_step": busy_ms / steps,
            "device_busy_share": busy_ms / (wall * 1e3),
            "kernels_per_step": len(kernels) / steps,
            "top_kernels_ms_per_step": [[k[:90], v / 1e3 / steps] for k, v in top]}


def profile_conv_stage(x, dev) -> dict:
    """Host share of the conventional stage of one field: the time inside
    the codec (zlib or zstd) against the whole ``szlike.compress``."""
    import cProfile
    import pstats
    import torch
    from repro_torch.compressors import szlike

    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.runcall(szlike.compress, x, 1e-3, device=dev)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    stats = pstats.Stats(prof).stats
    codec_s = sum(v[3] for (fn, _, name), v in stats.items()
                  if name in ("<built-in method zlib.compress>",)
                  or "ZstdCompressor" in name)
    return {"field_shape": list(x.shape), "szlike_compress_s": total,
            "codec_s": codec_s}


def main_path(dev, shape, epochs: int, report: dict) -> dict:
    import numpy as np
    import torch
    import repro_torch
    from repro_torch import kernels
    from repro_torch.compressors import szlike
    from repro_torch.core import metrics, neurlz, online_trainer, regulation
    from repro_torch.data import fields as fields_lib

    t = time.perf_counter()
    fields = fields_lib.make_fields("hurricane", shape, seed=0)
    print(f"data: hurricane {shape} x {list(fields)} float32, "
          f"{time.perf_counter() - t:.1f} s to generate")
    raw_mb = sum(x.nbytes for x in fields.values()) / 1e6
    path = ROOT / "build" / "chip_smoke" / "hurricane.nlz"
    path.parent.mkdir(parents=True, exist_ok=True)

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    sess = repro_torch.NeurLZ(epochs=epochs, device=dev)
    arc = sess.compress(fields, rel_eb=1e-3)
    torch.cuda.synchronize()
    t_compress = time.perf_counter() - t0
    t0 = time.perf_counter()
    nbytes = arc.save(path)
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    opened = repro_torch.Archive.open(path, device=dev)
    decoded = opened.decode_all()
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    launches = kernels.launch_counts()

    per_field = {}
    for name, x in fields.items():
        e = opened["fields"][name]
        eb = e["abs_eb"]
        chk = regulation.check_bound(x, decoded[name], eb, "strict")
        if not chk["ok"]:
            raise AssertionError(f"{name}: max error {chk['max_abs_err']} > {eb}")
        conv_rec = szlike.decompress(e["conv"], device=dev)
        per_field[name] = {
            "abs_eb": eb, "max_err_over_eb": chk["max_abs_err"] / eb,
            "psnr_conv": metrics.psnr(x, conv_rec),
            "psnr_enhanced": metrics.psnr(x, decoded[name]),
            "bitrate": opened.bitrate(name)["bitrate"],
            "conv_bitrate": opened.bitrate(name)["conv_bitrate"],
            "outlier_rate": e["outliers"]["count"] / x.size,
            "final_loss": e["loss_history"][-1]}
        print("field", name, json.dumps(per_field[name]))

    # The engine's own encoder helpers, from the archived weights: decode
    # must reproduce the encoder's final field bit for bit.
    name = "w"
    e, x = opened["fields"][name], fields[name]
    rec = szlike.decompress(e["conv"], device=dev)
    model = neurlz.decode_entry_net(e, dev)
    inputs, targets, _ = online_trainer.make_dataset(rec, x, e["abs_eb"])
    resid = online_trainer.predict_residual(model, inputs)
    final, mask = neurlz.enhance_and_mask(x, rec, resid, e["abs_eb"], sess.config)
    redecoded = neurlz.decode_field_entry(e, rec, [], 0, dev)
    final = final.cpu().numpy()
    if not (final.tobytes() == redecoded.tobytes() == decoded[name].tobytes()):
        raise AssertionError(f"{name}: decode differs from the encoder's field")
    if int(mask.sum()) != e["outliers"]["count"]:
        raise AssertionError(f"{name}: outlier mask differs from the archive's")

    trace = profile_train_steps(model, inputs, targets)
    print("train_step_trace", json.dumps(trace))
    conv_profile = profile_conv_stage(x, dev)
    print("conv_stage_profile", json.dumps(conv_profile))

    timing = dict(arc["timing"])
    out = {"shape": list(shape), "fields": list(fields), "epochs": epochs,
           "rel_eb": 1e-3, "mode": "strict", "archive_bytes": nbytes,
           "compress_s": t_compress, "save_s": t_save, "decode_s": t_decode,
           "compress_MB_per_s": raw_mb / t_compress,
           "decode_MB_per_s": raw_mb / t_decode, "stages": timing,
           "per_field": per_field, "launches": launches,
           "decode_equals_encoder": True, "train_step_trace": trace,
           "conv_stage_profile": conv_profile}
    print("main_path", json.dumps({k: v for k, v in out.items()
                                   if k != "per_field"}))
    report["main_path"] = out
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--shape", default="100,500,500")
    ap.add_argument("--out", default=str(ROOT / "build" / "chip_smoke" / "chip_smoke.json"))
    args = ap.parse_args()
    shape = tuple(int(s) for s in args.shape.split(","))

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch import device as device_lib
    from repro_torch import kernels
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    dev = device_lib.resolve("cuda")
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    report = {"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda}

    t = time.perf_counter()
    logs = _build.build()
    report["build_s"] = time.perf_counter() - t
    report["ptxas"] = {n: [ln for ln in log.splitlines()
                           if "registers" in ln or "spill" in ln]
                       for n, log in logs.items()}
    print(f"build: {sorted(logs)} in {report['build_s']:.1f} s (nvcc sm_90a)")
    for n, lines in report["ptxas"].items():
        print(f"  {n}: " + " | ".join(ln.strip() for ln in lines))

    summaries = {"conv2d3x3": conv_phase(dev, report),
                 "fused_enhance": enhance_phase(dev, shape, report)}
    if args.epochs < 100:
        print(f"main path: epochs cut to {args.epochs} of the paper's 100 "
              "(the shape is never cut)")
    launches = main_path(dev, shape, args.epochs, report)
    if not all(launches[k] > 0 for k in kernels.KERNELS):
        raise AssertionError(f"a kernel never ran on the main path: {launches}")

    meta = {"conv2d3x3": ("src/repro_torch/csrc/conv2d3x3.cu",
                          "src/repro/kernels/conv2d3x3.py:63"),
            "fused_enhance": ("src/repro_torch/csrc/fused_enhance.cu",
                              "src/repro/kernels/fused_enhance.py:49")}
    line = {"kernels": [
        {"name": n, "route": "cuda", "source": meta[n][0], "replaces": meta[n][1],
         "launches": launches[n], "max_abs_err": s["max_abs_err"], "ms": s["ms"],
         "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
         "bound_by": s["bound_by"], "library_ms": s["library_ms"]}
        for n, s in summaries.items()]}
    report["kernels"] = line["kernels"]
    report["summaries"] = summaries
    report["total_s"] = time.perf_counter() - t_start
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    print(f"total {report['total_s']:.1f} s; details in {out}")
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
