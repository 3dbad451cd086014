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
   slices) plus odd sizes, stride 2 and Cout=1; its backward
   ``conv2d3x3_bwd`` (dgrad and wgrad in one launch, two at down1-down3)
   at the six training shapes and the odd and even test shapes, twice on
   the same inputs (byte-identical); the grouped forward and backward
   (``conv2d3x3_grouped``, ``conv2d3x3_grouped_bwd``: three fields in one
   launch, each with its own weights) at the six layers of a stacked
   training step (F=3, N=10, 512²), each field byte for byte against the
   single-field kernel and within tolerance of the plain version, with
   and without dx, twice byte-identical, each field's ticket back at 0;
   ``fused_enhance`` byte for
   byte in float32 and float64, strict and relaxed, on the double-rounding
   canary and on a full field; ``lorenzo3d_fwd`` and ``lorenzo3d_inv`` byte
   for byte on the stacked float64 group of the snapshot's three fields
   (each with its own bound) and on the reference's probe canaries, the
   inverse allocating no full-size scratch;
4. the main path at the paper's Hurricane-ISABEL size (three fields of
   100×500×500 float32, synthetic, from a seed): ``NeurLZ(device="cuda")
   .compress`` at rel_eb 1e-3 in strict mode, ``save``, ``Archive.open``,
   ``decode_all``; the 1× bound is checked on every field, and for one field
   the engine's encoder helpers are run again from the archived weights and
   the decode must equal the encoder's final field bit for bit; then
   torch.profiler traces of ten training steps, with the plain-PyTorch
   conv backward and with the kernels, in turns (plain, kernel, kernel,
   plain): step time, kernels per step, device-busy share; and of ten
   stacked steps of three fields beside ten rounds of three serial steps,
   in turns (serial, stacked, stacked, serial);
5. the Lorenzo path on the same snapshot: ``NeurLZ(compressor=
   "szlike-lorenzo")``, its conventional stage one batched group of three
   fields, the same checks on every field, at LORENZO_EPOCHS epochs (its
   training is the main path's; the cut keeps the run inside its time
   limit);
6. the durable path on the same snapshot: the main path's configuration
   with telemetry (spans, counters, learning traces with the sample-PSNR
   hook) and faults (``train.precip`` injected, so ``precip`` degrades to
   conv-only; the first ``decode.entry`` read injected and healed by a
   retry), at DURABLE_EPOCHS epochs; the entries written one by one into
   an fsync'ed ``NLZSTRM2`` container, opened lazily and decoded field by
   field; ``cloud`` and ``w`` must equal, entry and decode bit for bit, the
   serial engine's at those epochs (``NeurLZ.compress`` of the three
   fields without telemetry or faults), ``precip`` its
   conventional reconstruction; then ``verify`` on the container and on
   a copy with a flipped bit, and ``repair=True`` on a copy cut before its
   footer; the Chrome trace goes to ``build/chip_smoke/durable_trace.json``;
7. the batched path on the same snapshot: ``NeurLZ(engine="batched",
   field_batching="vmap", group_size=0)``, one group of three fields
   trained stacked through the grouped kernels at DURABLE_EPOCHS epochs,
   decoded with ``engine="batched"``; the bound on every field, decode
   equal to the encoder's final field bit for bit, conventional payloads
   equal to the main path's, and the main path's archive decoded by the
   batched engine equal to its serial decode byte for byte;
   ``stacked_bit_parity`` at the group's signature: where it holds, every
   entry must equal the durable path's serial reference (same epochs) by
   SHA-256, else each field's PSNR and bit rate are printed beside it;
8. the streaming path on the same snapshot: the fields written as ``.npy``
   files into ``build/chip_smoke/npys/``, ``NeurLZ(group_size=1,
   max_resident_bytes=STREAM_BUDGET).compress_to`` of that directory into
   a container (the three fields' working sets exceed the budget), decoded
   by ``streaming.iter_decompress`` and one ROI of ``w``; every entry must
   equal the main path's by SHA-256, every decode its decode, the ROI its
   slice, the ledger's peak stay within the budget and the ledger evict;
   it prints the compress and decode times, the writer thread's busy and
   put-wait seconds and the ledger's peak;
9. a ``zfplike`` conventional round trip on one full field;
10. the launch count of every kernel over each path, counted from 0 just
    before the path: each kernel of a path must have launched in it; and
    each path's ``torch.cuda.max_memory_allocated``, reset before it.

Times: ``ms``, ``plain_ms`` and ``library_ms`` are device time per call,
summed from a torch.profiler trace that must hold every launch of the
timed calls (``device_ms``), so host time between launches is not in
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
#   float32 sums of <= 72 terms (9*Cin, or 9*Cout for dgrad) in another order
WGRAD_TOL = 1e-5    # |kernel - plain| <= WGRAD_TOL * sum|x * g'| + 1e-6 for dw
#   and db: float32 sums of up to N*Ho*Wo = 2.6M terms, in blocks, in another
#   order than cuBLAS's; a wrong or missing tap moves a sum by a large share


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


# The device's timestamps reach the host's clock with an offset that moves
# by milliseconds from trace to trace, and the profiler drops every device
# activity that falls outside its window: a short trace can come back with
# part of its kernels or none (scripts/profiler_trace_probe.py).  Each trace
# therefore pauses the host on both sides of the traced calls, and one that
# is still incomplete is taken again, at most TRACE_TRIES times in all.
TRACE_PAD_S = 0.005
TRACE_TRIES = 4
# Calls of device_ms that needed more than one trace: {name: traces taken}.
RETRACED: dict[str, int] = {}


def traced(fn):
    """Run ``fn()`` inside a torch.profiler trace whose window reaches
    TRACE_PAD_S past the device work on both sides; returns the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(TRACE_PAD_S)
        fn()
        torch.cuda.synchronize()
        time.sleep(TRACE_PAD_S)
    return prof


def device_events(prof) -> list:
    import torch
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def device_ms(fn, iters: int = 20, warmup: int = 3, kernel: str | None = None,
              per_call: int = 1, name: str | None = None,
              by_name: dict | None = None) -> float:
    """Mean device time of one call of ``fn``: the summed durations of the
    device activities (kernels, copies, fills) of ``iters`` calls in a
    torch.profiler trace, over ``iters``.  Host time between launches is not
    in it.  The trace must be complete: with ``kernel``, exactly
    ``per_call`` kernels per call whose name holds that string; without,
    a positive multiple of ``iters`` device activities.  An incomplete
    trace is taken again (noted in ``RETRACED``); after TRACE_TRIES
    incomplete traces it raises.  ``by_name``, where given, is filled in
    place with each device activity's name and its device time per call."""
    for _ in range(warmup):
        fn()

    def calls():
        for _ in range(iters):
            fn()
    counts = []
    for attempt in range(1, TRACE_TRIES + 1):
        events = device_events(traced(calls))
        seen = sum(kernel in e.name for e in events) if kernel else len(events)
        counts.append(seen)
        if (seen == iters * per_call if kernel
                else seen > 0 and seen % iters == 0):
            if attempt > 1:
                RETRACED[name or kernel or "fn"] = attempt
                print(f"device_ms: {name or kernel}: {attempt} traces "
                      f"(device activities seen: {counts})")
            for e in events if by_name is not None else ():
                by_name[e.name] = (by_name.get(e.name, 0.0)
                                   + e.time_range.elapsed_us() / 1e3 / iters)
            return sum(e.time_range.elapsed_us() for e in events) / 1e3 / iters
    raise AssertionError(
        f"device_ms: {name or kernel}: {TRACE_TRIES} incomplete traces of "
        f"{iters} calls (device activities seen: {counts}, want "
        f"{iters * per_call if kernel else 'a positive multiple of ' + str(iters)})")


def bound(nbytes: float, ops: float, peak_ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def path_needs_dx(layer: str) -> bool:
    """Whether a training step asks the conv backward for dx at this layer
    of LAYERS_512: not at conv_in, whose input takes no gradient."""
    return layer != "conv_in"


def time_bwd(conv, g, y, x, wt, *, stride: int, relu: bool, need_dx: bool,
             name: str, by_name: dict | None = None) -> tuple[float, int]:
    """Device time of one ``conv2d3x3_bwd`` call and the kernels a call
    launches (``bwd_kernels_per_call``): each trace must hold exactly that
    many ``conv3x3_bwd`` kernels a call."""
    per_call = conv.bwd_kernels_per_call(x.shape, wt.shape[-1], stride=stride,
                                         need_dx=need_dx)
    ms = device_ms(lambda: conv.conv2d3x3_bwd(g, y, x, wt, stride=stride,
                                              relu=relu, need_dx=need_dx),
                   kernel="conv3x3_bwd", per_call=per_call, name=name,
                   by_name=by_name)
    return ms, per_call


def time_lorenzo_inv(lz, delta, eb, by_name: dict | None = None) -> float:
    """Device time of one ``lorenzo3d_inv`` call: two kernels, the bands'
    carry rows, then each band's walk over z."""
    return device_ms(lambda: lz.lorenzo3d_inv(delta, eb), kernel="lorenzo3d_inv",
                     per_call=2, by_name=by_name)


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
                ms=device_ms(run, kernel="conv3x3_fwd_kernel"),
                wall_ms=wall_ms(run),
                plain_ms=device_ms(lambda: conv.conv2d3x3_plain(
                    x, wt, b, stride=s, relu=relu), iters=5,
                    name=f"conv2d3x3_plain {name}"),
                library_ms=device_ms(lambda: F.conv2d(xl, wl, b, stride=s),
                                     name=f"cuDNN {name}"),
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
    # The device time of the smallest kernel: PyTorch's fill of one float.
    one = torch.empty(1, device=dev)
    summary["launch_floor_ms"] = device_ms(one.zero_,
                                           name="launch floor (fill of 1 float)")
    summary["bound_by"] = ("bytes" if summary.pop("bytes_ms") >= summary.pop("ops_ms")
                           else "operations")
    summary["timed_at"] = "sum of the six conv launches of one N=10 training forward"
    return summary


def conv_bwd_phase(dev, report: dict) -> dict:
    """``conv2d3x3_bwd`` against its plain version at the six training
    shapes (N=10, 512²) and the odd and even test shapes, with and without
    dx (the wgrad launch is sized by dgrad's share, so each is its own
    configuration), each twice on the same inputs (byte-identical); then
    timed at the training shapes as the main path calls it (conv_in
    without dgrad) beside the plain version and one
    ``aten.convolution_backward`` call.  A call is one launch, or two
    where dgrad runs apart from wgrad (``kernels_per_call``, from the
    wrapper's ``bwd_kernels_per_call``; each trace must hold exactly that
    many kernels a call); where the path needs dx, the same call without
    dx (``ms_without_dx``, wgrad alone) shows what dgrad adds."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import conv2d3x3 as conv

    gen = torch.Generator().manual_seed(4)
    cases = [(f"{name}_N10", 10, h, h, cin, cout, s, relu, True)
             for name, h, cin, cout, s, relu in LAYERS_512]
    cases += [(*c, False) for c in EXTRA_CONV]
    rows, summary = [], {"ms": 0.0, "wall_ms": 0.0, "plain_ms": 0.0,
                         "bound_ms": 0.0, "library_ms": 0.0, "max_abs_err": 0.0}
    nbytes_sum = ops_sum = 0.0
    for name, n, h, w, cin, cout, s, relu, timed in cases:
        x = torch.randn((n, h, w, cin), generator=gen).to(dev)
        wt = (torch.randn((3, 3, cin, cout), generator=gen) * 0.3).to(dev)
        b = (torch.randn((cout,), generator=gen) * 0.1).to(dev)
        y = conv.conv2d3x3(x, wt, b, stride=s, relu=relu)
        g = torch.randn(tuple(y.shape), generator=gen).to(dev)
        want_dx = conv.conv2d3x3_dgrad_plain(g, y, wt, x.shape, stride=s, relu=relu)
        want_dw, want_db = conv.conv2d3x3_wgrad_plain(g, y, x, stride=s, relu=relu)
        gm = conv.relu_mask(g, y, relu)
        terms_dw, terms_db = conv.conv2d3x3_wgrad_plain(gm.abs(), y, x.abs(),
                                                        stride=s, relu=False)
        errs = {}
        for with_dx in (True, False):
            tag = "" if with_dx else "_without_dx"
            got = conv.conv2d3x3_bwd(g, y, x, wt, stride=s, relu=relu,
                                     need_dx=with_dx)
            again = conv.conv2d3x3_bwd(g, y, x, wt, stride=s, relu=relu,
                                       need_dx=with_dx)
            if (got[0] is None) == with_dx:
                raise AssertionError(f"conv2d3x3_bwd {name}{tag}: dx is "
                                     f"{'missing' if with_dx else 'returned'}")
            if not all(_bits_equal(a, e) for a, e in zip(got, again)
                       if a is not None):
                raise AssertionError(f"conv2d3x3_bwd {name}{tag}: two calls differ")
            torch.cuda.synchronize()
            if with_dx:
                errs["dx"] = float((got[0] - want_dx).abs().max())
                dx_scale = max(1.0, float(want_dx.abs().max()))
                if not errs["dx"] <= CONV_TOL * dx_scale:
                    raise AssertionError(
                        f"conv2d3x3_bwd {name}: dx max |kernel - plain| "
                        f"{errs['dx']} > {CONV_TOL} * {dx_scale}")
            for k, a, e, t in (("dw", got[1], want_dw, terms_dw),
                               ("db", got[2], want_db, terms_db)):
                errs[k + tag] = float((a - e).abs().max())
                if not bool(((a - e).abs() <= WGRAD_TOL * t + 1e-6).all()):
                    raise AssertionError(f"conv2d3x3_bwd {name}{tag}: {k} beyond "
                                         f"{WGRAD_TOL} * sum|x g'| ({errs[k + tag]})")
        row = {"case": name, "x": [n, h, w, cin], "cout": cout, "stride": s,
               "relu": relu, "max_abs_err": errs, "identical_twice": True}
        if timed:
            need_dx = path_needs_dx(name.removesuffix("_N10"))
            ho, ylo, yhi = conv.same_pads(h, s)
            wo, xlo, xhi = conv.same_pads(w, s)
            # Bytes: x, w, g (and y for the ReLU mask) read once; dx (where
            # the path needs it), dw and db written once.  Operations: the
            # multiply-adds of dgrad and wgrad and the adds of db.
            m = n * ho * wo
            nbytes = 4 * (x.numel() * (2 if need_dx else 1) + 2 * wt.numel()
                          + g.numel() * (2 if relu else 1) + cout)
            ops = 2 * 9 * cin * cout * m * (2 if need_dx else 1) + m * cout
            b_ms, by = bound(nbytes, ops, FP32_FLOPS)
            # One library call over the same function: aten's convolution
            # backward (cuDNN) on the NHWC data as channels_last views, the
            # input pre-padded with XLA's SAME pads and g' masked outside the
            # timed call (its dx is that of the padded input), TF32 off.
            xl = F.pad(x, (0, 0, xlo, xhi, ylo, yhi)).permute(0, 3, 1, 2)
            wl = wt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            gl = gm.permute(0, 3, 1, 2)

            def run():
                return conv.conv2d3x3_bwd(g, y, x, wt, stride=s, relu=relu,
                                          need_dx=need_dx)

            def plain():
                dx = (conv.conv2d3x3_dgrad_plain(g, y, wt, x.shape, stride=s,
                                                 relu=relu) if need_dx else None)
                return dx, conv.conv2d3x3_wgrad_plain(g, y, x, stride=s, relu=relu)

            def library():
                return torch.ops.aten.convolution_backward(
                    gl, xl, wl, [cout], [s, s], [0, 0], [1, 1], False, [0, 0],
                    1, [need_dx, True, True])
            by_kernel: dict[str, float] = {}
            ms, per_call = time_bwd(conv, g, y, x, wt, stride=s, relu=relu,
                                    need_dx=need_dx, name=f"conv2d3x3_bwd {name}",
                                    by_name=by_kernel)
            row.update(
                need_dx=need_dx, ms=ms, ms_by_kernel=by_kernel,
                kernels_per_call=per_call,
                ms_without_dx=time_bwd(
                    conv, g, y, x, wt, stride=s, relu=relu, need_dx=False,
                    name=f"conv2d3x3_bwd {name} without dx")[0] if need_dx else None,
                wall_ms=wall_ms(run),
                plain_ms=device_ms(plain, iters=5, name=f"conv2d3x3_bwd plain {name}"),
                library_ms=device_ms(library, name=f"convolution_backward {name}"),
                bound_ms=b_ms, bound_by=by, bytes=nbytes, ops=ops)
            for k in ("ms", "wall_ms", "plain_ms", "bound_ms", "library_ms"):
                summary[k] += row[k]
            nbytes_sum += nbytes
            ops_sum += ops
        summary["max_abs_err"] = max(summary["max_abs_err"], *errs.values())
        rows.append(row)
        print("conv2d3x3_bwd", json.dumps(row))
    report["conv2d3x3_bwd_cases"] = rows
    summary["bound_by"] = bound(nbytes_sum, ops_sum, FP32_FLOPS)[1]
    summary["timed_at"] = ("sum of the six conv backward calls of one N=10 "
                           "training step (conv_in without dgrad)")
    return summary


GROUP_F = 3    # fields of the batched path's one group
# Training cut from the paper's 100 epochs on three paths, so that the run
# stays inside its time limit on a slower host (the batched path at
# DURABLE_EPOCHS, held against the durable path's serial reference); the
# main and streaming paths train 100.
LORENZO_EPOCHS = 5
DURABLE_EPOCHS = 10


def grouped_phase(dev, report: dict) -> dict:
    """``conv2d3x3_grouped`` and ``conv2d3x3_grouped_bwd`` at the six layers
    of a stacked training step (F=3 fields of N=10 512² slices): each
    field's output byte for byte against the single-field kernel on that
    field, the whole within tolerance of the plain grouped version (the
    single-field tolerances), two calls byte-identical, every field's
    ticket back at 0; the backward with and without dx.  Then each timed as
    the stacked step calls it (conv_in without dx) beside its plain version
    and one grouped PyTorch call on the same data (``F.conv2d(groups=F)``,
    ``aten.convolution_backward`` with ``groups=F``) on the fields stacked
    along the channels, XLA's pads and the ReLU mask outside the timed
    call.  Returns the forward's and the backward's summaries."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import conv2d3x3 as conv

    gen = torch.Generator().manual_seed(6)
    nf, n = GROUP_F, 10
    keys = ("ms", "wall_ms", "plain_ms", "bound_ms", "library_ms")
    fwd = dict.fromkeys(keys, 0.0) | {"max_abs_err": 0.0}
    bwd = dict.fromkeys(keys, 0.0) | {"max_abs_err": 0.0}
    sums = {"fwd": [0.0, 0.0], "bwd": [0.0, 0.0]}
    rows = []
    for name, h, cin, cout, s, relu in LAYERS_512:
        x = torch.randn((nf * n, h, h, cin), generator=gen).to(dev)
        wt = (torch.randn((nf, 3, 3, cin, cout), generator=gen) * 0.3).to(dev)
        b = (torch.randn((nf, cout), generator=gen) * 0.1).to(dev)
        parts = [slice(f * n, (f + 1) * n) for f in range(nf)]
        y = conv.conv2d3x3_grouped(x, wt, b, stride=s, relu=relu)
        again = conv.conv2d3x3_grouped(x, wt, b, stride=s, relu=relu)
        singles = [conv.conv2d3x3(x[p], wt[f], b[f], stride=s, relu=relu)
                   for f, p in enumerate(parts)]
        if not (_bits_equal(y, again) and all(
                _bits_equal(y[p], one) for p, one in zip(parts, singles))):
            raise AssertionError(f"conv2d3x3_grouped {name}: a field differs "
                                 "from its single-field launch")
        want = conv.conv2d3x3_grouped_plain(x, wt, b, stride=s, relu=relu)
        err = float((y - want).abs().max())
        scale = max(1.0, float(want.abs().max()))
        if not err <= CONV_TOL * scale:
            raise AssertionError(f"conv2d3x3_grouped {name}: max |kernel - "
                                 f"plain| {err} > {CONV_TOL} * {scale}")
        g = torch.randn(tuple(y.shape), generator=gen).to(dev)
        errs = {}
        for with_dx in (True, False):
            tag = "" if with_dx else "_without_dx"
            got = conv.conv2d3x3_bwd_grouped(g, y, x, wt, stride=s, relu=relu,
                                             need_dx=with_dx)
            twice = conv.conv2d3x3_bwd_grouped(g, y, x, wt, stride=s,
                                               relu=relu, need_dx=with_dx)
            for f, p in enumerate(parts):
                one = conv.conv2d3x3_bwd(g[p], y[p], x[p], wt[f], stride=s,
                                         relu=relu, need_dx=with_dx)
                same = [_bits_equal(got[1][f], one[1]),
                        _bits_equal(got[2][f], one[2])]
                if with_dx:
                    same.append(_bits_equal(got[0][p], one[0]))
                if not all(same):
                    raise AssertionError(f"conv2d3x3_bwd_grouped {name}{tag}: "
                                         f"field {f} differs from its "
                                         "single-field call")
            if not all(_bits_equal(a, e) for a, e in zip(got, twice)
                       if a is not None):
                raise AssertionError(f"conv2d3x3_bwd_grouped {name}{tag}: two "
                                     "calls differ")
            if int(conv.group_tickets(dev, nf).abs().sum()) != 0:
                raise AssertionError(f"conv2d3x3_bwd_grouped {name}{tag}: a "
                                     "ticket is not back at 0")
            if with_dx:
                want_dx = conv.conv2d3x3_grouped_dgrad_plain(
                    g, y, wt, x.shape, stride=s, relu=relu)
                errs["dx"] = float((got[0] - want_dx).abs().max())
                if not errs["dx"] <= CONV_TOL * max(1.0, float(want_dx.abs().max())):
                    raise AssertionError(f"conv2d3x3_bwd_grouped {name}: dx "
                                         f"max |kernel - plain| {errs['dx']}")
            want_dw, want_db = conv.conv2d3x3_grouped_wgrad_plain(
                g, y, x, nf, stride=s, relu=relu)
            terms = conv.conv2d3x3_grouped_wgrad_plain(
                conv.relu_mask(g, y, relu).abs(), y, x.abs(), nf, stride=s,
                relu=False)
            for k, a, e, t in (("dw", got[1], want_dw, terms[0]),
                               ("db", got[2], want_db, terms[1])):
                errs[k + tag] = float((a - e).abs().max())
                if not bool(((a - e).abs() <= WGRAD_TOL * t + 1e-6).all()):
                    raise AssertionError(f"conv2d3x3_bwd_grouped {name}{tag}: "
                                         f"{k} beyond {WGRAD_TOL} * sum|x g'|")

        # Timing.  The library's data: the fields stacked along channels,
        # [N, F*C, H, W] as channels_last views, XLA's pads outside.
        ho, ylo, yhi = conv.same_pads(h, s)
        wo, xlo, xhi = conv.same_pads(h, s)
        need_dx = path_needs_dx(name)
        xl = (F.pad(x, (0, 0, xlo, xhi, ylo, yhi))
              .reshape(nf, n, h + ylo + yhi, h + xlo + xhi, cin)
              .permute(1, 0, 4, 2, 3).reshape(n, nf * cin, h + ylo + yhi,
                                              h + xlo + xhi)
              .contiguous(memory_format=torch.channels_last))
        wl = (wt.permute(0, 4, 3, 1, 2).reshape(nf * cout, cin, 3, 3)
              .contiguous(memory_format=torch.channels_last))
        bl = b.reshape(-1).contiguous()
        gm = conv.relu_mask(g, y, relu)
        gl = (gm.reshape(nf, n, ho, wo, cout).permute(1, 0, 4, 2, 3)
              .reshape(n, nf * cout, ho, wo)
              .contiguous(memory_format=torch.channels_last))
        m = nf * n * ho * wo
        f_bytes = 4 * (x.numel() + wt.numel() + b.numel() + m * cout)
        f_ops = 2 * 9 * cin * cout * m
        b_bytes = 4 * (x.numel() * (2 if need_dx else 1) + 2 * wt.numel()
                       + g.numel() * (2 if relu else 1) + nf * cout)
        b_ops = 2 * 9 * cin * cout * m * (2 if need_dx else 1) + m * cout
        f_bound, _ = bound(f_bytes, f_ops, FP32_FLOPS)
        b_bound, _ = bound(b_bytes, b_ops, FP32_FLOPS)
        per_call = conv.bwd_kernels_per_call((n, h, h, cin), cout, stride=s,
                                             need_dx=need_dx)

        def run_fwd():
            return conv.conv2d3x3_grouped(x, wt, b, stride=s, relu=relu)

        def run_bwd():
            return conv.conv2d3x3_bwd_grouped(g, y, x, wt, stride=s, relu=relu,
                                              need_dx=need_dx)

        def plain_bwd():
            dx = (conv.conv2d3x3_grouped_dgrad_plain(g, y, wt, x.shape,
                                                     stride=s, relu=relu)
                  if need_dx else None)
            return dx, conv.conv2d3x3_grouped_wgrad_plain(g, y, x, nf,
                                                          stride=s, relu=relu)
        row = {"case": f"{name}_F{nf}_N{n}", "x": [nf * n, h, h, cin],
               "cout": cout, "stride": s, "relu": relu, "need_dx": need_dx,
               "max_abs_err": {"y": err, **errs},
               "fields_equal_single_launches": True,
               "fwd": {"ms": device_ms(run_fwd, kernel="conv3x3_fwd_kernel",
                                       name=f"grouped {name}"),
                       "wall_ms": wall_ms(run_fwd),
                       "plain_ms": device_ms(lambda: conv.conv2d3x3_grouped_plain(
                           x, wt, b, stride=s, relu=relu), iters=5,
                           name=f"grouped plain {name}"),
                       "library_ms": device_ms(lambda: F.conv2d(
                           xl, wl, bl, stride=s, groups=nf),
                           name=f"cuDNN grouped {name}"),
                       "bound_ms": f_bound, "bytes": f_bytes, "ops": f_ops},
               "bwd": {"ms": device_ms(run_bwd, kernel="conv3x3_bwd",
                                       per_call=per_call,
                                       name=f"grouped bwd {name}"),
                       "kernels_per_call": per_call,
                       "wall_ms": wall_ms(run_bwd),
                       "plain_ms": device_ms(plain_bwd, iters=5,
                                             name=f"grouped bwd plain {name}"),
                       "library_ms": device_ms(
                           lambda: torch.ops.aten.convolution_backward(
                               gl, xl, wl, [nf * cout], [s, s], [0, 0], [1, 1],
                               False, [0, 0], nf, [need_dx, True, True]),
                           name=f"convolution_backward grouped {name}"),
                       "bound_ms": b_bound, "bytes": b_bytes, "ops": b_ops}}
        for k in keys:
            fwd[k] += row["fwd"][k]
            bwd[k] += row["bwd"][k]
        fwd["max_abs_err"] = max(fwd["max_abs_err"], err)
        bwd["max_abs_err"] = max(bwd["max_abs_err"], *errs.values())
        sums["fwd"][0] += f_bytes
        sums["fwd"][1] += f_ops
        sums["bwd"][0] += b_bytes
        sums["bwd"][1] += b_ops
        rows.append(row)
        print("conv2d3x3_grouped", json.dumps(row))
    report["conv2d3x3_grouped_cases"] = rows
    fwd["bound_by"] = bound(*sums["fwd"], FP32_FLOPS)[1]
    bwd["bound_by"] = bound(*sums["bwd"], FP32_FLOPS)[1]
    fwd["timed_at"] = (f"sum of the six grouped conv launches of one stacked "
                       f"training forward (F={nf}, N={n}, 512²)")
    bwd["timed_at"] = (f"sum of the six grouped backward calls of one stacked "
                       f"training step (F={nf}, N={n}, 512², conv_in without dx)")
    return {"conv2d3x3_grouped": fwd, "conv2d3x3_grouped_bwd": bwd}


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
                                  iters=5, name="fused_enhance_plain"),
            "bound_ms": b_ms, "bound_by": by, "library_ms": None,
            "timed_at": f"one float32 strict call over a {shape} field"}


def _bits_equal(a, b) -> bool:
    """Same dtype, shape and bytes, compared on the device."""
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    view = {torch.float64: torch.int64, torch.float32: torch.int32}.get(a.dtype)
    return bool(torch.equal(a.view(view), b.view(view)) if view else torch.equal(a, b))


def _probe_groups():
    """The reference's Lorenzo probe canaries (``szlike._lorenzo_jit_probe``
    and ``_probe_against_eager``: a NaN, a CODE_CAP overflow, 2**25 + 0.5
    under a float32 cast, odd sizes, per-field bounds) and a 2-D group of
    odd size with an infinity and a lattice half point."""
    import numpy as np
    rng = np.random.default_rng(12345)
    a = np.cumsum(rng.standard_normal((2, 5, 7, 3)), axis=1).astype(np.float32)
    a[0, 0, 0, 0] = np.nan
    a[0, 1, 2, 0] = 3.0e9
    a[1, 2, 3, 1] = np.float32(2 ** 25) + 0.5
    rng = np.random.default_rng(99)
    b = np.cumsum(rng.standard_normal((1, 6, 5, 4)), axis=1).astype(np.float32)
    b[0, 0, 0, 0] = 4.0e9
    rng = np.random.default_rng(3)
    c = rng.standard_normal((3, 11, 13)) * 5
    c[0, 1, 1], c[1, 4, 2], c[2, 3, 3] = np.inf, 1e12, 0.6 * 2.5
    return [("jit_probe", a, [1e-3, 2e-2]), ("eager_probe", b, [1e-3]),
            ("planar_odd", c, [1e-3, 5e-2, 0.3])]


def lorenzo_phase(dev, fields, report: dict) -> dict:
    """Both Lorenzo kernels against their plain versions, byte for byte, on
    the canaries and on the stacked float64 group of the snapshot's fields
    (each with its own rel 1e-3 bound, float32 cast check), then timed."""
    import numpy as np
    import torch
    from repro_torch.compressors.quantize import abs_bound_from_rel
    from repro_torch.kernels import lorenzo3d as lz

    def check(name, x, eb, out_dtype):
        got = lz.lorenzo3d_fwd(x, eb, out_dtype)
        want = lz.lorenzo_encode_plain(x, eb, out_dtype)
        if not all(_bits_equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"lorenzo3d_fwd differs from plain: {name}, "
                                 f"{out_dtype}")
        if not _bits_equal(lz.lorenzo3d_inv(got[0], eb),
                           lz.lorenzo_decode_plain(got[0], eb)):
            raise AssertionError(f"lorenzo3d_inv differs from plain: {name}")
        torch.cuda.synchronize()
        return got

    checks = []
    for name, a, ebs in _probe_groups():
        eb = torch.tensor(ebs, dtype=torch.float64, device=dev)
        for out_dtype in (torch.float32, torch.float64):
            got = check(name, torch.from_numpy(a.astype(np.float64)).to(dev),
                        eb, out_dtype)
            checks.append({"group": name, "shape": list(a.shape),
                           "out_dtype": str(out_dtype), "identical": True,
                           "escapes": int(got[1].sum())})

    ebs = [abs_bound_from_rel(v, 1e-3) * (1.0 - 1e-9) for v in fields.values()]
    eb = torch.tensor(ebs, dtype=torch.float64, device=dev)
    x = torch.from_numpy(np.stack([v.astype(np.float64)
                                   for v in fields.values()])).to(dev)
    delta, unpred, _ = check("snapshot", x, eb, torch.float32)
    checks.append({"group": "snapshot", "shape": list(x.shape),
                   "out_dtype": "torch.float32", "identical": True,
                   "escapes": int(unpred.sum())})
    # The inverse's scratch: its carry rows, far below a full-size copy of
    # delta (the output rec aside).
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    lz.lorenzo3d_inv(delta, eb)
    torch.cuda.synchronize()
    scratch = torch.cuda.max_memory_allocated() - base - 8 * delta.numel()
    if not scratch < delta.numel() * 4 // 2:
        raise AssertionError(f"lorenzo3d_inv took {scratch} bytes of scratch, "
                             f"not below half of delta's {delta.numel() * 4}")
    checks.append({"group": "snapshot", "inverse_scratch_bytes": scratch,
                   "delta_bytes": delta.numel() * 4})
    report["lorenzo3d_checks"] = checks
    n, nf = x.numel(), x.shape[0]
    where = f"one call over the stacked {list(x.shape)} float64 group"
    # Bytes: each input read once, each output written once.  Operations:
    # the float64 divide, round, multiply, subtract and compare and the
    # seven integer adds of the delta (forward); three adds and a multiply
    # (inverse), all counted at the float64 rate: both are byte-bound.
    fwd_bytes, inv_bytes = n * (8 + 4 + 1 + 8) + nf * 8, n * (4 + 8) + nf * 8
    fwd_bound, fwd_by = bound(fwd_bytes, 12 * n, FP64_FLOPS)
    inv_bound, inv_by = bound(inv_bytes, 4 * n, FP64_FLOPS)

    def fwd():
        return lz.lorenzo3d_fwd(x, eb, torch.float32)

    def inv():
        return lz.lorenzo3d_inv(delta, eb)
    inv_split: dict[str, float] = {}
    out = {
        "lorenzo3d_fwd": {
            "max_abs_err": 0.0, "ms": device_ms(fwd, kernel="lorenzo3d_fwd_kernel"),
            "wall_ms": wall_ms(fwd),
            "plain_ms": device_ms(lambda: lz.lorenzo_encode_plain(
                x, eb, torch.float32), iters=5, name="lorenzo_encode_plain"),
            "bound_ms": fwd_bound, "bound_by": fwd_by, "library_ms": None,
            "library": "none: no one PyTorch call computes it",
            "bytes": fwd_bytes, "timed_at": where},
        "lorenzo3d_inv": {
            "max_abs_err": 0.0,
            "ms": time_lorenzo_inv(lz, delta, eb, by_name=inv_split),
            "ms_by_kernel": inv_split,
            "wall_ms": wall_ms(inv),
            "plain_ms": device_ms(lambda: lz.lorenzo_decode_plain(delta, eb),
                                  iters=5, name="lorenzo_decode_plain"),
            "bound_ms": inv_bound, "bound_by": inv_by, "library_ms": None,
            "library": "none: the torch.cumsum chain is three calls and is "
                       "its plain version",
            "bytes": inv_bytes,
            "timed_at": where + " (two launches: the bands' carry rows, then "
                                "each band's walk over z)"},
    }
    for k, v in out.items():
        print(k, json.dumps(v))
    return out


def trace_steps(step, steps: int = 10, counters=()) -> dict:
    """Trace ``steps`` calls of ``step(i)`` with torch.profiler after three
    warm-up calls: wall time per step, device-busy time per step (the sum
    of the CUDA kernels' durations; one stream, so they do not overlap),
    kernels per step and the kernels that take the most time; then time
    ``steps`` more calls without the profiler (``step_ms_untraced``).
    ``counters`` are ``(name, module, attribute)`` launch counters read per
    traced step."""
    import torch

    for i in range(3):
        step(i)
    wall = []
    before = {name: getattr(mod, attr) for name, mod, attr in counters}

    def steps_run():
        t0 = time.perf_counter()
        for i in range(steps):
            step(i)
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
    kernels = device_events(traced(steps_run))
    if not kernels:
        raise AssertionError("the training-step trace held no device activity")
    per_step = {f"{name}_launches_per_step": (getattr(mod, attr) - before[name]) / steps
                for name, mod, attr in counters}
    steps_run()
    traced_wall, untraced_wall = wall
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_ms = sum(by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"steps": steps, "step_ms": traced_wall * 1e3 / steps,
            "step_ms_untraced": untraced_wall * 1e3 / steps,
            "device_busy_ms_per_step": busy_ms / steps,
            "device_busy_share": busy_ms / (traced_wall * 1e3),
            "kernels_per_step": len(kernels) / steps, **per_step,
            "top_kernels_ms_per_step": [[k[:90], v / 1e3 / steps] for k, v in top]}


def profile_train_steps(model, inputs, targets, steps: int = 10) -> dict:
    """:func:`trace_steps` of one field's training steps (batch 10,
    full-size slices)."""
    import torch
    from repro_torch.core import online_trainer
    from repro_torch.kernels import conv2d3x3 as conv
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
    return trace_steps(step, steps,
                       (("conv2d3x3_bwd", conv, "bwd_launches"),))


def stacked_step_ab(model, inputs, targets, steps: int = 10) -> dict:
    """A stacked training step of GROUP_F fields (``train_stacked``'s step:
    one stacked forward and backward through the grouped kernels, Adam on
    the stacked tensors) beside one round of GROUP_F serial steps (one
    field after another), traced in turns (serial, stacked, stacked,
    serial).  Every field starts from ``model``'s weights and takes its own
    slices of ``inputs``."""
    import torch
    from repro_torch.core import online_trainer, skipping_dnn
    from repro_torch.kernels import conv2d3x3 as conv
    from repro_torch.optim import AdamW

    dev = next(model.parameters()).device
    nf = GROUP_F
    xs, ys = (torch.as_tensor(a, device=dev) for a in (inputs, targets))
    n = xs.shape[0]
    tree = {k: {p: v.detach().clone() for p, v in d.items()}
            for k, d in model.tree().items()}
    cfg = model.cfg

    def rows(i, f):
        return torch.arange(10 * (i + f), 10 * (i + f) + 10, device=dev) % n

    models = [skipping_dnn.SkippingDNN(cfg, tree, device=dev) for _ in range(nf)]
    opts = [AdamW(list(m.parameters())) for m in models]

    def serial(i):
        for f, (m, opt) in enumerate(zip(models, opts)):
            idx = rows(i, f)
            loss = online_trainer.batch_loss(m, xs[idx], ys[idx])
            opt.step(torch.autograd.grad(loss, list(m.parameters())), lr=1e-3)

    stacked = skipping_dnn.stack_params([tree] * nf)
    leaves = [v.requires_grad_() for v in skipping_dnn.tree_leaves(stacked)]
    sopt = AdamW(leaves)

    def stacked_step(i):
        idx = torch.cat([rows(i, f) for f in range(nf)])
        xb = xs[idx].reshape(nf, 10, *xs.shape[1:])
        yb = ys[idx].reshape(nf, 10, *ys.shape[1:])
        loss = online_trainer.stacked_batch_loss(stacked, xb, yb,
                                                 regulated=cfg.regulated,
                                                 skip=cfg.skip)
        sopt.step(torch.autograd.grad(loss.sum(), leaves), lr=1e-3)

    counters = (("conv2d3x3", conv, "launches"),
                ("conv2d3x3_bwd", conv, "bwd_launches"),
                ("conv2d3x3_grouped", conv, "grouped_launches"),
                ("conv2d3x3_grouped_bwd", conv, "grouped_bwd_launches"))
    runs = []
    for side in ("serial", "stacked", "stacked", "serial"):
        runs.append({"side": side, **trace_steps(
            serial if side == "serial" else stacked_step, steps, counters)})
    want = {"serial": (6 * nf, 6 * nf, 0, 0), "stacked": (0, 0, 6, 6)}
    out = {"fields": nf, "order": [r["side"] for r in runs], "runs": runs}
    for side in ("serial", "stacked"):
        mine = [r for r in runs if r["side"] == side]
        for r in mine:
            seen = tuple(r[f"{c[0]}_launches_per_step"] for c in counters)
            if seen != want[side]:
                raise AssertionError(f"{side} step: conv launches per step "
                                     f"{seen}, want {want[side]}")
        out[side] = {k: sum(r[k] for r in mine) / len(mine)
                     for k in ("step_ms", "step_ms_untraced", "kernels_per_step",
                               "device_busy_ms_per_step", "device_busy_share")}
    return out


def plain_backward_conv3x3(wgrad=None):
    """The skipping DNN's conv with the kernel forward and the plain-PyTorch
    backward: the plain side of the training-step A/B.  Only this script
    (and ``scripts/backward_quality_ab.py``, which passes another
    ``wgrad``) builds it; nothing in ``repro_torch`` reaches the plain
    backward with CUDA tensors."""
    import torch
    from repro_torch.kernels import conv2d3x3 as conv
    wgrad = wgrad or conv.conv2d3x3_wgrad_plain

    class PlainBackward(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, w, b, stride, relu):
            y = conv.conv2d3x3(x, w, b, stride=stride, relu=relu)
            ctx.save_for_backward(x, w, y)
            ctx.stride, ctx.relu = stride, relu
            return y

        @staticmethod
        def backward(ctx, g):
            x, w, y = ctx.saved_tensors
            s, relu = ctx.stride, ctx.relu
            dx = (conv.conv2d3x3_dgrad_plain(g, y, w, x.shape, stride=s, relu=relu)
                  if ctx.needs_input_grad[0] else None)
            dw, db = wgrad(g, y, x, stride=s, relu=relu)
            return dx, dw, db, None, None

    def conv3x3(x, w, b, *, stride: int = 1, relu: bool = True):
        return PlainBackward.apply(x.contiguous(), w.contiguous(),
                                   b.contiguous(), stride, relu)
    return conv3x3


def train_step_ab(model, inputs, targets) -> dict:
    """Ten training steps traced with the plain conv backward and with the
    kernels, in turns (plain, kernel, kernel, plain), on one model."""
    from repro_torch.core import skipping_dnn

    kernel_conv, plain_conv = skipping_dnn.conv3x3, plain_backward_conv3x3()
    runs = []
    try:
        for side in ("plain", "kernel", "kernel", "plain"):
            skipping_dnn.conv3x3 = plain_conv if side == "plain" else kernel_conv
            runs.append({"backward": side,
                         **profile_train_steps(model, inputs, targets)})
    finally:
        skipping_dnn.conv3x3 = kernel_conv
    out = {"order": [r["backward"] for r in runs], "runs": runs}
    for side, bwd in (("plain", 0), ("kernel", len(LAYERS_512))):
        mine = [r for r in runs if r["backward"] == side]
        seen = [r["conv2d3x3_bwd_launches_per_step"] for r in mine]
        if any(v != bwd for v in seen):
            raise AssertionError(f"{side} backward: conv2d3x3_bwd launches per "
                                 f"step {seen}, want {bwd}")
        out[side] = {k: sum(r[k] for r in mine) / len(mine)
                     for k in ("step_ms", "step_ms_untraced", "kernels_per_step",
                               "device_busy_ms_per_step", "device_busy_share")}
    return out


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


def main_path(dev, fields, epochs: int, report: dict) -> tuple[dict, dict]:
    """The main path: ``(launches, kept)``, ``kept`` its entries (packed),
    its decode and its stage times, which the durable path is held against."""
    import numpy as np
    import torch
    import repro_torch
    from repro_torch import kernels
    from repro_torch.compressors import szlike
    from repro_torch.core import archive as arc_io
    from repro_torch.core import metrics, neurlz, online_trainer, regulation

    shape = next(iter(fields.values())).shape
    raw_mb = sum(x.nbytes for x in fields.values()) / 1e6
    path = ROOT / "build" / "chip_smoke" / "hurricane.nlz"
    path.parent.mkdir(parents=True, exist_ok=True)

    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
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
    device_peak = torch.cuda.max_memory_allocated()
    kept = {"entries": {n: arc_io.dumps(e) for n, e in opened["fields"].items()},
            "conv": {n: arc_io.dumps(e["conv"])
                     for n, e in opened["fields"].items()}, "epochs": epochs,
            "decoded": decoded, "compress_s": t_compress,
            "timing": arc["timing"], "path": path,
            "device_peak_bytes": device_peak}

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

    trace = train_step_ab(model, inputs, targets)
    trace["stacked"] = stacked_step_ab(model, inputs, targets)
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
           "device_peak_bytes": device_peak,
           "decode_equals_encoder": True, "train_step_trace": trace,
           "conv_stage_profile": conv_profile}
    print("main_path", json.dumps({k: v for k, v in out.items()
                                   if k != "per_field"}))
    report["main_path"] = out
    kept["per_field"] = per_field
    return launches, kept


def lorenzo_path(dev, fields, epochs: int, report: dict) -> dict:
    """``NeurLZ(compressor="szlike-lorenzo")`` on the snapshot: one batched
    conventional group of three fields, the strict bound and decode equal to
    the encoder's final field on every field."""
    import torch
    import repro_torch
    from repro_torch import kernels
    from repro_torch.compressors import szlike
    from repro_torch.core import metrics, neurlz, online_trainer, regulation

    raw_mb = sum(x.nbytes for x in fields.values()) / 1e6
    path = ROOT / "build" / "chip_smoke" / "hurricane_lorenzo.nlz"
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sess = repro_torch.NeurLZ(compressor="szlike-lorenzo", conv_batch=True,
                              epochs=epochs, device=dev)
    arc = sess.compress(fields, rel_eb=1e-3)
    torch.cuda.synchronize()
    t_compress = time.perf_counter() - t0
    nbytes = arc.save(path)
    t0 = time.perf_counter()
    opened = repro_torch.Archive.open(path, device=dev)
    decoded = opened.decode_all()
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    launches = kernels.launch_counts()
    device_peak = torch.cuda.max_memory_allocated()

    stage = arc["timing"]["conv_stage"]
    if (stage["groups"], stage["calls"], stage["batched_fields"]) != (1, 1, 3):
        raise AssertionError(f"Lorenzo conventional stage was not one fused "
                             f"group of 3 fields: {stage}")
    per_field = {}
    for name, x in fields.items():
        e = opened["fields"][name]
        eb = e["abs_eb"]
        chk = regulation.check_bound(x, decoded[name], eb, "strict")
        if not chk["ok"]:
            raise AssertionError(f"lorenzo {name}: max error "
                                 f"{chk['max_abs_err']} > {eb}")
        rec = szlike.decompress(e["conv"], device=dev)
        model = neurlz.decode_entry_net(e, dev)
        inputs, _, _ = online_trainer.make_dataset(rec, x, eb)
        resid = online_trainer.predict_residual(model, inputs)
        final, mask = neurlz.enhance_and_mask(x, rec, resid, eb, sess.config)
        if final.cpu().numpy().tobytes() != decoded[name].tobytes():
            raise AssertionError(f"lorenzo {name}: decode differs from the "
                                 "encoder's field")
        if int(mask.sum()) != e["outliers"]["count"]:
            raise AssertionError(f"lorenzo {name}: outlier mask differs")
        per_field[name] = {
            "abs_eb": eb, "max_err_over_eb": chk["max_abs_err"] / eb,
            "psnr_conv": metrics.psnr(x, rec),
            "psnr_enhanced": metrics.psnr(x, decoded[name]),
            "bitrate": opened.bitrate(name)["bitrate"],
            "conv_bitrate": opened.bitrate(name)["conv_bitrate"],
            "outlier_rate": e["outliers"]["count"] / x.size,
            "final_loss": e["loss_history"][-1]}
        print("lorenzo_field", name, json.dumps(per_field[name]))
    out = {"compressor": "szlike-lorenzo", "epochs": epochs, "rel_eb": 1e-3,
           "mode": "strict", "archive_bytes": nbytes,
           "compress_s": t_compress, "decode_s": t_decode,
           "compress_MB_per_s": raw_mb / t_compress,
           "decode_MB_per_s": raw_mb / t_decode, "stages": dict(arc["timing"]),
           "per_field": per_field, "launches": launches,
           "device_peak_bytes": device_peak, "decode_equals_encoder": True}
    print("lorenzo_path", json.dumps({k: v for k, v in out.items()
                                      if k != "per_field"}))
    report["lorenzo_path"] = out
    return launches


def durable_path(dev, fields, epochs: int, main: dict, report: dict
                 ) -> tuple[dict, dict]:
    """The main path's configuration with telemetry and faults, through a
    durable container: ``train.precip`` is injected (``precip`` degrades to
    conv-only), the first ``decode.entry`` read is injected and healed by a
    retry.  ``main`` is what :func:`main_path` kept.  Returns ``(launches,
    serial)``, ``serial`` the serial engine's entries of all three fields at
    these epochs (packed), which the batched path is held against."""
    import torch
    import repro_torch
    from repro_torch import kernels
    from repro_torch.compressors import szlike
    from repro_torch.core import archive as arc_io
    from repro_torch.core import metrics, regulation

    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / "hurricane_durable.nlzs"
    raw_mb = sum(x.nbytes for x in fields.values()) / 1e6
    tel = repro_torch.Telemetry(repro_torch.TelemetryConfig(sample_psnr=True))
    faults = repro_torch.FaultConfig(
        injector=repro_torch.FaultInjector({"train.precip": 0,
                                            "decode.entry": 0}),
        retry=repro_torch.RetryPolicy())

    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sess = repro_torch.NeurLZ(epochs=epochs, device=dev, telemetry=tel,
                              faults=faults)
    arc = sess.compress(fields, rel_eb=1e-3)
    torch.cuda.synchronize()
    t_compress = time.perf_counter() - t0

    # The entries, one record each, as a streaming writer appends them.
    t0 = time.perf_counter()
    meta = {"field_order": list(fields),
            "shapes": {n: list(x.shape) for n, x in fields.items()},
            "slice_axis": arc["slice_axis"], "compressor": arc["compressor"],
            "aux": {n: list(e["aux"]) for n, e in arc["fields"].items()}}
    app = arc_io.ArchiveAppender(path, durability="fsync", prelude=dict(meta))
    for name in fields:
        app.add_entry(name, arc["fields"][name])
    nbytes = app.finalize({**meta, "timing": arc["timing"]})
    t_write = time.perf_counter() - t0

    t0 = time.perf_counter()
    opened = repro_torch.Archive.open(path, device=dev)
    t_open = time.perf_counter() - t0
    reads_at_open = len(opened.reader.entry_reads)
    decoded = sess.decompress(opened)     # the session's telemetry and faults
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    launches = kernels.launch_counts()
    device_peak = torch.cuda.max_memory_allocated()

    def check(ok: bool, what: str) -> None:
        if not ok:
            raise AssertionError(f"durable path: {what}")

    check(reads_at_open == 0, f"{reads_at_open} entry reads at open")
    check(arc["timing"]["degraded_fields"] == ["precip"],
          f"degraded {arc['timing']['degraded_fields']}")

    # What the serial engine writes for the three fields at these epochs,
    # without telemetry or faults: each field's entry depends on that field
    # alone (its own bound, conventional payload and fresh generator).
    ref_sess = repro_torch.NeurLZ(epochs=epochs, device=dev)
    ref_arc = ref_sess.compress(fields, rel_eb=1e-3)
    ref_dec = ref_sess.decompress(ref_arc)
    reference = {n: (arc_io.dumps(ref_arc["fields"][n]), ref_dec[n])
                 for n in fields}
    serial = {"epochs": epochs,
              "entries": {n: reference[n][0] for n in fields},
              "per_field": {n: {"psnr_enhanced": metrics.psnr(x, ref_dec[n]),
                                "bitrate": ref_arc.bitrate(n)["bitrate"],
                                "final_loss": ref_arc["fields"][n][
                                    "loss_history"][-1]}
                            for n, x in fields.items()}}
    per_field = {}
    for name, x in fields.items():
        e = opened.entry(name)
        chk = regulation.check_bound(x, decoded[name], e["abs_eb"], "strict")
        check(chk["ok"], f"{name}: max error {chk['max_abs_err']} > "
                         f"{e['abs_eb']}")
        if name == "precip":
            check(e.get("degraded") == "injected", f"precip entry {e.get('degraded')}")
            conv_rec = szlike.decompress(e["conv"], device=dev)
            check(decoded[name].tobytes() == conv_rec.tobytes(),
                  "precip does not decode to its conventional reconstruction")
        else:
            check(arc_io.dumps(e) == reference[name][0],
                  f"{name}: entry differs from the serial engine's")
            check(decoded[name].tobytes() == reference[name][1].tobytes(),
                  f"{name}: decode differs from the serial engine's")
        per_field[name] = {"max_err_over_eb": chk["max_abs_err"] / e["abs_eb"],
                           "degraded": e.get("degraded"),
                           "bitrate": opened.bitrate(name)["bitrate"]}
    counters = tel.counters
    check(counters.get("faults.degraded") == 1
          and counters.get("faults.retries") == 1, f"counters {counters}")

    # Spans: the root's children cover it; one train span per field.
    root = [s for s in tel.spans if s.name == "compress"]
    check(len(root) == 1, f"{len(root)} compress spans")
    root = root[0]
    kids = [s for s in tel.spans if s.parent == root.id]
    cover = sum(s.dur for s in kids) / root.dur
    check(cover >= 0.9, f"the root's children cover {cover:.3f} of it")
    trained = [n for n in fields if n != "precip"]
    for name in trained:
        recs = tel.trace(name)
        check(len(recs) == epochs
              and sum("sample_psnr" in r for r in recs) == epochs,
              f"{name}: {len(recs)} learning-trace records")
    trace_path = out_dir / "durable_trace.json"
    tel.export_chrome_trace(str(trace_path))
    events = json.loads(trace_path.read_text())["traceEvents"]
    check([e["name"] for e in events].count("train") == len(fields),
          "the Chrome trace lacks a train event per field")

    # The container: verify it, then a copy with one flipped bit in w's
    # record, then a copy cut before its footer.
    t0 = time.perf_counter()
    clean = opened.verify()
    t_verify = time.perf_counter() - t0
    check(clean["ok"] and clean["sealed"], f"verify: {clean}")
    off, ln = opened.reader.entries["w"]
    data = bytearray(path.read_bytes())
    data[off + arc_io._V2_PREFIX + ln // 2] ^= 0x10
    flipped = out_dir / "durable_flipped.nlzs"
    flipped.write_bytes(bytes(data))
    with repro_torch.open(flipped, device=dev) as bad:
        rep = bad.verify()
    check(not rep["ok"] and not rep["entries"]["w"]["ok"]
          and rep["entries"]["w"]["offset"] == off
          and all(rep["entries"][n]["ok"] for n in fields if n != "w"),
          f"verify of a flipped bit in w at {off}: {rep}")
    footer = max(o + arc_io._V2_PREFIX + n
                 for o, n in opened.reader.entries.values())
    torn = out_dir / "durable_torn.nlzs"
    torn.write_bytes(path.read_bytes()[:footer])
    t0 = time.perf_counter()
    with repro_torch.Archive.open(torn, repair=True, device=dev) as salvaged:
        t_salvage_open = time.perf_counter() - t0
        check(salvaged.salvaged and salvaged.field_names == list(fields),
              f"salvage of the torn copy: {salvaged.field_names}")
        recovered = salvaged.decode_all()
    t_salvage = time.perf_counter() - t0
    for name in fields:
        check(recovered[name].tobytes() == decoded[name].tobytes(),
              f"{name}: the salvaged decode differs")
    opened.close()
    flipped.unlink()
    torn.unlink()

    timing = arc["timing"]
    per_trained = {"durable": timing["train_s"] / (len(trained) * epochs),
                   "main": main["timing"]["train_s"] / (len(fields)
                                                        * main["epochs"])}
    out = {"compressor": "szlike", "epochs": epochs, "rel_eb": 1e-3,
           "mode": "strict", "container_bytes": nbytes,
           "compress_s": t_compress, "decode_s": t_decode,
           "compress_MB_per_s": raw_mb / t_compress,
           "decode_MB_per_s": raw_mb / t_decode,
           "container_s": {"write_fsync": t_write, "open": t_open,
                           "verify": t_verify,
                           "salvage_open": t_salvage_open,
                           "salvage_open_and_decode": t_salvage},
           "stages": timing, "spans": tel.span_summary(),
           "root_covered": cover, "counters": counters,
           "telemetry_overhead": {
               "train_s_per_trained_field_epoch": per_trained,
               "train_ratio": per_trained["durable"] / per_trained["main"],
               "conv_s_ratio": timing["conv_s"] / main["timing"]["conv_s"],
               "compress_s": {"durable": t_compress,
                              "main": main["compress_s"]}},
           "sample_psnr_last": {n: tel.trace(n)[-1]["sample_psnr"]
                                for n in trained},
           "per_field": per_field, "launches": launches,
           "device_peak_bytes": device_peak,
           "verify_flipped": rep["entries"]["w"], "trace": str(trace_path)}
    print("durable_spans", json.dumps(out["spans"]))
    print("durable_path", json.dumps({k: v for k, v in out.items()
                                      if k not in ("per_field", "spans")}))
    report["durable_path"] = out
    return launches, serial


def batched_path(dev, fields, epochs: int, main: dict, serial: dict,
                 report: dict) -> dict:
    """``NeurLZ(engine="batched", field_batching="vmap", group_size=0)``:
    the snapshot's three fields as one group trained stacked through the
    grouped kernels, decoded with ``engine="batched"``.  ``main`` is what
    :func:`main_path` kept (its conventional payloads and archive);
    ``serial`` the serial engine's entries at ``epochs``, from
    :func:`durable_path`."""
    import hashlib
    import torch
    import repro_torch
    from repro_torch import kernels
    from repro_torch.compressors import szlike
    from repro_torch.core import archive as arc_io
    from repro_torch.core import batched_engine, metrics, neurlz
    from repro_torch.core import online_trainer, regulation

    if serial["epochs"] != epochs:
        raise ValueError(f"batched path at {epochs} epochs, its serial "
                         f"reference at {serial['epochs']}")
    raw_mb = sum(x.nbytes for x in fields.values()) / 1e6
    path = ROOT / "build" / "chip_smoke" / "hurricane_batched.nlz"
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sess = repro_torch.NeurLZ(engine="batched", field_batching="vmap",
                              group_size=0, epochs=epochs, device=dev)
    arc = sess.compress(fields, rel_eb=1e-3)
    torch.cuda.synchronize()
    t_compress = time.perf_counter() - t0
    nbytes = arc.save(path)
    t0 = time.perf_counter()
    opened = repro_torch.Archive.open(path, device=dev)
    decoded = sess.decompress(opened)        # engine="batched"
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    launches = kernels.launch_counts()
    device_peak = torch.cuda.max_memory_allocated()

    def check(ok: bool, what: str) -> None:
        if not ok:
            raise AssertionError(f"batched path: {what}")

    group = ",".join(fields)
    check(arc["timing"]["strategies"] == {group: "vmap"},
          f"strategies {arc['timing']['strategies']}")
    # The main path's archive through the batched decode: the serial
    # decode's bytes.
    t0 = time.perf_counter()
    main_batched = repro_torch.Archive.open(main["path"], device=dev).decode_all(
        engine="batched")
    t_main_decode = time.perf_counter() - t0
    for name in fields:
        check(main_batched[name].tobytes() == main["decoded"][name].tobytes(),
              f"{name}: the batched decode of the main path's archive differs "
              "from its serial decode")
    # The stacked step's byte parity at the group's signature.
    e0 = opened["fields"][next(iter(fields))]
    net_cfg = neurlz.NeurLZConfig().net_config(e0["net"]["c_in"])
    shape = next(iter(fields.values())).shape
    parity = batched_engine.stacked_bit_parity(
        net_cfg, shape[1:], min(10, shape[0]), len(fields), dev)
    print(f"batched path: stacked_bit_parity at slices {list(shape[1:])}, "
          f"batch {min(10, shape[0])}, {len(fields)} fields on "
          f"{torch.device(dev).type}: {parity}")

    per_field = {}
    for name, x in fields.items():
        e = opened["fields"][name]
        eb = e["abs_eb"]
        chk = regulation.check_bound(x, decoded[name], eb, "strict")
        check(chk["ok"], f"{name}: max error {chk['max_abs_err']} > {eb}")
        check(arc_io.dumps(e["conv"]) == main["conv"][name],
              f"{name}: conventional payload differs from the main path's")
        rec = szlike.decompress(e["conv"], device=dev)
        model = neurlz.decode_entry_net(e, dev)
        inputs, _, _ = online_trainer.make_dataset(rec, x, eb)
        resid = online_trainer.predict_residual(model, inputs)
        final, mask = neurlz.enhance_and_mask(x, rec, resid, eb, sess.config)
        check(final.cpu().numpy().tobytes() == decoded[name].tobytes(),
              f"{name}: decode differs from the encoder's field")
        check(int(mask.sum()) == e["outliers"]["count"],
              f"{name}: outlier mask differs from the archive's")
        sha = hashlib.sha256(arc_io.dumps(e)).hexdigest()
        serial_sha = hashlib.sha256(serial["entries"][name]).hexdigest()
        if parity:
            check(sha == serial_sha, f"{name}: stacked_bit_parity holds but "
                  "the entry differs from the serial engine's")
        ref = serial["per_field"][name]
        per_field[name] = {
            "abs_eb": eb, "max_err_over_eb": chk["max_abs_err"] / eb,
            "psnr_enhanced": metrics.psnr(x, decoded[name]),
            "psnr_serial": ref["psnr_enhanced"],
            "bitrate": opened.bitrate(name)["bitrate"],
            "bitrate_serial": ref["bitrate"],
            "outlier_rate": e["outliers"]["count"] / x.size,
            "final_loss": e["loss_history"][-1],
            "final_loss_serial": ref["final_loss"],
            "entry_sha256": sha, "entry_equals_serial": sha == serial_sha}
        print("batched_field", name, json.dumps(per_field[name]))
    out = {"engine": "batched", "field_batching": "vmap", "group_size": 0,
           "epochs": epochs, "rel_eb": 1e-3, "mode": "strict",
           "archive_bytes": nbytes, "compress_s": t_compress,
           "decode_s": t_decode, "main_archive_batched_decode_s": t_main_decode,
           "compress_MB_per_s": raw_mb / t_compress,
           "decode_MB_per_s": raw_mb / t_decode, "stages": dict(arc["timing"]),
           "stacked_bit_parity": parity,
           "main_compress_s": main["compress_s"], "per_field": per_field,
           "launches": launches, "device_peak_bytes": device_peak,
           "decode_equals_encoder": True}
    print("batched_path", json.dumps({k: v for k, v in out.items()
                                      if k != "per_field"}))
    report["batched_path"] = out
    return launches


STREAM_BUDGET = 900_000_000   # bytes: 2.25 of one field's working set
STREAM_ROI = (slice(10, 20), slice(None), slice(100, 300))


def streaming_path(dev, fields, epochs: int, main: dict, report: dict) -> dict:
    """``NeurLZ(group_size=1, max_resident_bytes=STREAM_BUDGET).compress_to``
    of the snapshot written as ``.npy`` files (an ``NpyDirSource``) into a
    container, decoded by ``iter_decompress`` and one ROI.  One field's
    working set on the residency ledger is x 100 MB + rec 100 MB + dataset
    200 MB: the three fields' 1.2 GB exceed the budget, so the pipeline
    must evict.  ``main`` is what :func:`main_path` kept: every entry must
    equal its entry by SHA-256, every decode its decode."""
    import hashlib
    import numpy as np
    import torch
    import repro_torch
    from repro_torch import kernels, streaming
    from repro_torch.core import archive as arc_io
    from repro_torch.core import regulation

    out_dir = ROOT / "build" / "chip_smoke"
    npy_dir = out_dir / "npys"
    npy_dir.mkdir(parents=True, exist_ok=True)
    for name, x in fields.items():
        np.save(npy_dir / f"{name}.npy", x)
    path = out_dir / "hurricane_streaming.nlzs"
    raw_mb = sum(x.nbytes for x in fields.values()) / 1e6
    tel = repro_torch.Telemetry(
        repro_torch.TelemetryConfig(learning_traces=False))

    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sess = repro_torch.NeurLZ(epochs=epochs, group_size=1,
                              max_resident_bytes=STREAM_BUDGET, device=dev,
                              telemetry=tel)
    src = streaming.NpyDirSource(str(npy_dir), names=list(fields))
    arc = sess.compress_to(src, path, rel_eb=1e-3)
    torch.cuda.synchronize()
    t_compress = time.perf_counter() - t0
    compress_peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    decoded = dict(streaming.iter_decompress(arc))
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    t0 = time.perf_counter()
    roi = arc.decode("w", roi=STREAM_ROI)
    torch.cuda.synchronize()
    t_roi = time.perf_counter() - t0
    launches = kernels.launch_counts()
    device_peak = torch.cuda.max_memory_allocated()

    def check(ok: bool, what: str) -> None:
        if not ok:
            raise AssertionError(f"streaming path: {what}")

    rep = arc.report
    check(rep["peak_resident_bytes"] <= STREAM_BUDGET,
          f"ledger peak {rep['peak_resident_bytes']} > {STREAM_BUDGET}")
    evictions = tel.counters.get("stream.evictions", 0)
    check(evictions > 0, "the ledger evicted nothing")
    per_field = {}
    for name, x in fields.items():
        e = arc.entry(name)
        sha = hashlib.sha256(arc_io.dumps(e)).hexdigest()
        main_sha = hashlib.sha256(main["entries"][name]).hexdigest()
        check(sha == main_sha, f"{name}: entry differs from the main path's")
        check(decoded[name].tobytes() == main["decoded"][name].tobytes(),
              f"{name}: decode differs from the main path's")
        chk = regulation.check_bound(x, decoded[name], e["abs_eb"], "strict")
        check(chk["ok"], f"{name}: max error {chk['max_abs_err']} > "
                         f"{e['abs_eb']}")
        per_field[name] = {"entry_sha256": sha,
                           "max_err_over_eb": chk["max_abs_err"] / e["abs_eb"]}
    check(roi.tobytes() == main["decoded"]["w"][STREAM_ROI].tobytes(),
          "the ROI decode differs from the main path's slice")
    arc.close()
    writer = {k: rep[k] for k in ("writer_busy_s", "writer_put_wait_s",
                                  "writer_close_wait_s", "bytes_written")}
    out = {"engine": "streaming", "group_size": 1, "epochs": epochs,
           "rel_eb": 1e-3, "mode": "strict", "budget_bytes": STREAM_BUDGET,
           "peak_resident_bytes": rep["peak_resident_bytes"],
           "evictions": evictions, **writer,
           "compress_s": t_compress, "decode_s": t_decode, "roi_s": t_roi,
           "compress_MB_per_s": raw_mb / t_compress,
           "decode_MB_per_s": raw_mb / t_decode,
           "main_compress_s": main["compress_s"],
           "stages": {k: rep[k] for k in ("total_s", "conv_s", "train_s",
                                          "conv_stage", "spans")},
           "device_peak_bytes_compress": compress_peak,
           "device_peak_bytes": device_peak,
           "main_device_peak_bytes": main["device_peak_bytes"],
           "per_field": per_field, "launches": launches,
           "entries_equal_main": True}
    print("streaming_path", json.dumps({k: v for k, v in out.items()
                                        if k != "per_field"}))
    report["streaming_path"] = out
    return launches


def zfplike_round_trip(dev, x, report: dict) -> None:
    """The ``zfplike`` conventional stage on one full field: the bound
    holds and decode equals the encoder's reconstruction."""
    import numpy as np
    from repro_torch import compressors
    from repro_torch.core import metrics

    t0 = time.perf_counter()
    arc, rec = compressors.compress(x, 1e-3, compressor="zfplike", device=dev)
    t_compress = time.perf_counter() - t0
    t0 = time.perf_counter()
    dec = compressors.decompress(arc, device=dev)
    t_decode = time.perf_counter() - t0
    if dec.tobytes() != rec.tobytes():
        raise AssertionError("zfplike: decode differs from the encoder's rec")
    err = float(np.abs(dec.astype(np.float64) - x).max())
    if not err <= arc["abs_eb"]:
        raise AssertionError(f"zfplike: max error {err} > {arc['abs_eb']}")
    out = {"shape": list(x.shape), "abs_eb": arc["abs_eb"],
           "max_err_over_eb": err / arc["abs_eb"], "psnr": metrics.psnr(x, dec),
           "bitrate": compressors.archive_nbytes(arc) * 8 / x.size,
           "compress_s": t_compress, "decode_s": t_decode}
    print("zfplike_round_trip", json.dumps(out))
    report["zfplike_round_trip"] = out


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

    from repro_torch.data import fields as fields_lib
    t = time.perf_counter()
    fields = fields_lib.make_fields("hurricane", shape, seed=0)
    print(f"data: hurricane {shape} x {list(fields)} float32, "
          f"{time.perf_counter() - t:.1f} s to generate")

    summaries = {"conv2d3x3": conv_phase(dev, report),
                 "conv2d3x3_bwd": conv_bwd_phase(dev, report),
                 **grouped_phase(dev, report),
                 "fused_enhance": enhance_phase(dev, shape, report),
                 **lorenzo_phase(dev, fields, report)}
    if args.epochs < 100:
        print(f"every path: epochs cut to {args.epochs} of the paper's 100 "
              "(the shape is never cut)")
    # Each path runs with the counts set to 0 just before it; every kernel
    # of a path must have launched in it.
    main_launches, main_kept = main_path(dev, fields, args.epochs, report)
    cut = min(args.epochs, DURABLE_EPOCHS)
    lorenzo_launches = lorenzo_path(dev, fields,
                                    min(args.epochs, LORENZO_EPOCHS), report)
    durable_launches, serial_cut = durable_path(dev, fields, cut, main_kept,
                                                report)
    by_path = {"main": main_launches,
               "lorenzo": lorenzo_launches,
               "durable": durable_launches,
               "batched": batched_path(dev, fields, cut, main_kept,
                                       serial_cut, report),
               "streaming": streaming_path(dev, fields, args.epochs,
                                           main_kept, report)}
    single = ("conv2d3x3", "conv2d3x3_bwd", "fused_enhance")
    path_kernels = {"main": single,
                    "lorenzo": single + ("lorenzo3d_fwd", "lorenzo3d_inv"),
                    "durable": single,
                    "batched": ("conv2d3x3", "conv2d3x3_grouped",
                                "conv2d3x3_grouped_bwd", "fused_enhance"),
                    "streaming": single}
    for p, names in path_kernels.items():
        if not all(by_path[p][k] > 0 for k in names):
            raise AssertionError(f"a kernel never ran on the {p} path: {by_path[p]}")
    report["device_peak_bytes"] = {
        p: report[f"{p}_path"]["device_peak_bytes"] for p in by_path}
    print("device_peak_bytes", json.dumps(report["device_peak_bytes"]))
    zfplike_round_trip(dev, fields["w"], report)

    # The backward replaces no TPU kernel of its own: it is the gradient of
    # conv2d3x3's function, which the JAX package takes by XLA's autodiff of
    # skipping_dnn._conv_taps (src/repro/core/skipping_dnn.py:128).
    meta = {"conv2d3x3": ("src/repro_torch/csrc/conv2d3x3.cu",
                          "src/repro/kernels/conv2d3x3.py:73"),
            "conv2d3x3_bwd": ("src/repro_torch/csrc/conv2d3x3_bwd.cu",
                              "src/repro/kernels/conv2d3x3.py:73"),
            # conv2d3x3 under jax.vmap over fields, the JAX package's
            # stacked training (src/repro/core/batched_engine.py:193).
            "conv2d3x3_grouped": ("src/repro_torch/csrc/conv2d3x3.cu",
                                  "src/repro/kernels/conv2d3x3.py:73"),
            "conv2d3x3_grouped_bwd": ("src/repro_torch/csrc/conv2d3x3_bwd.cu",
                                      "src/repro/kernels/conv2d3x3.py:73"),
            "fused_enhance": ("src/repro_torch/csrc/fused_enhance.cu",
                              "src/repro/kernels/fused_enhance.py:59"),
            "lorenzo3d_fwd": ("src/repro_torch/csrc/lorenzo3d.cu",
                              "src/repro/kernels/lorenzo3d.py:81"),
            "lorenzo3d_inv": ("src/repro_torch/csrc/lorenzo3d.cu",
                              "src/repro/kernels/lorenzo3d.py:106")}
    line = {"kernels": [
        {"name": n, "route": "cuda", "source": meta[n][0], "replaces": meta[n][1],
         "launches": sum(c[n] for c in by_path.values()),
         "launches_by_path": {p: c[n] for p, c in by_path.items()},
         "max_abs_err": s["max_abs_err"], "ms": s["ms"],
         "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
         "bound_by": s["bound_by"], "library_ms": s["library_ms"]}
        for n, s in summaries.items()]}
    report["kernels"] = line["kernels"]
    report["retraced"] = RETRACED
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
