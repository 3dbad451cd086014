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
   inverse allocating no full-size scratch; the inverse on rows wider than
   its band holds (WIDE_INV_SHAPES, the striped route) byte for byte;
4. the main path at the paper's Hurricane-ISABEL size (three fields of
   100×500×500 float32, synthetic, from a seed): ``NeurLZ(device="cuda")
   .compress`` at rel_eb 1e-3 in strict mode, at DURABLE_EPOCHS epochs
   (cut from the paper's 100 to keep the run inside its time limit; its
   archive is the serial reference of the paths after it), ``save``,
   ``Archive.open``, ``decode_all``; the 1× bound is checked on every
   field, and for one field the engine's encoder helpers are run again from
   the archived weights and the decode must equal the encoder's final field
   bit for bit; then
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
   serial engine's at those epochs (the main path's archive: the three
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
   entry must equal the main path's archive (same epochs) by
   SHA-256, else each field's PSNR and bit rate are printed beside it;
8. the streaming path on the same snapshot: the fields written as ``.npy``
   files into ``build/chip_smoke/npys/``, ``NeurLZ(group_size=1,
   max_resident_bytes=STREAM_BUDGET).compress_to`` of that directory into
   a container (the three fields' working sets exceed the budget) at
   DURABLE_EPOCHS epochs, decoded by ``streaming.iter_decompress`` and one
   ROI of ``w``; every entry must equal the main path's archive (the
   serial engine's at those epochs) by SHA-256, every
   decode its decode, the ROI its slice, the ledger's peak stay within the
   budget and the ledger evict;
   it prints the compress and decode times, the writer thread's busy and
   put-wait seconds and the ledger's peak;
9. the serve path: one ``ArchiveServer`` on the card over the streaming
   path's container and the Lorenzo path's archive under a 250 MB ledger
   (two decoded fields); a cold burst of eight requests from eight client
   threads must be two stacked conventional decodes (an interp walk and one
   ``lorenzo3d_inv`` launch) of six archives, each result its path's decode
   bit for bit; a hot hit that reads no entry, a ROI, an injected
   ``serve.request`` fault that fails one request only, the ledger within
   its ceiling after each phase and evicting; then ``transcode`` of ``w``
   to ``rel=1e-2`` at SERVE_EPOCHS epochs under its own ledger, its entry
   equal by SHA-256 to ``NeurLZ.compress`` of the served ``w``, the new
   bound held;
10. the lm path, the LM substrate's serving (``repro_torch.launch.serve``;
    no kernel of the port, eager PyTorch): ``serve`` of the reduced
    gemma-2b and qwen3-4b on the card; qwen3-4b at full width (36 layers,
    d_model 2560, vocab 151,936) in float32, every position's teacher-
    forced decode logits within LM_TOL of the forward's; qwen3-4b in its
    bfloat16 and granite-moe-3b-a800m (40 experts, top 8) at full width,
    each prefilled with a 32-token prompt at batch 4 and decoding 32
    greedy tokens, the decode step timed against its bound (the weights
    read once); the recurrent zamba2-7b (68 Mamba2 layers and one shared
    attention block) and xlstm-350m at full width and depth in bfloat16,
    served the same way, their bounds adding the recurrent state read and
    written once; one full-width float32 MoE layer of granite on the card
    and the CPU, its routing (experts, slots, kept tokens) equal and its
    output within MOE_TOL;
11. the train path, the LM substrate's training: (a) qwen3-4b at full
    width in its bfloat16 (4.02 B parameters), TRAIN_STEPS steps of
    ``make_train_step`` (full remat, ``warmup_cosine(3e-3, 1, 8)``) on the
    ``TokenStream`` at batch 8 x 128 under a ``StepWatchdog``: every loss
    and gradient norm finite, the last loss below the first; the step's
    wall time, its device time and kernels from a trace of
    TRAIN_TRACE_STEPS more steps, against its bound; the same for
    xlstm-350m and zamba2-7b at full width and depth; (b) steps of the
    reduced qwen3-4b, granite-moe, zamba2-7b and xlstm-350m on card and
    CPU (loss, gradients, update gated on the first step, the recurrent
    two in float64; later steps recorded) and ``microbatch=2`` against one
    step; (c) the restart drills of ``launch.train.train`` on the card: a
    failure at step 3 resumed by ``run_with_restarts`` equal byte for byte
    to an uninterrupted run, the same with NeurLZ-compressed weights for
    qwen3-4b and xlstm-350m, and lossy checkpoints through the Lorenzo
    kernels (bound held, card restore equal to the CPU's, one launch per
    lossy leaf) and ``neurlz_grad_archive`` equal on both;
12. the dist path, the distributed layer over NCCL at world size 1 (NCCL
    takes one rank a device; the multi-rank checks run on the CPU over
    gloo): (a) the sharding rules of qwen3-4b, zamba2-7b and
    deepseek-moe-16b at full width on the 16x16 and 2x16x16 production
    shapes and the 1x1 host mesh (sharded and replicated leaves, param and
    AdamW bytes a device); (b) ``reshard_to_mesh`` of qwen3-4b's
    full-width bf16 params on the 1x1 mesh, bit for bit; (c)
    ``compressed_psum`` and ``bf16_psum`` of one full-width gradient tree,
    bit for bit against ``quantize_ef`` / ``bf16(g)``, timed against their
    bytes-once bounds, with their wire bytes; (d) an elastic drill at the
    reduced qwen3-4b: save, ``rescale`` onto a fresh 1x1 mesh, state and
    the next train step bit for bit;
13. the dryrun path, the port's dry run (``repro_torch.launch.dryrun``):
    (a) ``python -m repro_torch.launch.dryrun`` for qwen3-4b's train_4k,
    prefill_32k and decode_32k, the ``neurlz_enhance`` cell,
    granite-moe-3b-a800m's train_4k (expert-parallel), xlstm-350m's
    decode_32k and zamba2-7b's long_500k (its KV cache split over its
    sequence) on the 16x16 and 2x16x16 meshes (fake worlds of 256 and 512
    ranks, meta tensors, no card), one process a cell, started right after
    the build at the lowest CPU priority and waited for here; each must be
    ``ok``, and prints its peak bytes a device, compute, memory and
    collective ms and dominant term; (b) one real train step of qwen3-4b,
    then one of granite-moe-3b-a800m, at the train path's size on the card
    under ``launch.op_cost``'s counter: its
    product FLOPs within DRYRUN_FLOPS_TOL of ``train_step_flops`` less the
    recompute torch's checkpoint skips (``recompute_skipped_flops``), its
    counted peak within DRYRUN_PEAK_TOL of ``max_memory_allocated``, its
    roofline bound beside the step's time and the train path's bound, and
    the same step lowered on a fake 1x1 world equal in FLOPs and bytes,
    with no collective; (c) the real per-device ``neurlz_enhance`` step
    (2 blocks of 512² x 10 slices, c_in=2) on the card: both grouped conv
    kernels launch, and its counted FLOPs and bytes equal the fake 16x16
    record's less its loss all-reduce;
14. the paper path, the paper's workload through its ported driver
    (``examples/compress_field_torch.py``'s ``run``: batched engine,
    cross-field learning, strict) on the ``miranda-cf-smoke`` set of
    ``scripts/paper_sets.py`` (Miranda, 32×384×384 float64, three fields,
    the record's 5 epochs whatever ``--epochs`` says), each field's initial
    weights and batch order carried across from the JAX package's record;
    gated on (a) the strict bound, (b) the conventional payloads,
    ``abs_eb`` and header equal to the record's exactly and ``stats``
    within ``paper_sets.STATS_TOL``, (c) enhanced PSNR and (d) bit rate
    within the kernel member's tolerance that its ``.card.json`` recorded
    (``scripts/paper_quality.py``: from the other two members) of the
    record's, and within 0.05 dB and 2% of the recorded kernel member,
    and (e) the first epoch's loss within 1e-3 of the record's;
15. a ``zfplike`` conventional round trip on one full field;
16. the launch count of every kernel over each path, counted from 0 just
    before the path: each kernel of a path must have launched in it (the
    lm and dist paths launch none, the train path the Lorenzo kernels, the
    paper and dryrun paths the grouped conv kernels);
    and each path's ``torch.cuda.max_memory_allocated``, reset before it.

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
import os
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


def traced(fn, cpu: bool = True):
    """Run ``fn()`` inside a torch.profiler trace whose window reaches
    TRACE_PAD_S past the device work on both sides; returns the profiler.
    ``cpu=False`` records the device's activity alone (a trace of tens of
    thousands of launches is then several times quicker to read)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=acts) as prof:
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
# Training cut from the paper's 100 epochs on every path, so that the run
# stays inside its time limit on a slower host (the durable, batched and
# streaming paths at DURABLE_EPOCHS, held against the main path's archive,
# the serial engine's at the same epochs; 10 until the recurrent families'
# lm and train rows came; the streaming path at 100 until the dist phase
# came, when one run took 1,181 s of the 1,200; the main path at 100 until
# the dryrun phase came, when one run took 1,136 s, then at 50, with the
# durable path compressing its own serial reference, until the dry run's
# other families came, when one run took 1,014 s).
LORENZO_EPOCHS = 5
DURABLE_EPOCHS = 5


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
    view = {torch.float64: torch.int64, torch.float32: torch.int32,
            torch.bfloat16: torch.int16, torch.float16: torch.int16}.get(a.dtype)
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


# Rows wider than lorenzo3d_inv's band holds (56,320 int32 values): a
# lossy checkpoint's untied head ([4096, 151,936] in qwen3-8b), a flattened
# float32 expert stack, and a 3-D group.
WIDE_INV_SHAPES = [(1, 4096, 151936), (1, 32, 1048576), (2, 3, 5, 100000)]


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
    # Rows wider than a band's shared memory take the striped route (five
    # launches a call), byte for byte against the plain version; the
    # first shape timed.
    gen = torch.Generator(device=dev).manual_seed(7)
    wide = []
    for shape in WIDE_INV_SHAPES:
        d = torch.randint(-2 ** 30, 2 ** 30, shape, dtype=torch.int32,
                          device=dev, generator=gen)
        e = torch.rand((shape[0],), dtype=torch.float64, device=dev,
                       generator=gen) * 0.5 + 1e-3
        if not _bits_equal(lz.lorenzo3d_inv(d, e), lz.lorenzo_decode_plain(d, e)):
            raise AssertionError(f"lorenzo3d_inv differs from plain at {shape}")
        case = {"shape": list(shape), "identical": True}
        if not wide:
            case["ms"] = device_ms(lambda: lz.lorenzo3d_inv(d, e),
                                   kernel="lorenzo3d_inv", per_call=5,
                                   name="lorenzo3d_inv striped")
            case["bound_ms"], _ = bound(d.numel() * 12 + 8 * shape[0],
                                        4 * d.numel(), FP64_FLOPS)
        wide.append(case)
        del d
        torch.cuda.empty_cache()
    print("lorenzo3d_inv wide rows", json.dumps(wide))
    checks.append({"group": "wide rows (striped route)", "cases": wide})
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
    """Trace ``steps`` calls of ``step(i)`` with torch.profiler (device
    activity only) after three
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
    kernels = device_events(traced(steps_run, cpu=False))
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


def lorenzo_path(dev, fields, epochs: int, report: dict) -> tuple[dict, dict]:
    """``NeurLZ(compressor="szlike-lorenzo")`` on the snapshot: one batched
    conventional group of three fields, the strict bound and decode equal to
    the encoder's final field on every field.  Returns ``(launches, kept)``,
    ``kept`` its archive dict and its decode, which the serve path serves."""
    import torch
    import repro_torch
    from repro_torch import kernels
    from repro_torch.compressors import szlike
    from repro_torch.core import metrics, neurlz, online_trainer, regulation

    raw_mb = sum(x.nbytes for x in fields.values()) / 1e6
    path = ROOT / "build" / "chip_smoke" / "hurricane_lorenzo.nlz"
    path.parent.mkdir(parents=True, exist_ok=True)
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
    return launches, {"archive": opened.to_dict(), "decoded": decoded}


def durable_path(dev, fields, epochs: int, main: dict, report: dict) -> dict:
    """The main path's configuration with telemetry and faults, through a
    durable container: ``train.precip`` is injected (``precip`` degrades to
    conv-only), the first ``decode.entry`` read is injected and healed by a
    retry.  ``main`` is what :func:`main_path` kept at the same epochs, the
    serial engine's entries, which this path's are held against.  Returns
    the launches."""
    import torch
    import repro_torch
    from repro_torch import kernels
    from repro_torch.compressors import szlike
    from repro_torch.core import archive as arc_io
    from repro_torch.core import regulation

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
    # without telemetry or faults, is the main path's archive: each field's
    # entry depends on that field alone (its own bound, conventional
    # payload and fresh generator).
    check(main["epochs"] == epochs, f"the main path trained {main['epochs']} "
          f"epochs, this path {epochs}")
    reference = {n: (main["entries"][n], main["decoded"][n]) for n in fields}
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
    return launches


def batched_path(dev, fields, epochs: int, main: dict, serial: dict,
                 report: dict) -> dict:
    """``NeurLZ(engine="batched", field_batching="vmap", group_size=0)``:
    the snapshot's three fields as one group trained stacked through the
    grouped kernels, decoded with ``engine="batched"``.  ``main`` is what
    :func:`main_path` kept (its conventional payloads and archive);
    ``serial`` the serial engine's entries at ``epochs`` (the main path's
    archive)."""
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


def streaming_path(dev, fields, epochs: int, serial: dict, report: dict
                   ) -> tuple[dict, Path]:
    """``NeurLZ(group_size=1, max_resident_bytes=STREAM_BUDGET).compress_to``
    of the snapshot written as ``.npy`` files (an ``NpyDirSource``) into a
    container, decoded by ``iter_decompress`` and one ROI.  One field's
    working set on the residency ledger is x 100 MB + rec 100 MB + dataset
    200 MB: the three fields' 1.2 GB exceed the budget, so the pipeline
    must evict.  ``serial`` is the serial engine's archive at ``epochs``
    (:func:`durable_path`'s reference, the main path's configuration):
    every entry must equal its entry by SHA-256, every decode its decode.
    Returns ``(launches, path)``, ``path`` the container, which the serve
    path serves."""
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
        serial_sha = hashlib.sha256(serial["entries"][name]).hexdigest()
        check(sha == serial_sha, f"{name}: entry differs from the serial engine's")
        check(decoded[name].tobytes() == serial["decoded"][name].tobytes(),
              f"{name}: decode differs from the serial engine's")
        chk = regulation.check_bound(x, decoded[name], e["abs_eb"], "strict")
        check(chk["ok"], f"{name}: max error {chk['max_abs_err']} > "
                         f"{e['abs_eb']}")
        per_field[name] = {"entry_sha256": sha,
                           "max_err_over_eb": chk["max_abs_err"] / e["abs_eb"]}
    check(roi.tobytes() == serial["decoded"]["w"][STREAM_ROI].tobytes(),
          "the ROI decode differs from the serial engine's slice")
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
           "serial_compress_s": serial["compress_s"],
           "stages": {k: rep[k] for k in ("total_s", "conv_s", "train_s",
                                          "conv_stage", "spans")},
           "device_peak_bytes_compress": compress_peak,
           "device_peak_bytes": device_peak,
           "per_field": per_field, "launches": launches,
           "entries_equal_serial": True}
    print("streaming_path", json.dumps({k: v for k, v in out.items()
                                        if k != "per_field"}))
    report["streaming_path"] = out
    return launches, path


SERVE_MAX_BYTES = 250_000_000   # holds two of the 100 MB decoded fields
SERVE_EPOCHS = 5                # the transcode's training, as the durable path


def serve_path(dev, epochs: int, serial: dict, lorenzo: dict,
               container: Path, report: dict) -> dict:
    """The serving tier: one ``ArchiveServer`` on the card over the
    streaming path's container (``interp``) and the Lorenzo path's archive
    dict (``lorenzo``), under a 250 MB ledger.  A cold burst of eight
    requests from eight client threads (all six fields, ``w`` of each twice)
    must be two stacked conventional decodes (one interp walk, one
    ``lorenzo3d_inv`` launch) of six archives, every result equal to its
    path's decode bit for bit; then a hot hit that reads no entry, a ROI,
    an injected fault that fails one request only, the ledger within its
    ceiling after every phase and evicting.  Then ``transcode`` of the
    served ``w`` entry to ``rel=1e-2`` under its own ledger: its entry must
    equal, by SHA-256, ``NeurLZ.compress`` of the served ``w`` at the same
    bound and epochs, and hold the new bound.  Counts are read after the
    transcode, before that reference compress."""
    import hashlib
    import threading
    import torch
    import repro_torch
    from repro_torch import kernels
    from repro_torch.core import archive as arc_io
    from repro_torch.core import neurlz, regulation
    from repro_torch.streaming import ResidencyLedger

    def check(ok: bool, what: str) -> None:
        if not ok:
            raise AssertionError(f"serve path: {what}")

    want = {("interp", n): serial["decoded"][n] for n in serial["decoded"]}
    want.update({("lorenzo", n): a for n, a in lorenzo["decoded"].items()})
    tel = repro_torch.Telemetry(
        repro_torch.TelemetryConfig(learning_traces=False))
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    srv = repro_torch.ArchiveServer(
        {"interp": str(container), "lorenzo": lorenzo["archive"]},
        max_bytes=SERVE_MAX_BYTES, auto_start=False, telemetry=tel,
        device=dev)
    ledger = srv.ledger

    def ledger_ok(phase: str) -> None:
        check(ledger.current <= SERVE_MAX_BYTES,
              f"{phase}: ledger {ledger.current} > {SERVE_MAX_BYTES}")

    # Cold burst: eight clients queue, then the dispatcher starts.
    burst = list(want) + [("interp", "w"), ("lorenzo", "w")]
    futs: list = [None] * len(burst)
    barrier = threading.Barrier(len(burst))

    def client(i, aid, name):
        barrier.wait()
        futs[i] = srv.submit(name, archive_id=aid)
    clients = [threading.Thread(target=client, args=(i, *k))
               for i, k in enumerate(burst)]
    for t in clients:
        t.start()
    for t in clients:
        t.join()
    t0 = time.perf_counter()
    srv.start()
    got = [f.result(600) for f in futs]
    t_cold = time.perf_counter() - t0
    for k, g in zip(burst, got):
        check(g.tobytes() == want[k].tobytes(),
              f"{k}: served field differs from its path's decode")
    stats = srv.decode_stats.as_dict()
    check((stats["batched"], stats["single"], stats["max_width"],
           stats["archives"]) == (2, 0, 3, 6),
          f"the cold burst was not two stacked decodes of 6: {stats}")
    ledger_ok("cold burst")

    # Hot: a field the cache holds reads no entry.
    hot = next((k[1] for k in srv.cache.keys
                if k[0] == "interp" and k[2] is None), None)
    if hot is None:          # the burst's last puts were Lorenzo fields
        hot = "w"
        srv.decode(hot, archive_id="interp")
    hits, reads = (tel.counters.get(k, 0)
                   for k in ("serve.cache.hits", "archive.entry_reads"))
    t0 = time.perf_counter()
    out = srv.decode(hot, archive_id="interp")
    t_hot = time.perf_counter() - t0
    check(out.tobytes() == want[("interp", hot)].tobytes(), "hot hit differs")
    check(tel.counters.get("serve.cache.hits", 0) == hits + 1,
          "the hot request was no cache hit")
    check(tel.counters.get("archive.entry_reads", 0) == reads,
          "the hot request read an entry")
    ledger_ok("hot")

    t0 = time.perf_counter()
    roi = srv.decode("w", archive_id="interp", roi=STREAM_ROI)
    torch.cuda.synchronize()
    t_roi = time.perf_counter() - t0
    check(roi.tobytes() == serial["decoded"]["w"][STREAM_ROI].tobytes(),
          "the ROI differs from the serial engine's slice")
    ledger_ok("roi")

    # Fault: an uncached field's request fails, the next one is served.
    cold = next(n for n in serial["decoded"]
                if ("interp", n, None) not in srv.cache)
    srv.faults = repro_torch.FaultConfig(
        injector=repro_torch.FaultInjector({"serve.request": 0}))
    doomed = srv.submit(cold, archive_id="interp")
    try:
        doomed.result(600)
        check(False, "the injected fault failed no request")
    except repro_torch.InjectedFault:
        pass
    t0 = time.perf_counter()
    out = srv.decode(cold, archive_id="interp")
    t_after_fault = time.perf_counter() - t0
    check(out.tobytes() == want[("interp", cold)].tobytes(),
          "the request after the fault differs")
    ledger_ok("fault")
    counters = tel.counters_prefixed("serve.")
    check(counters.get("serve.cache.evictions", 0) > 0,
          "the cache evicted nothing")
    check(counters.get("serve.request_errors", 0) == 1,
          f"request errors {counters.get('serve.request_errors')} != 1")
    srv.close(close_archives=True)
    check(ledger.current == 0, "the closed server left bytes charged")

    # Transcode w from an archive dict of its entry.
    w_entry = arc_io.loads(serial["entries"]["w"])
    src = {"kind": "neurlz", "fields": {"w": w_entry}, "slice_axis": 0,
           "compressor": "szlike"}
    bounds = {"w": repro_torch.ErrorBound(rel=1e-2)}
    t_ledger = ResidencyLedger(STREAM_BUDGET)
    dst = ROOT / "build" / "chip_smoke" / "hurricane_w_transcoded.nlzs"
    dst.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    recoded = repro_torch.transcode(
        src, str(dst), bounds, ledger=t_ledger, device=dev,
        config=neurlz.NeurLZConfig(epochs=epochs, engine="streaming"))
    torch.cuda.synchronize()
    t_transcode = time.perf_counter() - t0
    launches = kernels.launch_counts()
    device_peak = torch.cuda.max_memory_allocated()
    check(recoded.report["peak_resident_bytes"] <= STREAM_BUDGET,
          f"transcode ledger peak {recoded.report['peak_resident_bytes']}")
    check(t_ledger.current == 0, "the transcode left bytes charged")
    served_w = want[("interp", "w")]
    new_w = recoded.decode("w")
    e = recoded.entry("w")
    chk = regulation.check_bound(served_w, new_w, e["abs_eb"], "strict")
    check(chk["ok"], f"transcoded w: max error {chk['max_abs_err']} > "
                     f"{e['abs_eb']}")
    t0 = time.perf_counter()
    recompressed = repro_torch.NeurLZ(epochs=epochs, device=dev).compress(
        {"w": served_w}, bounds)
    torch.cuda.synchronize()
    t_serial = time.perf_counter() - t0
    sha = hashlib.sha256(arc_io.dumps(e)).hexdigest()
    check(sha == hashlib.sha256(arc_io.dumps(recompressed["fields"]["w"])).hexdigest(),
          "the transcoded entry differs from the serial recompress")
    recoded.close()

    out = {"max_bytes": SERVE_MAX_BYTES, "requests": len(burst),
           "cold_burst_s": t_cold, "hot_hit_s": t_hot, "roi_s": t_roi,
           "after_fault_s": t_after_fault, "decode_stats": stats,
           "counters": counters, "ledger_peak_bytes": ledger.peak,
           "transcode": {"epochs": epochs, "rel": 1e-2, "seconds": t_transcode,
                         "serial_compress_s": t_serial,
                         "abs_eb": e["abs_eb"],
                         "max_err_over_eb": chk["max_abs_err"] / e["abs_eb"],
                         "ledger_peak_bytes": recoded.report["peak_resident_bytes"],
                         "entry_sha256": sha},
           "main_decode_s": report["main_path"]["decode_s"],
           "device_peak_bytes": device_peak, "launches": launches,
           "served_equal_decode": True, "transcode_equals_serial": True}
    print("serve_path", json.dumps(out))
    report["serve_path"] = out
    return launches


PAPER_SET = "miranda-cf-smoke"   # scripts/paper_sets.py: Miranda, depth cut


def paper_path(dev, report: dict) -> dict:
    """The paper's workload through its ported driver on ``PAPER_SET``:
    ``compress_field_torch.run`` (batched engine, cross-field, strict) from
    the JAX package's draws, gated on (a) the bound, (b) the conventional
    stage equal to the record's (``paper_sets.exact_check``), (c) PSNR and
    (d) bit rate within the kernel member's tolerance recorded in the set's
    ``.card.json`` (taken from the other two members there) of the
    reference's, and within the floors of the recorded kernel member, and
    (e) the first epoch's loss within ``LOSS_RTOL`` of the reference's."""
    import torch
    sys.path[:0] = [str(ROOT / "examples"), str(ROOT / "scripts")]
    import compress_field_torch as cft
    import paper_sets
    from repro_torch import kernels
    from repro_torch.core import archive as arc_io

    def check(ok: bool, what: str) -> None:
        if not ok:
            raise AssertionError(f"paper path: {what}")

    rec = paper_sets.load_record(PAPER_SET)
    card = paper_sets.load_card(PAPER_SET)
    check(card is not None, f"no {PAPER_SET}.card.json: run "
          f"scripts/paper_quality.py --set {PAPER_SET} first")
    init, sched = paper_sets.load_draws(PAPER_SET)
    flds = paper_sets.snapshot(rec["dataset"], rec["shape"], rec["seed"])
    check(paper_sets.field_digests(flds) == rec["field_sha256"],
          "the snapshot differs from the record's")
    raw_mb = sum(x.nbytes for x in flds.values()) / 1e6
    args = cft.build_parser().parse_args([
        "--dataset", rec["dataset"],
        "--shape", ",".join(str(s) for s in rec["shape"]),
        "--eb", repr(rec["rel_eb"]), "--epochs", str(rec["epochs"]),
        "--mode", rec["mode"], "--engine", "batched", "--device", str(dev),
        "--out", str(ROOT / "build" / "chip_smoke" / f"{PAPER_SET}.nlz")])
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)

    codec = os.environ.get("REPRO_CODEC")
    os.environ["REPRO_CODEC"] = rec["codec"]
    try:
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        res = cft.run(args, fields=flds, init_params=init,
                      batch_schedules=sched, log=lambda s: print("  " + s))
        launches = kernels.launch_counts()
        device_peak = torch.cuda.max_memory_allocated()
    finally:
        if codec is None:
            os.environ.pop("REPRO_CODEC")
        else:
            os.environ["REPRO_CODEC"] = codec
    del res["decoded"]

    entries = res["entries"]
    port = paper_sets.port_exact(entries, rec, arc_io.dumps)
    exact = {n: paper_sets.exact_check(port[n], want)
             for n, want in rec["fields"].items()}
    check(all(e["ok"] for e in exact.values()),
          f"conventional stage differs from the record: {exact}")
    mine = {n: {**f, "loss_first": float(entries[n]["loss_history"][0])}
            for n, f in res["fields"].items()}
    checks = {}
    for n, want in rec["fields"].items():
        f, was = mine[n], card["runs"]["kernel"][n]
        check(f["max_err_over_eb"] <= 1.0, f"{n}: bound broken")
        tol = card["tolerance"][n]["kernel"]
        c = {"reference": paper_sets.within(
                 want["psnr_enhanced"], want["bitrate"], f["psnr_enhanced"],
                 f["bitrate"], tol["psnr_db"], tol["bitrate_rel"]),
             "card_kernel": paper_sets.within(
                 was["psnr_enhanced"], was["bitrate"], f["psnr_enhanced"],
                 f["bitrate"], paper_sets.PSNR_FLOOR_DB,
                 paper_sets.BITRATE_FLOOR_REL),
             "e": paper_sets.loss_check(want["loss_history"][0], f["loss_first"])}
        checks[n] = c
        check(c["reference"]["ok"], f"{n}: PSNR or bit rate outside the "
              f"recorded tolerance of the reference's: {c['reference']}")
        check(c["card_kernel"]["ok"], f"{n}: PSNR or bit rate off the recorded "
              f"kernel run by more than the floors: {c['card_kernel']}")
        check(c["e"]["ok"], f"{n}: first loss {c['e']}")
    out = {"set": PAPER_SET, "shape": list(rec["shape"]),
           "epochs": rec["epochs"], "engine": "batched",
           "compress_s": res["compress_s"], "decode_s": res["decode_s"],
           "compress_MB_per_s": raw_mb / res["compress_s"],
           "decode_MB_per_s": raw_mb / res["decode_s"],
           "stages": res["timing"], "archive_bytes": res["archive_bytes"],
           "per_field": mine, "exact": exact, "checks": checks,
           "card_kernel_run": card["runs"]["kernel"],
           "launches": launches, "device_peak_bytes": device_peak}
    print("paper_path", json.dumps({k: v for k, v in out.items()
                                    if k not in ("per_field", "stages", "exact",
                                                 "card_kernel_run")}))
    report["paper_path"] = out
    return launches


LM_BATCH, LM_PROMPT, LM_GEN = 4, 32, 32   # the candidate cell qwen3-4b-serve
LM_RECURRENT = (("zamba2_bf16", "zamba2-7b"), ("xlstm_bf16", "xlstm-350m"))
LM_TOL = 2e-2        # decode vs forward, float32: rtol = atol, as the JAX
#   package's tests/test_models_smoke.py holds its teacher-forced decode
MOE_TOL = 1e-4       # MoE layer card vs CPU, float32 with TF32 off:
#   |Δ| <= MOE_TOL * max|CPU| + 1e-5 (sums of <= 1536 terms in another order)


def _lm_free() -> None:
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def recurrent_state_bytes(cache) -> int:
    """Bytes of a decode cache's recurrent states (Mamba2 state and conv
    window, mLSTM and sLSTM cells): every leaf but the attention KV
    caches' ``k`` and ``v``."""
    total = 0
    for k, v in cache.items():
        if isinstance(v, dict):
            total += recurrent_state_bytes(v)
        elif k not in ("k", "v"):
            total += v.numel() * v.element_size()
    return total


def _lm_serve_full(dev, cfg, seed: int, check) -> dict:
    """``prefill_into_cache`` of a LM_PROMPT-token prompt at batch LM_BATCH
    on the full-width model ``cfg`` (its own dtype), then LM_GEN greedy
    tokens; the decode step timed against its bound (the parameter bytes
    read once, and the recurrent states read and written once, at
    HBM_BYTES_PER_S) and its device time from a trace of four steps; the
    prefill's last logits beside the forward's (no limit)."""
    import torch
    from repro_torch.data.tokens import TokenStream
    from repro_torch.launch import serve
    from repro_torch.models import model as M

    torch.cuda.reset_peak_memory_stats()
    model = M.build_model(cfg, model_axis=1)
    t0 = time.perf_counter()
    params = M.init_params(model, seed=seed, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()     # serving's own peak from here
    leaves = list(model.parameters())
    n_params = sum(p.numel() for p in leaves)
    param_bytes = sum(p.numel() * p.element_size() for p in leaves)
    prompts = torch.from_numpy(TokenStream(cfg.vocab_size, LM_BATCH, LM_PROMPT,
                                           seed=0).next_batch()).to(dev)
    max_len = LM_PROMPT + LM_GEN
    with torch.inference_mode():
        t0 = time.perf_counter()
        logits, cache, pos = serve.prefill_into_cache(model, params, prompts,
                                                      max_len)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        toks, last = serve.greedy_decode(model, params, cache, logits, pos, LM_GEN)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        finite = bool(torch.isfinite(logits).all() and torch.isfinite(last).all())
        toks = toks.cpu().numpy()
        hidden = model.forward(params, {"tokens": prompts})
        fwd_last = model._logits(params, hidden[:, -1:]).float()
        gap = float((fwd_last - logits).abs().max())

        # Device time of decode steps (cache slots past the run's end).
        def steps():
            for i in range(4):
                model.decode_step(params, cache, prompts[:, i:i + 1],
                                  max_len - 4 + i)
        events = device_events(traced(steps, cpu=False))
    steps_n = LM_GEN - 1
    ms = decode_s / steps_n * 1e3
    state_bytes = recurrent_state_bytes(cache)
    bound_ms = (param_bytes + 2 * state_bytes) / HBM_BYTES_PER_S * 1e3
    width = logits.shape[-1]
    out = {"arch": cfg.name, "dtype": cfg.dtype, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "vocab": cfg.vocab_size, "n_params": n_params,
           "param_bytes": param_bytes, "recurrent_state_bytes": state_bytes,
           "batch": LM_BATCH, "prompt_len": LM_PROMPT,
           "generated": int(toks.shape[1]), "init_s": init_s,
           "prefill_s": prefill_s, "prefill_ms_per_step": prefill_s / LM_PROMPT * 1e3,
           "decode_s": decode_s, "decode_ms_per_step": ms,
           "decode_tok_per_s": LM_BATCH * steps_n / decode_s,
           "step_bound_ms": bound_ms, "x_bound": ms / bound_ms,
           "bound_tok_per_s": LM_BATCH / bound_ms * 1e3,
           "device_ms_per_step": sum(e.time_range.elapsed_us() for e in events)
           / 1e3 / 4,
           "device_kernels_per_step": len(events) / 4,
           "decode_vs_forward_max_abs": gap, "logits_finite": finite,
           "tokens_in_padding": int((toks >= cfg.vocab_size).sum()),
           "sample_tokens": toks[0, :10].tolist(),
           "init_max_memory_allocated": init_peak,
           "max_memory_allocated": max(init_peak, torch.cuda.max_memory_allocated()),
           "serve_max_memory_allocated": torch.cuda.max_memory_allocated()}
    check(finite, f"{cfg.name}: logits not finite")
    check(out["generated"] == LM_GEN, f"{cfg.name}: {out['generated']} tokens")
    # Rows past vocab_size are the padding to a multiple of 16, drawn like
    # the others as in the JAX package, so a greedy token may land there.
    check(bool(((toks >= 0) & (toks < width)).all()),
          f"{cfg.name}: a token outside the logits' {width} entries")
    del model, params, cache, logits, last, hidden
    _lm_free()
    return out


def lm_path(dev, report: dict) -> dict:
    """The LM substrate's serving path.  (a) ``launch.serve.serve`` on the
    card for gemma-2b and qwen3-4b at the reduced preset; (b) qwen3-4b at
    full width in float32 (36 layers, d_model 2560, vocab 151,936; TF32
    off): every position's teacher-forced decode logits against the
    forward's, within LM_TOL; (c) qwen3-4b at full width in its own
    bfloat16 and (d) granite-moe-3b-a800m at full width (``model_axis=1``,
    as serve builds it), and (e) the recurrent zamba2-7b and xlstm-350m at
    full width and depth, each served as ``_lm_serve_full``; and one MoE
    layer of granite at full width in float32 on the card and the CPU over
    a [4, 32, 1536] input: kept tokens, experts and slots equal, output
    within MOE_TOL.  The path launches none of the port's kernels."""
    import dataclasses
    from types import SimpleNamespace
    import torch
    from repro_torch import configs, kernels
    from repro_torch.data.tokens import TokenStream
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch.models.layers import rmsnorm

    def check(ok: bool, what: str) -> None:
        if not ok:
            raise AssertionError(f"lm path: {what}")

    t_path = time.perf_counter()
    kernels.reset_launch_counts()
    out: dict = {"serve_reduced": {}}
    for arch in ("gemma-2b", "qwen3-4b"):
        args = SimpleNamespace(arch=arch, batch=2, prompt_len=16, gen=8, seed=0,
                               device=str(dev))
        rep = serve.serve(args)
        check(rep["generated"] == args.gen, f"{arch} reduced: {rep}")
        out["serve_reduced"][arch] = rep
    _lm_free()

    # (b) float32 at full width: decode equals the forward.
    cfg = dataclasses.replace(configs.get_config("qwen3-4b"), dtype="float32")
    torch.cuda.reset_peak_memory_stats()
    model = M.build_model(cfg, model_axis=1)
    params = M.init_params(model, seed=0, device=dev)
    prompts = torch.from_numpy(TokenStream(cfg.vocab_size, LM_BATCH, LM_PROMPT,
                                           seed=0).next_batch()).to(dev)
    t0 = time.perf_counter()
    with torch.inference_mode():
        # As the JAX package's test: ln_f once more on the forward's output
        # (which ends in ln_f), then the head.
        hidden = model.forward(params, {"tokens": prompts})
        full = model._logits(params, rmsnorm(hidden, params["ln_f"],
                                             cfg.norm_eps)).float()
        cache = model.init_cache(LM_BATCH, LM_PROMPT)
        excess, worst = -float("inf"), 0.0
        for pos in range(LM_PROMPT):
            logits, cache = model.decode_step(params, cache,
                                              prompts[:, pos:pos + 1], pos)
            d = (logits[:, 0] - full[:, pos]).abs()
            excess = max(excess, float(
                (d - (LM_TOL + LM_TOL * full[:, pos].abs())).max()))
            worst = max(worst, float(d.max()))
    f32 = {"arch": cfg.name, "dtype": "float32",
           "n_params": sum(p.numel() for p in model.parameters()),
           "positions": LM_PROMPT, "batch": LM_BATCH,
           "decode_vs_forward_max_abs": worst, "rtol": LM_TOL, "atol": LM_TOL,
           "max_logit_abs": float(full.abs().max()),
           "seconds": time.perf_counter() - t0,
           "max_memory_allocated": torch.cuda.max_memory_allocated()}
    check(excess <= 0.0, f"qwen3-4b float32: decode differs from the forward "
                         f"by {worst} (> {LM_TOL} + {LM_TOL}·|logit|)")
    out["qwen3_4b_f32"] = f32
    del model, params, cache, full, hidden, logits
    _lm_free()

    out["qwen3_4b_bf16"] = _lm_serve_full(dev, configs.get_config("qwen3-4b"),
                                          0, check)
    gcfg = configs.get_config("granite-moe-3b-a800m")
    out["granite_bf16"] = _lm_serve_full(dev, gcfg, 0, check)
    for key, arch in LM_RECURRENT:
        out[key] = _lm_serve_full(dev, configs.get_config(arch), 0, check)

    # One MoE layer at full width, float32, on the card and on the CPU.
    g32 = dataclasses.replace(gcfg, dtype="float32")
    gen = torch.Generator().manual_seed(1)
    p_cpu = moe.init(gen, g32, torch.float32, "cpu", model_axis=1)
    x_cpu = torch.randn((LM_BATCH, LM_PROMPT, g32.d_model), generator=gen)
    p_dev = {k: v.to(dev) for k, v in p_cpu.items()}
    with torch.inference_mode():
        xt = x_cpu.reshape(LM_BATCH, LM_PROMPT, -1)   # groups of S = 32
        r_cpu = moe.route(p_cpu, g32, xt)
        r_dev = moe.route(p_dev, g32, xt.to(dev))
        y_cpu, aux_cpu = moe.forward(p_cpu, g32, x_cpu, model_axis=1)
        y_dev, aux_dev = moe.forward(p_dev, g32, x_cpu.to(dev), model_axis=1)
    same = {n: bool(torch.equal(a, b.cpu())) for n, a, b in
            zip(("topi", "pos", "keep"), r_cpu[2:], r_dev[2:])}
    err = float((y_dev.cpu() - y_cpu).abs().max())
    lim = MOE_TOL * float(y_cpu.abs().max()) + 1e-5
    keep = r_cpu[4]
    out["moe_layer_f32"] = {
        "shape": list(x_cpu.shape), "experts": g32.n_experts, "top_k": g32.top_k,
        "capacity": moe.capacity(g32, LM_PROMPT),
        "kept": int(keep.sum()), "choices": keep.numel(), "equal": same,
        "max_abs_err": err, "limit": lim,
        "aux_abs_err": float((aux_dev.cpu() - aux_cpu).abs())}
    check(all(same.values()), f"MoE routing differs on the card: {same}")
    check(err <= lim, f"MoE layer output: card vs CPU {err} > {lim}")
    del p_dev, y_dev
    _lm_free()

    launches = kernels.launch_counts()
    out["launches"] = launches
    served = ("qwen3_4b_bf16", "granite_bf16") + tuple(k for k, _ in LM_RECURRENT)
    out["device_peak_bytes"] = max(out[k]["max_memory_allocated"] for k in
                                   ("qwen3_4b_f32",) + served)
    out["seconds"] = time.perf_counter() - t_path
    for k in served:
        r = out[k]
        print(f"lm {k}: {r['n_params']:,} params, prefill {r['prefill_s']:.3f} s, "
              f"decode {r['decode_ms_per_step']:.3f} ms/step "
              f"({r['decode_tok_per_s']:.1f} tok/s; bound {r['step_bound_ms']:.3f} "
              f"ms, x{r['x_bound']:.2f}; device {r['device_ms_per_step']:.3f} "
              f"ms/step), max_memory_allocated {r['max_memory_allocated']:,} "
              f"(serving {r['serve_max_memory_allocated']:,})")
    print("lm_path", json.dumps(out))
    report["lm_path"] = out
    return launches


TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 128, 8   # the reference driver's
#   default batch and sequence; 8 steps, as train() would run them
# Steps traced after the 8, device activity only: at least about two
# seconds of steps (short traces lose activity), fewer where a step holds
# tens of thousands of launches.
TRAIN_TRACE_STEPS = {"qwen3-4b": 4, "zamba2-7b": 2, "xlstm-350m": 1}
BF16_FLOPS = 989e12       # H100 SXM, bf16 dense on the tensor cores
F32_FLOPS = 67e12         # H100 SXM, float32 outside the tensor cores (TF32 off)
# At full width and depth: zamba2-7b's weights, gradients and float32
# moments take 12 B a parameter (68.8 GB of 5.74 B) before temporaries, and
# its step peaks at 75.5 GB of the card's 80.
TRAIN_ARCHS = ("qwen3-4b", "xlstm-350m", "zamba2-7b")
PARITY_ARCHS = ("qwen3-4b", "granite-moe-3b-a800m", "zamba2-7b", "xlstm-350m")
PARITY_STEPS = 3          # the update gate on the first; later ones recorded
TRAIN_LOSS_TOL = 1e-5     # card vs CPU, float32 with TF32 off: relative
TRAIN_GRAD_TOL = 1e-4     # |Δ| <= TRAIN_GRAD_TOL * max|CPU leaf|
TRAIN_LOSSY_EB = 1e-5     # the lossy drill's weight bound (relative)


def train_step_flops(cfg, batch: int, seq: int) -> tuple[float, float]:
    """``(bf16, float32)`` operations of the products of one step under
    full remat: the layers' forward twice (the run and its recomputation),
    the head's forward twice (each loss chunk recomputed), and the
    backward's two products per forward product: 4 forwards.

    A forward counts 2 operations per matmul parameter per token (bf16,
    on the tensor cores), the head over the S - 1 predicted positions, and
    the sequence-mixing products, which the port computes in float32 (TF32
    off, so on the CUDA cores): attention's [S, S] scores per layer (the
    port computes the full square; the probabilities are cast to the
    model's dtype for their product with V, which counts as bf16);
    Mamba2's C·B scores and their product with x over the full square of
    each 128-position chunk, and the state's read C·S and write B⊗x;
    mLSTM's q·k scores and their product with v over the full square of a
    chunk, and q·S and the S update; sLSTM's recurrent product per step.
    A MoE layer counts attention, the router (float32, over the model's
    ``n_experts``: the card's model is built with ``model_axis=1``, so no
    expert is padded), every capacity slot of every expert through
    its FFN (each group's ``cap`` slots an expert, filled or not: the
    port's batched products run them all) and the shared experts; its
    dense first layers count as dense layers of ``d_ff_dense``, and its
    head multiplies the padded vocabulary.
    Elementwise work (gates, the depthwise conv, norms, the normalisers'
    vector products) is not counted."""
    tokens = batch * seq
    d = cfg.d_model
    vocab = cfg.vocab_size

    def attn_mlp(d_ff):
        hd, h, kv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
        scores = 2 * batch * h * seq * seq * hd
        return (2 * tokens * (d * h * hd + 2 * d * kv * hd + h * hd * d
                              + 3 * d * d_ff) + scores, scores)

    if cfg.family == "hybrid":
        di = cfg.ssm_expand * d
        n, pdim = cfg.ssm_state, cfg.ssm_headdim
        h = di // pdim
        cl = min(128, seq)
        mamba = (2 * tokens * (d * (2 * di + 2 * n + h) + di * d),
                 2 * tokens * cl * (n + h * pdim) + 4 * tokens * n * h * pdim)
        units = cfg.n_layers // cfg.hybrid_attn_every
        blocks = [(cfg.n_layers - units, mamba), (units, attn_mlp(cfg.d_ff))]
    elif cfg.family == "ssm":
        du, h = 2 * d, cfg.n_heads
        hk = du // h
        cl = min(128, seq)
        mlstm = (2 * tokens * (d * 2 * du + 3 * du * du + du * 2 * h + du * d),
                 4 * tokens * cl * du + 4 * tokens * du * hk)
        dff = int(cfg.xlstm_proj_factor * d)
        slstm = (2 * tokens * (4 * d * d + 3 * d * dff), 8 * tokens * d * (d // h))
        units = cfg.n_layers // cfg.xlstm_slstm_every
        blocks = [(cfg.n_layers - units, mlstm), (units, slstm)]
    elif cfg.family == "moe":
        from repro_torch.models import moe
        from repro_torch.models.transformer import pad_vocab

        n_exp = cfg.n_experts
        g_sz = min(cfg.moe_group_size, seq)
        slots = tokens // g_sz * n_exp * moe.capacity(cfg, g_sz)
        f = cfg.d_ff_expert
        attn_b, attn_f = attn_mlp(0)
        layer = (attn_b + 2 * slots * 3 * d * f
                 + 2 * tokens * 3 * d * cfg.n_shared_experts * f,
                 attn_f + 2 * tokens * d * n_exp)
        nd = cfg.first_dense_layers
        blocks = [(cfg.n_layers - nd, layer), (nd, attn_mlp(cfg.d_ff_dense))]
        vocab = pad_vocab(cfg.vocab_size)
    else:
        blocks = [(cfg.n_layers, attn_mlp(cfg.d_ff))]
    bf16 = sum(n * b for n, (b, _) in blocks) + 2 * batch * (seq - 1) * d * vocab
    f32 = sum(n * f for n, (_, f) in blocks)
    return 4.0 * bf16, 4.0 * f32


def recompute_skipped_flops(cfg, batch: int, seq: int) -> float:
    """Operations of train_step_flops's second forward that a step does
    not run: torch's non-reentrant checkpoint stops recomputing a layer
    after the last tensor its backward needs, so a dense layer's last
    product, the MLP's down projection (2 · tokens · d_model · d_ff), is
    not run again.  A MoE layer's last saved tensors are its aux loss's,
    after every product, so it recomputes them all; only the MoE family's
    dense first layers skip their down projection.  Dense and MoE
    families only."""
    if cfg.family == "dense":
        return 2.0 * batch * seq * cfg.d_model * cfg.d_ff * cfg.n_layers
    if cfg.family == "moe":
        return (2.0 * batch * seq * cfg.d_model * cfg.d_ff_dense
                * cfg.first_dense_layers)
    raise ValueError(f"no recompute reckoning for the {cfg.family} family")


def train_bound(cfg, model) -> dict:
    """The least time of one TRAIN_BATCH x TRAIN_SEQ step under full remat:
    train_step_flops's products (for the dense family less those the
    recomputation skips, recompute_skipped_flops) at the card's peak for
    their type, plus the optimizer's least traffic: the gradient read
    twice (the clip's norm, the update), both float32 moments and the
    parameter read and written."""
    bf16, f32 = train_step_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    skipped = (recompute_skipped_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
               if cfg.family in ("dense", "moe") else 0.0)
    bf16 -= skipped
    adam_bytes = sum(p.numel() * (4 * p.element_size() + 16)
                     for p in model.parameters())
    parts = {"matmul": bf16 / BF16_FLOPS * 1e3, "f32": f32 / F32_FLOPS * 1e3,
             "optimizer": adam_bytes / HBM_BYTES_PER_S * 1e3}
    return {"bf16_flops": bf16, "f32_flops": f32, "recompute_skipped": skipped,
            "optimizer_bytes": adam_bytes, "parts_ms": parts,
            "bound_ms": sum(parts.values())}


def _train_full_width(dev, check, arch: str) -> dict:
    """(a) ``arch`` at full width and depth in its bfloat16: TRAIN_STEPS
    steps of
    ``make_train_step(remat_policy="nothing", lr_fn=warmup_cosine(3e-3, 1,
    8))`` on the ``TokenStream`` at TRAIN_BATCH x TRAIN_SEQ under a
    ``StepWatchdog``, as ``launch.train.train``'s loop runs them (no
    checkpoint: the final save would move 40 GB through the host codec);
    then TRAIN_TRACE_STEPS[arch] more steps traced."""
    import math
    import statistics

    import torch
    from repro_torch import configs
    from repro_torch.checkpoint import StepWatchdog
    from repro_torch.data.tokens import TokenStream
    from repro_torch.models import model as M
    from repro_torch.optim import warmup_cosine

    cfg = configs.get_config(arch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = M.build_model(cfg, model_axis=1)
    params, opt = M.init_train_state(model, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    param_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    step_fn = M.make_train_step(model, remat_policy="nothing",
                                lr_fn=warmup_cosine(3e-3, 1, TRAIN_STEPS))
    stream = TokenStream(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    watchdog = StepWatchdog(120.0)
    losses, norms, lrs, walls = [], [], [], []

    def run(step):
        nonlocal params, opt
        batch = {"tokens": torch.from_numpy(stream.next_batch()).to(dev)}
        params, opt, met = step_fn(params, opt, batch, step)
        return met

    for step in range(TRAIN_STEPS):
        t = time.perf_counter()
        with watchdog.step(step):
            met = run(step)
            losses.append(float(met["loss"]))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        norms.append(float(met["grad_norm"]))
        lrs.append(float(met["lr"]))
        print(f"train {arch} full width: step {step} loss {losses[-1]:.4f} "
              f"grad norm {norms[-1]:.4f} lr {lrs[-1]:.3e} "
              f"{walls[-1] * 1e3:.1f} ms", flush=True)
    peak = torch.cuda.max_memory_allocated()

    n_traced = TRAIN_TRACE_STEPS[arch]

    def traced_steps():
        for i in range(n_traced):
            run(TRAIN_STEPS + i)
    t_trace = time.perf_counter()
    events = device_events(traced(traced_steps, cpu=False))
    t_trace = time.perf_counter() - t_trace
    check(bool(events), "the train step's trace held no device activity")
    busy = sum(e.time_range.elapsed_us() for e in events) / 1e3 / n_traced
    by_name: dict[str, float] = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]

    step_ms = statistics.median(walls[1:]) * 1e3
    tokens = TRAIN_BATCH * TRAIN_SEQ
    tb = train_bound(cfg, model)
    bound_ms = tb["bound_ms"]
    out = {"arch": cfg.name, "dtype": cfg.dtype, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "vocab": cfg.vocab_size, "n_params": n_params,
           "param_bytes": param_bytes, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "steps": TRAIN_STEPS, "init_s": init_s, "losses": losses,
           "grad_norms": norms, "lrs": lrs, "step_wall_ms": [w * 1e3 for w in walls],
           "step_ms_median_2_8": step_ms, "tokens_per_s": tokens / step_ms * 1e3,
           "flops_per_step": tb["bf16_flops"], "f32_flops_per_step": tb["f32_flops"],
           "recompute_skipped_flops": tb["recompute_skipped"],
           "optimizer_bytes_per_step": tb["optimizer_bytes"],
           "bound_ms": bound_ms, "bound_matmul_ms": tb["parts_ms"]["matmul"],
           "bound_f32_ms": tb["parts_ms"]["f32"],
           "bound_optimizer_ms": tb["parts_ms"]["optimizer"],
           "x_bound": step_ms / bound_ms,
           "device_ms_per_step": busy,
           "device_kernels_per_step": len(events) / n_traced,
           "traced_steps": n_traced, "trace_s": t_trace,
           "device_busy_share": busy / step_ms,
           "top_kernels_ms_per_step": [[k[:90], v / 1e3 / n_traced]
                                       for k, v in top],
           "watchdog": watchdog.stats(), "max_memory_allocated": peak}
    check(all(math.isfinite(v) for v in losses), f"a loss is not finite: {losses}")
    check(all(math.isfinite(v) for v in norms),
          f"a gradient is not finite (global norms {norms})")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    del model, params, opt, step_fn
    _lm_free()
    return out


def update_err(new, ref, grads, lr: float) -> float:
    """The largest gap between two updates (or two parameter trees updated
    from the same one) over the entries whose reference gradient is at
    least 1e-5 of its leaf's largest, in units of ``lr``: where |g| is at
    its rounding noise, one Adam step m̂ / (√v̂ + ε) ≈ sign(g) may flip,
    which is the same update of another rounding, not a fault."""
    worst = 0.0
    for a, b, g in zip(new, ref, grads):
        g = g.detach().cpu().float().abs()
        keep = g >= 1e-5 * float(g.max())
        d = (a.detach().cpu().float() - b.detach().cpu().float()).abs()[keep]
        worst = max(worst, float(d.max()) / lr if d.numel() else 0.0)
    return worst


def _train_parity(dev, check) -> dict:
    """(b) PARITY_STEPS train steps of each reduced PARITY_ARCHS model from
    the same parameters and batch on the card and the CPU: the first
    step's loss, gradients and update (``update_err`` within a hundredth
    of a step) gated; each later step's update recorded against the CPU's
    (from parameters apart by the earlier steps' rounding); and, except
    for granite, ``microbatch=2`` against one step over the whole batch on
    the card (granite's aux loss is taken per microbatch, as in the JAX
    package, so its loss is another function there).

    The attention archs are gated in their float32.  The recurrent archs
    run twice: in float32, recorded, and in float64, gated.  Their float32
    gradients carry 3-5e-5 of a leaf's largest of rounding (six layers of
    exponential gates multiply a rounding by 2-3 each; the same gap
    separates the JAX package's float32 gradients from the port's on the
    CPU), so entries of a few Adam ε (1e-8) pass the gate's filter, where
    the first update g / (|g| + ε) is not yet sign(g) and moves by several
    hundredths of a step (PERF.md §6, PR 21)."""
    import dataclasses

    import torch
    from repro_torch import configs
    from repro_torch.models import model as M
    from repro_torch.optim import adamw_init
    from repro_torch.optim.adamw import tree_leaves

    def to(tree, d, dtype=None):   # a copy: the step updates its parameters in place
        return {k: to(v, d, dtype) if isinstance(v, dict)
                else v.detach().to(d, dtype if v.is_floating_point() else None,
                                   copy=True)
                for k, v in tree.items()}

    def rel(a, b):
        return float((a.detach().cpu().double() - b.detach().cpu().double()).abs().max()
                     / (b.detach().double().abs().max() + 1e-30))

    lr = 1e-3
    out = {}
    for arch in PARITY_ARCHS:
        base = configs.get_reduced(arch)
        recurrent = base.family in ("hybrid", "ssm")
        for dtype in ("float32", "float64") if recurrent else ("float32",):
            cfg = dataclasses.replace(base, dtype=dtype)
            gated = dtype == "float64" or not recurrent
            init = M.init_params(M.build_model(base, model_axis=1), seed=0,
                                 device="cpu")
            batch = M.demo_batch(base, 4, 32, seed=1, device="cpu")
            runs = {}
            plan = [("cpu", "cpu", 1, PARITY_STEPS), ("card", dev, 1, PARITY_STEPS)]
            if cfg.family != "moe" and gated:
                plan.append(("card_mb2", dev, 2, 1))
            for where, d, mb, steps in plan:
                m = M.build_model(cfg, model_axis=1)
                params = m.load_params(to(init, d, cfg.params_dtype))
                b = to(batch, d)
                leaves = tree_leaves(params)
                opt = adamw_init(params)
                step_fn = M.make_train_step(m, lr=lr, microbatch=mb)
                losses, grads, updates = [], [], []
                for i in range(steps):
                    grads.append(torch.autograd.grad(m.loss(params, b), leaves))
                    before = [p.detach().clone() for p in leaves]
                    params, opt, met = step_fn(params, opt, b, i)
                    losses.append(float(met["loss"]))
                    updates.append([p.detach() - q for p, q in zip(leaves, before)])
                runs[where] = (losses, grads, updates)
            (lc, gc, uc), (lg, gg, ug) = runs["cpu"], runs["card"]
            r = {"dtype": dtype, "gated": gated, "loss_cpu": lc[0], "loss_card": lg[0],
                 "loss_rel_err": abs(lg[0] - lc[0]) / abs(lc[0]),
                 "grad_err_rel_to_leaf_max": max(rel(a, b) for a, b in zip(gg[0], gc[0])),
                 "update_err_in_lr": update_err(ug[0], uc[0], gc[0], lr),
                 "later_update_err_in_lr": [update_err(ug[i], uc[i], gc[i], lr)
                                            for i in range(1, PARITY_STEPS)],
                 "later_grad_err_rel_to_leaf_max": [
                     max(rel(a, b) for a, b in zip(gg[i], gc[i]))
                     for i in range(1, PARITY_STEPS)]}
            if gated:
                check(r["loss_rel_err"] <= TRAIN_LOSS_TOL, f"{arch}: card loss {r}")
                check(r["grad_err_rel_to_leaf_max"] <= TRAIN_GRAD_TOL,
                      f"{arch}: card gradients {r}")
                check(r["update_err_in_lr"] <= 1e-2, f"{arch}: card update {r}")
            if "card_mb2" in runs:
                lm, _, um = runs["card_mb2"]
                r.update({"loss_card_microbatch2": lm[0],
                          "microbatch2_loss_rel_err": abs(lm[0] - lg[0]) / abs(lg[0]),
                          "microbatch2_update_err_in_lr": update_err(um[0], ug[0],
                                                                     gg[0], lr)})
                check(r["microbatch2_loss_rel_err"] <= TRAIN_LOSS_TOL
                      and r["microbatch2_update_err_in_lr"] <= 1e-2,
                      f"{arch}: microbatch=2 {r}")
            print(f"train parity {arch} {dtype}: {json.dumps(r)}", flush=True)
            out[arch if dtype == "float32" else f"{arch}_{dtype}"] = r
    return out


def _train_drills(dev, check) -> dict:
    """(c) ``launch.train.train`` end to end on the card, reduced qwen3-4b,
    6 steps, a checkpoint every 2: a failure at step 3 resumed by
    ``run_with_restarts`` must end equal, byte for byte, to an
    uninterrupted run (same device, deterministic algorithms); the same
    drill with NeurLZ-compressed weights (TRAIN_LOSSY_EB) must resume and
    finish; the uninterrupted run's final weights saved lossy on the card
    restore within eb · range (1-D leaves exact), equal byte for byte to
    the same checkpoint restored on the CPU, each lossy leaf one
    ``lorenzo3d_fwd`` and one ``lorenzo3d_inv`` launch; and
    ``neurlz_grad_archive`` of one step's gradients equal on card and CPU."""
    import types

    import torch
    from repro_torch import configs
    from repro_torch.checkpoint import CheckpointManager, run_with_restarts
    from repro_torch.core import archive as arc_io
    from repro_torch.kernels import lorenzo3d as lz
    from repro_torch.launch import train as train_lib
    from repro_torch.models import model as M
    from repro_torch.optim import neurlz_grad_archive
    from repro_torch.optim.adamw import tree_leaves, tree_map, tree_unflatten

    root = ROOT / "build" / "chip_smoke" / "train_ckpt"
    if root.exists():
        import shutil
        shutil.rmtree(root)

    def args(name, fail=None, lossy=None, arch="qwen3-4b"):
        return types.SimpleNamespace(
            arch=arch, preset="reduced", steps=6, batch=8, seq=64,
            lr=3e-3, seed=0, microbatch=1, ckpt_dir=str(root / name),
            ckpt_every=2, keep=3, resume=True, lossy_ckpt_eb=lossy,
            fail_at_step=fail, step_deadline=120.0, log_every=0, device=str(dev))

    def drill(name, lossy=None, arch="qwen3-4b"):
        attempts = []

        def make():
            attempts.append(1)
            return train_lib.train(args(name, 3 if len(attempts) == 1 else None,
                                        lossy, arch))
        rep = run_with_restarts(make)
        check(len(attempts) == 2 and rep["resumed_from"] == 2,
              f"{name}: {len(attempts)} attempts, resumed from {rep['resumed_from']}")
        return rep

    out = {}
    t0 = time.perf_counter()
    whole = train_lib.train(args("whole"))
    resumed = drill("resumed")
    same = {n: (root / "whole" / "step_6" / n).read_bytes()
            == (root / "resumed" / "step_6" / n).read_bytes()
            for n in ("params.bin", "opt.bin")}
    out["lossless"] = {"whole": whole, "resumed": resumed, "bit_equal": same,
                       "seconds": time.perf_counter() - t0}
    check(all(same.values()), f"lossless restart differs from the whole run: {same}")
    check(whole["last_loss"] < whole["first_loss"], f"loss did not fall: {whole}")

    t0 = time.perf_counter()
    lossy = drill("lossy", TRAIN_LOSSY_EB)
    check(lossy["last_loss"] == lossy["last_loss"], "lossy drill: NaN loss")

    # The recurrent xlstm-350m through the same drill, lossy: its float32
    # leaves of 2 or more dimensions go through the Lorenzo kernels at each
    # save, and back at the restart.
    t1 = time.perf_counter()
    f0, i0 = lz.fwd_launches, lz.inv_launches
    xl = drill("xlstm_lossy", TRAIN_LOSSY_EB, "xlstm-350m")
    out["xlstm_lossy"] = {"resumed": xl, "fwd_launches": lz.fwd_launches - f0,
                          "inv_launches": lz.inv_launches - i0,
                          "seconds": time.perf_counter() - t1}
    check(xl["last_loss"] == xl["last_loss"] and xl["last_loss"] < xl["first_loss"],
          f"xlstm lossy drill: {xl}")
    check(lz.fwd_launches > f0 and lz.inv_launches > i0,
          f"xlstm lossy drill launched no Lorenzo kernel: {out['xlstm_lossy']}")

    # The uninterrupted run's final weights, saved lossy on the card.
    cfg = configs.get_reduced("qwen3-4b")
    model = M.build_model(cfg, model_axis=1)
    template = M.init_params(model, seed=0, device=dev)
    exact, _, _ = CheckpointManager(str(root / "whole"), device=dev).restore(6, template)
    n_lossy = sum(1 for p in tree_leaves(exact) if p.ndim >= 2)
    shapes = sorted({tuple(p.shape) for p in tree_leaves(exact) if p.ndim >= 2})
    mgr = CheckpointManager(str(root / "lossy_final"), lossy_weights_eb=TRAIN_LOSSY_EB,
                            device=dev)
    f0, i0 = lz.fwd_launches, lz.inv_launches
    mgr.save(6, exact)
    f1 = lz.fwd_launches
    on_card, _, _ = mgr.restore(6, template)
    i1 = lz.inv_launches
    on_cpu, _, _ = CheckpointManager(str(root / "lossy_final"), device="cpu").restore(
        6, template)
    worst, equal = 0.0, True
    for a, b, c in zip(tree_leaves(exact), tree_leaves(on_card), tree_leaves(on_cpu)):
        equal &= bool(torch.equal(b.cpu().view(torch.int32), c.view(torch.int32)))
        if a.ndim >= 2:
            lim = TRAIN_LOSSY_EB * float(a.max() - a.min())
            err = float((b - a).abs().max())
            worst = max(worst, err / lim if lim > 0 else err)
            check(err <= lim, f"lossy weight {tuple(a.shape)}: {err} > {lim}")
        else:
            check(torch.equal(a, b), f"1-D weight {tuple(a.shape)} changed")
    out["lossy"] = {"resumed": lossy, "lossy_leaves": n_lossy,
                    "lossy_shapes": [list(s) for s in shapes],
                    "fwd_launches": f1 - f0, "inv_launches": i1 - i0,
                    "worst_err_over_bound": worst, "card_equals_cpu": equal,
                    "params_bin_bytes": (root / "lossy_final" / "step_6"
                                         / "params.bin").stat().st_size,
                    "raw_params_bin_bytes": (root / "whole" / "step_6"
                                             / "params.bin").stat().st_size,
                    "seconds": time.perf_counter() - t0}
    check(equal, "the lossy checkpoint restores differently on card and CPU")
    # Each lossy leaf, the [2, 64] norms (H = 2, W = 64) among them, takes
    # the kernel route: one forward launch to save, one inverse to restore.
    check((2, 64) in shapes and f1 - f0 == n_lossy and i1 - i0 == n_lossy,
          f"lossy leaves {n_lossy} ({shapes}), launches fwd {f1 - f0} inv {i1 - i0}")

    # One step's gradients through neurlz_grad_archive on card and CPU.
    batch = M.demo_batch(cfg, 8, 64, seed=2, device=dev)
    params = model.load_params(exact)
    grads = torch.autograd.grad(model.loss(params, batch), tree_leaves(params))
    gtree = tree_unflatten(params, grads)
    card = neurlz_grad_archive(gtree, rel_eb=1e-3, device=dev)
    cpu = neurlz_grad_archive(tree_map(lambda g: g.cpu(), gtree), rel_eb=1e-3,
                              device="cpu")
    same_arcs = (sorted(card["arcs"]) == sorted(cpu["arcs"]) and all(
        arc_io.dumps(card["arcs"][k]) == arc_io.dumps(cpu["arcs"][k])
        for k in cpu["arcs"]))
    out["grad_archive"] = {"leaves": len(card["arcs"]), "raw_bytes": card["raw_bytes"],
                           "comp_bytes": card["comp_bytes"], "ratio": card["ratio"],
                           "card_equals_cpu": same_arcs}
    check(same_arcs, "neurlz_grad_archive differs on card and CPU")
    del model, params, exact, on_card
    _lm_free()
    return out


def train_path(dev, report: dict) -> dict:
    """The LM substrate's training path: (a) TRAIN_ARCHS at full width,
    (b) the reduced presets on card and CPU, (c) the restart drills and
    lossy checkpoints (``_train_full_width``, ``_train_parity``,
    ``_train_drills``).  Its kernels: ``lorenzo3d_fwd`` / ``lorenzo3d_inv``
    of the lossy checkpoints and the gradient archive."""
    from repro_torch import kernels

    def check(ok: bool, what: str) -> None:
        if not ok:
            raise AssertionError(f"train path: {what}")

    t_path = time.perf_counter()
    kernels.reset_launch_counts()
    full = {}
    for arch in TRAIN_ARCHS:
        full[arch] = _train_full_width(dev, check, arch)
        r = full[arch]
        print(f"train {arch} bf16 full width ({r['n_layers']} layers): "
              f"{r['n_params']:,} params, step "
              f"{r['step_ms_median_2_8']:.2f} ms (median of steps 2-8; "
              f"{r['tokens_per_s']:.1f} tok/s; bound {r['bound_ms']:.2f} ms, "
              f"x{r['x_bound']:.2f}; device {r['device_ms_per_step']:.2f} ms/step, "
              f"{r['device_kernels_per_step']:.1f} kernels/step), loss "
              f"{r['losses'][0]:.4f} -> {r['losses'][-1]:.4f}, grad norms "
              f"{[round(v, 4) for v in r['grad_norms']]}, max_memory_allocated "
              f"{r['max_memory_allocated']:,}", flush=True)
    out = {"full_width": full,
           "parity": _train_parity(dev, check),
           "drills": _train_drills(dev, check)}
    launches = kernels.launch_counts()
    out["launches"] = launches
    out["device_peak_bytes"] = max(r["max_memory_allocated"] for r in full.values())
    out["seconds"] = time.perf_counter() - t_path
    print("train_path", json.dumps(out))
    report["train_path"] = out
    return launches


DIST_ARCHS = ("qwen3-4b", "zamba2-7b", "deepseek-moe-16b")   # rules at full width
DIST_BATCH = 4            # the lm path's batch, at its length LM_PROMPT + LM_GEN


def _spec_shards(spec, sizes: dict) -> int:
    """How many pieces a spec cuts a leaf into on a mesh of ``sizes``."""
    n = 1
    for ax in spec:
        for a in (ax if isinstance(ax, tuple) else (ax,) if ax else ()):
            n *= sizes[a]
    return n


def _dist_rules(host_mesh) -> dict:
    """(a) The sharding rules at full width: each DIST_ARCHS model's param,
    optimizer, cache (batch DIST_BATCH, LM_PROMPT + LM_GEN) and input specs
    on the 16x16 and 2x16x16 production shapes and on the 1x1 NCCL host
    mesh: sharded and replicated leaves, and the param and optimizer bytes
    a device holds under each."""
    from repro_torch import configs
    from repro_torch.configs import ShapeConfig
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import tree_leaves

    meshes = {"16x16": mesh_lib.make_production_mesh(),
              "2x16x16": mesh_lib.make_production_mesh(multi_pod=True),
              "host 1x1": host_mesh}
    max_len = LM_PROMPT + LM_GEN
    out = {}
    for arch in DIST_ARCHS:
        cfg = configs.get_config(arch)
        model = M.build_model(cfg, model_axis=16)
        params = M.abstract_params(model)
        opt = M.abstract_opt_state(params)
        cache = M.abstract_cache(model, DIST_BATCH, max_len)
        inputs = M.input_specs(cfg, ShapeConfig("lm", max_len, DIST_BATCH, "prefill"))
        p_leaves = tree_leaves(params)
        row = {"params": sum(p.numel() for p in p_leaves)}
        for name, mesh in meshes.items():
            sizes = sh.mesh_sizes(mesh)
            pspecs = tree_leaves(sh.param_pspecs(params, mesh))
            ospecs = sh.opt_pspecs(sh.param_pspecs(params, mesh))
            cspecs = tree_leaves(sh.cache_pspecs(cache, mesh, DIST_BATCH))
            ispecs = sh.input_pspecs(inputs, mesh)
            cut = [_spec_shards(s, sizes) for s in pspecs]
            p_bytes = sum(p.numel() * p.element_size() / c for p, c in zip(p_leaves, cut))
            o_bytes = sum(2 * 4 * p.numel() / c for p, c in zip(p_leaves, cut)) + 4
            row[name] = {
                "param_leaves_sharded": sum(c > 1 for c in cut),
                "param_leaves_replicated": sum(c == 1 for c in cut),
                "opt_leaves": len(tree_leaves(ospecs.mu)) * 2 + 1,
                "cache_leaves_sharded": sum(_spec_shards(s, sizes) > 1 for s in cspecs),
                "cache_leaves": len(cspecs),
                "input_specs": {k: repr(v) for k, v in ispecs.items()},
                "param_bytes_per_device": p_bytes,
                "opt_bytes_per_device": o_bytes}
        out[arch] = row
        for name in meshes:
            r = row[name]
            print(f"dist rules {arch} on {name}: params "
                  f"{r['param_leaves_sharded']} sharded / "
                  f"{r['param_leaves_replicated']} replicated leaves, "
                  f"{r['param_bytes_per_device'] / 1e9:.4f} GB params and "
                  f"{r['opt_bytes_per_device'] / 1e9:.4f} GB AdamW a device; "
                  f"cache {r['cache_leaves_sharded']}/{r['cache_leaves']} leaves "
                  f"sharded; inputs {r['input_specs']}", flush=True)
    return out


def _dist_full_width(dev, host_mesh, check) -> dict:
    """(b) ``reshard_to_mesh`` of qwen3-4b's full-width bf16 params on the
    1x1 NCCL mesh, every local shard its source bit for bit; (c)
    ``compressed_psum`` and ``bf16_psum`` of one full-width gradient tree
    (one forward and backward at TRAIN_BATCH x TRAIN_SEQ) over the NCCL
    group of one rank: the mean equal to ``dequantize(quantize_ef(g))`` at
    the shared scale and the carry to ``g - mean * n``, bit for bit, leaf by
    leaf; ``bf16_psum`` equal to ``bf16(g).float()``; each traced
    (``device_time``: device ms and activities a call), then timed on the
    host clock against its bytes-once bound, with the wire bytes it
    reports."""
    import torch
    from repro_torch import configs
    from repro_torch.data.tokens import TokenStream
    from repro_torch.distributed import elastic
    from repro_torch.models import model as M
    from repro_torch.optim import grad_compress as gc
    from repro_torch.optim.adamw import tree_items, tree_leaves, tree_unflatten

    cfg = configs.get_config("qwen3-4b")
    torch.cuda.reset_peak_memory_stats()
    model = M.build_model(cfg, model_axis=1)
    params = M.init_params(model, seed=0, device=dev)
    out = {"arch": cfg.name, "n_params": sum(p.numel() for p in tree_leaves(params))}

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        placed = elastic.reshard_to_mesh(params, host_mesh)
    torch.cuda.synchronize()
    out["reshard_s"] = time.perf_counter() - t0
    src = dict(tree_items(params))
    bad = [k for k, d in tree_items(placed) if not _bits_equal(d.to_local(), src[k])]
    out["reshard_leaves"] = len(src)
    out["reshard_bad"] = ["/".join(k) for k in bad]
    check(not bad, f"reshard_to_mesh changed {out['reshard_bad'][:5]}")
    del placed, src

    stream = TokenStream(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    batch = {"tokens": torch.from_numpy(stream.next_batch()).to(dev)}
    leaves = tree_leaves(params)
    loss = model.loss(params, batch, remat_policy="nothing")
    grads = tree_unflatten(params, [g.detach() for g in torch.autograd.grad(loss, leaves)])
    out["loss"] = float(loss.detach())
    del loss, leaves, params, model
    _lm_free()
    values = sum(g.numel() for g in tree_leaves(grads))
    n_leaves = len(tree_leaves(grads))

    def device_time(name, fn, iters: int = 2):
        """Device time and activities per call from a device-only trace of
        ``iters`` calls after a warm one (results dropped), taken again
        while it holds no activity or not a multiple of ``iters`` (a short
        trace can lose its activity), at most TRACE_TRIES times."""
        fn()
        _lm_free()

        def calls():
            for _ in range(iters):
                fn()
        counts = []
        for attempt in range(1, TRACE_TRIES + 1):
            events = device_events(traced(calls, cpu=False))
            counts.append(len(events))
            if events and len(events) % iters == 0:
                break
            RETRACED[name] = attempt + 1
        check(bool(events) and len(events) % iters == 0,
              f"{name}: {TRACE_TRIES} traces without its device activity "
              f"(activities per trace {counts} for {iters} calls)")
        out[f"{name}_device_ms"] = (sum(e.time_range.elapsed_us() for e in events)
                                    / 1e3 / iters)
        out[f"{name}_device_kernels"] = len(events) // iters
        _lm_free()

    device_time("compressed_psum", lambda: gc.compressed_psum(grads, None))
    stats: dict = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mean, ef = gc.compressed_psum(grads, None, stats=stats)
    torch.cuda.synchronize()
    out["compressed_psum_ms"] = (time.perf_counter() - t0) * 1e3
    out["compressed_wire_bytes"] = stats["wire_bytes"]
    worst_scale, mismatched = 0.0, []
    for path, g in tree_items(grads):
        m, e = mean, ef
        for k in path[:-1]:
            m, e = m[k], e[k]
        q, s, _ = gc.quantize_ef(g, torch.zeros((), device=dev))
        ok = (_bits_equal(m[path[-1]], q.float() * s)
              and _bits_equal(e[path[-1]], g.float() - m[path[-1]] * 1))
        if not ok:
            mismatched.append("/".join(path))
        worst_scale = max(worst_scale, float(s))
        del q, s, m[path[-1]], e[path[-1]]
    out["compressed_mismatched"] = mismatched
    out["largest_scale"] = worst_scale
    check(not mismatched, f"compressed_psum differs from quantize_ef: {mismatched[:5]}")
    del mean, ef
    _lm_free()

    device_time("bf16_psum", lambda: gc.bf16_psum(grads))
    stats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    summed = gc.bf16_psum(grads, stats=stats)
    torch.cuda.synchronize()
    out["bf16_psum_ms"] = (time.perf_counter() - t0) * 1e3
    out["bf16_wire_bytes"] = stats["wire_bytes"]
    summed = dict(tree_items(summed))
    bad = ["/".join(k) for k, g in tree_items(grads)
           if not _bits_equal(summed[k], g.to(torch.bfloat16).float())]
    check(not bad, f"bf16_psum differs from bf16(g): {bad[:5]}")
    del summed
    out["f32_wire_bytes"] = 4 * values
    out["values"], out["leaves"] = values, n_leaves
    g_bytes = sum(g.numel() * g.element_size() for g in tree_leaves(grads))
    # Bytes once: the gradient read, the float32 mean and carry written;
    # bf16_psum: the gradient read, the float32 sum written.
    out["compressed_bound_ms"] = (g_bytes + 8 * values) / HBM_BYTES_PER_S * 1e3
    out["bf16_bound_ms"] = (g_bytes + 4 * values) / HBM_BYTES_PER_S * 1e3
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    del grads
    _lm_free()
    return out


def _dist_elastic(dev, check) -> dict:
    """(d) The elastic drill on the card at the reduced qwen3-4b (a
    full-width checkpoint is 40 GB through the host codec): the state after
    one step placed on a 1x1 mesh and saved, ``rescale``'d onto a fresh 1x1
    mesh, params and moments equal bit for bit, and one train step from the
    rescaled state equal byte for byte to one from the saved state."""
    import shutil

    import torch
    from repro_torch import configs
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed import elastic
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import tree_items, tree_map

    root = ROOT / "build" / "chip_smoke" / "dist_ckpt"
    if root.exists():
        shutil.rmtree(root)
    cfg = configs.get_reduced("qwen3-4b")
    batches = [M.demo_batch(cfg, 8, 64, seed=s, device=dev) for s in (5, 6)]

    def fresh():
        model = M.build_model(cfg, model_axis=1)
        return model, M.make_train_step(model, lr=3e-3)

    model, step = fresh()
    params, opt = M.init_train_state(model, seed=0, device=dev)
    params, opt, _ = step(params, opt, batches[0], 0)
    saved_p = tree_map(lambda t: t.detach().clone(), params)
    saved_o = type(opt)(step=opt.step, mu=tree_map(torch.clone, opt.mu),
                        nu=tree_map(torch.clone, opt.nu))
    t0 = time.perf_counter()
    host = make_host_mesh(dev)
    placed = elastic.reshard_to_mesh(saved_p, host)
    mgr = CheckpointManager(str(root), device=dev)
    mgr.save(1, placed, type(opt)(step=opt.step, mu=elastic.reshard_to_mesh(opt.mu, host),
                                  nu=elastic.reshard_to_mesh(opt.nu, host)))
    new_p, new_o, meta = elastic.rescale(mgr, 1, saved_p, saved_o, make_host_mesh(dev))
    torch.cuda.synchronize()
    out = {"save_rescale_s": time.perf_counter() - t0, "step": new_o.step}
    same = all(_bits_equal(d.to_local(), saved) for tr, ref in
               ((new_p, saved_p), (new_o.mu, saved_o.mu), (new_o.nu, saved_o.nu))
               for (_, d), (_, saved) in zip(tree_items(tr), tree_items(ref)))
    out["state_bit_equal"] = same
    check(same and new_o.step == saved_o.step == meta["step"],
          "rescale changed the params or moments")

    def one_step(p, o):
        model, step_fn = fresh()
        p = model.load_params(tree_map(lambda t: t.detach().clone(), p))
        o = type(o)(step=o.step, mu=tree_map(torch.clone, o.mu),
                    nu=tree_map(torch.clone, o.nu))
        p, o, _ = step_fn(p, o, batches[1], o.step)
        return p, o

    local = lambda tr: tree_map(lambda d: d.to_local(), tr)  # noqa: E731
    a_p, a_o = one_step(local(new_p), type(new_o)(step=new_o.step, mu=local(new_o.mu),
                                                  nu=local(new_o.nu)))
    b_p, b_o = one_step(saved_p, saved_o)
    equal = all(_bits_equal(x.detach(), y.detach()) for tr_a, tr_b in
                ((a_p, b_p), (a_o.mu, b_o.mu), (a_o.nu, b_o.nu))
                for (_, x), (_, y) in zip(tree_items(tr_a), tree_items(tr_b)))
    out["step_bit_equal"] = equal
    check(equal, "a train step from the rescaled state differs from the saved state's")
    return out


def dist_path(dev, report: dict) -> dict:
    """The distributed layer on the card over NCCL (one rank: NCCL takes
    one rank a device; the multi-rank checks run on the CPU over gloo in
    ``tests/test_torch_distributed.py``): (a) ``_dist_rules``, (b) and (c)
    ``_dist_full_width``, (d) ``_dist_elastic``.  No kernel of the port."""
    import torch
    import torch.distributed as dist
    from repro_torch import kernels
    from repro_torch.launch import mesh as mesh_lib

    def check(ok: bool, what: str) -> None:
        if not ok:
            raise AssertionError(f"dist path: {what}")

    t_path = time.perf_counter()
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    mesh_lib.init_world(dev)
    try:
        backend = str(dist.get_backend())
        check(backend == "nccl", f"the process group runs {backend}, not nccl")
        host = mesh_lib.make_host_mesh(dev)
        check(host.device_type == "cuda" and tuple(host.shape) == (1, 1),
              f"host mesh {host}")
        out = {"backend": backend, "world_size": dist.get_world_size()}
        t = time.perf_counter()
        out["rules"] = _dist_rules(host)
        out["rules_s"] = time.perf_counter() - t
        t = time.perf_counter()
        out["full_width"] = _dist_full_width(dev, host, check)
        out["full_width_s"] = time.perf_counter() - t
        t = time.perf_counter()
        out["elastic"] = _dist_elastic(dev, check)
        out["elastic_s"] = time.perf_counter() - t
    finally:
        dist.destroy_process_group()
    fw = out["full_width"]
    print(f"dist qwen3-4b full width over {backend} (world 1): reshard "
          f"{fw['reshard_leaves']} leaves in {fw['reshard_s']:.3f} s, bit equal; "
          f"compressed_psum {fw['compressed_psum_ms']:.2f} ms (device "
          f"{fw['compressed_psum_device_ms']:.2f} ms in "
          f"{fw['compressed_psum_device_kernels']} kernels; bound "
          f"{fw['compressed_bound_ms']:.2f} ms), wire {fw['compressed_wire_bytes']:,} B "
          f"int32; bf16_psum {fw['bf16_psum_ms']:.2f} ms (device "
          f"{fw['bf16_psum_device_ms']:.2f} ms in {fw['bf16_psum_device_kernels']} "
          f"kernels; bound {fw['bf16_bound_ms']:.2f} ms), wire "
          f"{fw['bf16_wire_bytes']:,} B; "
          f"f32 {fw['f32_wire_bytes']:,} B; peak {fw['max_memory_allocated']:,} B",
          flush=True)
    launches = kernels.launch_counts()
    out["launches"] = launches
    out["device_peak_bytes"] = torch.cuda.max_memory_allocated()
    out["seconds"] = time.perf_counter() - t_path
    print("dist_path", json.dumps(out, default=str))
    report["dist_path"] = out
    return launches


DRYRUN_CELLS = (("qwen3-4b", "train_4k"), ("qwen3-4b", "prefill_32k"),
                ("qwen3-4b", "decode_32k"), ("neurlz_enhance", None),
                ("granite-moe-3b-a800m", "train_4k"), ("xlstm-350m", "decode_32k"),
                ("zamba2-7b", "long_500k"))
DRYRUN_COUNTED = ("qwen3-4b", "granite-moe-3b-a800m")   # (b): real steps
DRYRUN_MESHES = ("single", "multi")     # 16x16, 2x16x16
DRYRUN_DIR = ROOT / "build" / "chip_smoke" / "dryrun"
DRYRUN_WAIT_S = 600        # the longest the phase waits for (a) to end
DRYRUN_FLOPS_TOL = 0.05    # counted products vs train_step_flops, relative
DRYRUN_PEAK_TOL = 0.10     # counted peak vs max_memory_allocated, relative
ENHANCE_BLOCKS, ENHANCE_SIDE, ENHANCE_SLICES = 512, 512, 10   # the paper cell


def _dryrun_tag(arch, shape, mesh) -> str:
    return f"{arch}_{shape or 'na'}_{mesh}"


def start_dryrun() -> list:
    """(a) of the dryrun phase, started after the build: one process a
    DRYRUN_CELLS cell (``python -m repro_torch.launch.dryrun``, both meshes
    in turn: fake worlds of 256 and 512 ranks on meta tensors, no card:
    CUDA is hidden from it), at the lowest CPU priority, so the card's
    phases keep their host.  Returns ``[(cell, Popen, log)]``."""
    import os

    DRYRUN_DIR.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    procs = []
    for arch, shape in DRYRUN_CELLS:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--out", str(DRYRUN_DIR)]
        cmd += (["--cell", arch] if shape is None
                else ["--arch", arch, "--shape", shape])
        log = open(DRYRUN_DIR / f"{arch}_{shape or 'na'}.log", "w")
        procs.append(((arch, shape), subprocess.Popen(
            cmd, cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT,
            preexec_fn=lambda: os.nice(19)), log))
    return procs


def stop_dryrun(procs) -> None:
    """Ends every process of :func:`start_dryrun` still running."""
    for _, p, log in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
        log.close()


def _dryrun_records(procs, check) -> dict:
    """(a) Waits for the dry-run processes; each cell's record on each
    mesh, which must be ``ok``."""
    t0 = time.perf_counter()
    recs = {}
    for (arch, shape), p, log in procs:
        left = max(DRYRUN_WAIT_S - (time.perf_counter() - t0), 1.0)
        try:
            p.wait(timeout=left)
        except subprocess.TimeoutExpired:
            check(False, f"the dry run of {arch} {shape} did not end in "
                  f"{DRYRUN_WAIT_S} s")
        for mesh in DRYRUN_MESHES:
            tag = _dryrun_tag(arch, shape, mesh)
            path = DRYRUN_DIR / f"{tag}.json"
            check(path.exists(), f"the dry run of {tag} wrote no record (exit "
                  f"{p.returncode}): " + Path(log.name).read_text()[-2000:])
            rec = json.loads(path.read_text())
            check(rec.get("status") == "ok", f"{tag}: {rec.get('error')}")
            r = rec["roofline"]
            print(f"dryrun {tag}: peak {rec['memory']['peak_hbm_bytes'] / 1e9:.3f} "
                  f"GB a device (args {rec['memory']['argument_bytes'] / 1e9:.4f}); "
                  f"compute {r['compute_s'] * 1e3:.2f} ms, memory "
                  f"{r['memory_s'] * 1e3:.2f} ms, collective "
                  f"{r['collective_s'] * 1e3:.2f} ms, dominant {r['dominant']}; "
                  f"useful {rec.get('useful_compute_ratio')}; lowered in "
                  f"{rec['lower_s']} s", flush=True)
            recs[tag] = rec
        check(p.returncode == 0, f"the dry run of {arch} {shape} exited "
              f"{p.returncode}")
    return recs


def _dryrun_counted(dev, check, arch: str) -> dict:
    """(b) One real ``arch`` train step at the train path's size (full
    width and depth, bf16, TRAIN_BATCH x TRAIN_SEQ, full remat) on the
    card, counted (after one warm step); its product FLOPs against
    train_step_flops less recompute_skipped_flops, its counted peak
    against max_memory_allocated; then the same step lowered by
    ``lower_cell`` on a fake 1x1 world (meta tensors): the same FLOPs and
    bytes, no collective."""
    import torch
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import dryrun, op_cost
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import roofline as rl
    from repro_torch.models import model as M

    cfg = configs.get_config(arch)
    model = M.build_model(cfg, model_axis=1)
    params, opt = M.init_train_state(model, seed=0, device=dev)
    step_fn = M.make_train_step(model, remat_policy="nothing")
    gen = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ),
                                     generator=gen, dtype=torch.int32).to(dev)}
    params, opt, _ = step_fn(params, opt, batch, 0)          # warm
    torch.cuda.synchronize()
    args_bytes = dryrun.local_bytes((params, opt.mu, opt.nu, batch))
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t = time.perf_counter()
    with op_cost.OpCounter() as counter:
        params, opt, met = step_fn(params, opt, batch, 1)
        torch.cuda.synchronize()
    step_s = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    real = counter.result()
    check(bool(torch.isfinite(met["loss"])), "the counted step's loss is not finite")
    tb = train_bound(cfg, model)     # as the train path's bound
    del params, opt, met, step_fn, model
    _lm_free()

    reckoned = tb["bf16_flops"] + tb["f32_flops"]   # less the skipped recompute
    skipped = tb["recompute_skipped"]
    flops_gap = real["product_flops"] / reckoned - 1.0
    counted_peak = args_bytes + real["peak_bytes"]
    peak_gap = counted_peak / peak - 1.0
    terms = rl.roofline_terms(
        real["flops"], real["bytes"], 0.0,
        f32_flops=real["product_flops_by_dtype"].get("float32", 0.0))
    roof_ms = max(terms["compute_s"], terms["memory_s"]) * 1e3
    out = {"arch": arch, "product_flops": real["product_flops"],
           "flops": real["flops"],
           "bytes": real["bytes"], "transcendentals": real["transcendentals"],
           "train_step_flops": reckoned + skipped, "recompute_skipped": skipped,
           "raw_flops_gap": real["product_flops"] / (reckoned + skipped) - 1.0,
           "flops_gap": flops_gap,
           "args_bytes": args_bytes, "base_allocated": base,
           "counted_peak": counted_peak, "max_memory_allocated": peak,
           "peak_gap": peak_gap, "step_ms": step_s * 1e3,
           "product_flops_by_dtype": real["product_flops_by_dtype"],
           "roofline_ms": roof_ms, "roofline": terms,
           "hand_bound_ms": tb["bound_ms"]}
    check(abs(flops_gap) <= DRYRUN_FLOPS_TOL,
          f"counted product FLOPs {real['product_flops']:.4e} vs "
          f"train_step_flops {reckoned + skipped:.4e} less the recompute's skipped "
          f"{skipped:.4e} ({flops_gap:+.2%})")
    check(abs(peak_gap) <= DRYRUN_PEAK_TOL,
          f"counted peak {counted_peak:,} vs max_memory_allocated {peak:,} "
          f"({peak_gap:+.2%})")

    mesh = mesh_lib.make_fake_world(sizes={"data": 1, "model": 1})
    try:
        rec = dryrun.lower_cell(cfg, ShapeConfig("card_train", TRAIN_SEQ,
                                                 TRAIN_BATCH, "train"),
                                mesh, remat="nothing", microbatch=1)
    finally:
        dist.destroy_process_group()
    out["fake_1x1"] = {"flops": rec["cost"]["flops_per_device"],
                       "bytes": rec["cost"]["bytes_per_device"],
                       "collectives": rec["collectives"]["per_kind_count"],
                       "argument_bytes": rec["memory"]["argument_bytes"],
                       "temp_bytes": rec["memory"]["temp_bytes"],
                       "lower_s": rec["lower_s"]}
    check(rec["cost"]["flops_per_device"] == real["flops"]
          and rec["cost"]["bytes_per_device"] == real["bytes"],
          f"fake 1x1 {rec['cost']['flops_per_device']:.6e} FLOPs, "
          f"{rec['cost']['bytes_per_device']:.6e} B vs the card's "
          f"{real['flops']:.6e}, {real['bytes']:.6e}")
    check(not rec["collectives"]["per_kind_count"],
          f"fake 1x1 collectives {rec['collectives']['per_kind_count']}")
    return out


def _dryrun_enhance(dev, record: dict, check) -> dict:
    """(c) The real per-device share of ``neurlz_enhance`` on the 16x16
    mesh (ENHANCE_BLOCKS / 256 stacked enhancers, ENHANCE_SIDE^2,
    ENHANCE_SLICES slices, c_in=2) on the card, counted after a warm step:
    it launches both grouped conv kernels, and its FLOPs and bytes equal
    the fake 16x16 record's less the loss all-reduce."""
    import torch
    from repro_torch import kernels
    from repro_torch.launch import dryrun, op_cost

    n_local = ENHANCE_BLOCKS // record["n_chips"]
    params, opt, x, y = dryrun.enhance_state(n_local, ENHANCE_SIDE,
                                             ENHANCE_SLICES, dev)
    params, opt, _ = dryrun.enhance_step(params, opt, x, y)     # warm
    torch.cuda.synchronize()
    before = kernels.launch_counts()
    t = time.perf_counter()
    with op_cost.OpCounter() as counter:
        params, opt, loss = dryrun.enhance_step(params, opt, x, y)
        torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) * 1e3
    after = kernels.launch_counts()
    real = counter.result()
    moved = {k: after[k] - before[k] for k in ("conv2d3x3_grouped",
                                               "conv2d3x3_grouped_bwd")}
    want_bytes = (record["cost"]["bytes_per_device"]
                  - record["cost"]["collective_hbm_bytes"])
    out = {"blocks": n_local, "step_ms": step_ms, "loss": float(loss),
           "flops": real["flops"], "bytes": real["bytes"],
           "record_flops": record["cost"]["flops_per_device"],
           "record_bytes_less_allreduce": want_bytes,
           "launches": moved, "kernels": real["by_kernel"]}
    check(all(v > 0 for v in moved.values()), f"grouped kernels not launched: {moved}")
    check(real["flops"] == record["cost"]["flops_per_device"]
          and real["bytes"] == want_bytes,
          f"card {real['flops']:.6e} FLOPs, {real['bytes']:.6e} B vs the fake "
          f"16x16 record's {record['cost']['flops_per_device']:.6e}, {want_bytes:.6e}")
    check(not real["collective_count"], f"card step collectives {real['collective_count']}")
    del params, opt, x, y
    _lm_free()
    return out


def dryrun_path(dev, procs, report: dict) -> dict:
    """The dry run: (a) the processes of :func:`start_dryrun`, (b)
    ``_dryrun_counted`` of each DRYRUN_COUNTED arch, (c)
    ``_dryrun_enhance``.  Its kernels: the grouped
    conv forward and backward of (c)."""
    import torch
    from repro_torch import kernels

    def check(ok: bool, what: str) -> None:
        if not ok:
            raise AssertionError(f"dryrun path: {what}")

    t_path = time.perf_counter()
    t = time.perf_counter()
    recs = _dryrun_records(procs, check)
    wait_s = time.perf_counter() - t
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    counted = {}
    for arch in DRYRUN_COUNTED:
        r = counted[arch] = _dryrun_counted(dev, check, arch)
        print(f"dryrun {arch} on the card (bf16, {TRAIN_BATCH} x {TRAIN_SEQ}, "
              f"full remat): counted product FLOPs {r['product_flops']:.4e} vs "
              f"train_step_flops {r['train_step_flops']:.4e} less the "
              f"recompute's skipped {r['recompute_skipped']:.4e} "
              f"({r['flops_gap']:+.3%}; raw {r['raw_flops_gap']:+.3%}); "
              f"counted peak {r['counted_peak']:,} B vs "
              f"max_memory_allocated {r['max_memory_allocated']:,} "
              f"({r['peak_gap']:+.3%}); step {r['step_ms']:.2f} ms counted, "
              f"roofline {r['roofline_ms']:.2f} ms ({r['roofline']['dominant']}), "
              f"the train bound {r['hand_bound_ms']:.2f} ms; "
              f"fake 1x1 equal ({r['fake_1x1']['flops']:.6e} FLOPs, "
              f"{r['fake_1x1']['bytes']:.6e} B, lowered in "
              f"{r['fake_1x1']['lower_s']} s)", flush=True)
    enh = _dryrun_enhance(dev, recs[_dryrun_tag("neurlz_enhance", None, "single")],
                          check)
    print(f"dryrun neurlz_enhance on the card ({enh['blocks']} blocks, "
          f"{ENHANCE_SIDE}^2 x {ENHANCE_SLICES}): {enh['flops']:.6e} FLOPs, "
          f"{enh['bytes']:.6e} B = the fake 16x16 record less its all-reduce; "
          f"launches {enh['launches']}; step {enh['step_ms']:.2f} ms counted",
          flush=True)
    launches = kernels.launch_counts()
    out = {"records": recs, "wait_s": wait_s, "counted": counted,
           "neurlz_enhance": enh, "launches": launches,
           "device_peak_bytes": torch.cuda.max_memory_allocated(),
           "seconds": time.perf_counter() - t_path}
    print("dryrun_path", json.dumps({k: v for k, v in out.items()
                                     if k != "records"}, default=str))
    report["dryrun_path"] = out
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

    # The dry run's processes (the dryrun phase's part (a)) run beside the
    # card's phases from here; the phase waits for them.
    dry_procs = start_dryrun()
    try:
        return _run(args, shape, dev, smi, report, t_start, dry_procs)
    finally:
        stop_dryrun(dry_procs)


def _run(args, shape, dev, smi, report, t_start, dry_procs) -> int:
    import torch

    from repro_torch.data import fields as fields_lib
    t = time.perf_counter()
    fields = fields_lib.make_fields("hurricane", shape, seed=0)
    print(f"data: hurricane {shape} x {list(fields)} float32, "
          f"{time.perf_counter() - t:.1f} s to generate")

    phase_s: dict[str, float] = {}
    report["phase_s"] = phase_s

    def timed(name, fn, *fn_args):
        t0 = time.perf_counter()
        out = fn(*fn_args)
        phase_s[name] = time.perf_counter() - t0
        print(f"phase {name}: {phase_s[name]:.1f} s", flush=True)
        return out

    def kernel_phases():
        return {"conv2d3x3": conv_phase(dev, report),
                "conv2d3x3_bwd": conv_bwd_phase(dev, report),
                **grouped_phase(dev, report),
                "fused_enhance": enhance_phase(dev, shape, report),
                **lorenzo_phase(dev, fields, report)}
    summaries = timed("kernels", kernel_phases)
    if args.epochs < 100:
        print(f"every path: epochs cut to {args.epochs} of the paper's 100 "
              "(the shape is never cut)")
    # Each path runs with the counts set to 0 just before it; every kernel
    # of a path must have launched in it.
    cut = min(args.epochs, DURABLE_EPOCHS)
    main_launches, main_kept = timed("main", main_path, dev, fields, cut, report)
    lorenzo_launches, lorenzo_kept = timed(
        "lorenzo", lorenzo_path, dev, fields, min(args.epochs, LORENZO_EPOCHS),
        report)
    durable_launches = timed("durable", durable_path, dev, fields, cut,
                             main_kept, report)
    # The main path's archive is the serial engine's at these epochs: the
    # reference of the batched, streaming and serve paths.
    serial_cut = {k: main_kept[k] for k in ("epochs", "compress_s", "entries",
                                            "decoded")}
    serial_cut["per_field"] = {
        n: {k: f[k] for k in ("psnr_enhanced", "bitrate", "final_loss")}
        for n, f in main_kept["per_field"].items()}
    by_path = {"main": main_launches,
               "lorenzo": lorenzo_launches,
               "durable": durable_launches,
               "batched": timed("batched", batched_path, dev, fields, cut,
                                main_kept, serial_cut, report)}
    # The streaming path trains at the durable path's epochs (cut from the
    # paper's 100 to keep the run inside its limit), held against the main
    # path's archive; the serve path serves its container.
    by_path["streaming"], container = timed(
        "streaming", streaming_path, dev, fields, cut, serial_cut, report)
    by_path["serve"] = timed("serve", serve_path, dev, min(args.epochs, SERVE_EPOCHS),
                             serial_cut, lorenzo_kept, container, report)
    by_path["lm"] = timed("lm", lm_path, dev, report)
    _lm_free()
    by_path["train"] = timed("train", train_path, dev, report)
    _lm_free()
    by_path["dist"] = timed("dist", dist_path, dev, report)
    _lm_free()
    by_path["dryrun"] = timed("dryrun", dryrun_path, dev, dry_procs, report)
    # Last: run between serve and lm, it left the dist path's trace of
    # compressed_psum without its first call's first ~50 device activities
    # in four runs of four (in every try of three), with the trace's window
    # padded 5 ms or 50 ms; the cause is not known.
    by_path["paper"] = timed("paper", paper_path, dev, report)
    single = ("conv2d3x3", "conv2d3x3_bwd", "fused_enhance")
    path_kernels = {"main": single,
                    "lorenzo": single + ("lorenzo3d_fwd", "lorenzo3d_inv"),
                    "durable": single,
                    "batched": ("conv2d3x3", "conv2d3x3_grouped",
                                "conv2d3x3_grouped_bwd", "fused_enhance"),
                    "streaming": single,
                    "serve": single + ("lorenzo3d_inv",),
                    # cross-field (c_in = 2): a stacked pair and a single
                    "paper": ("conv2d3x3", "conv2d3x3_grouped",
                              "conv2d3x3_grouped_bwd", "fused_enhance"),
                    "lm": (),   # the LM has no Pallas kernel, so none here
                    # the lossy checkpoints' and the gradient archive's
                    "train": ("lorenzo3d_fwd", "lorenzo3d_inv"),
                    "dist": (),   # the quantize and all-reduce: PyTorch, NCCL
                    # the enhancer cell's real step on the card
                    "dryrun": ("conv2d3x3_grouped", "conv2d3x3_grouped_bwd")}
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
