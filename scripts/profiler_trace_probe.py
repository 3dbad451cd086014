#!/usr/bin/env python3
"""How often does a short torch.profiler trace lose its device activity?

    python3 scripts/profiler_trace_probe.py [--out FILE]

Traces four small workloads on one CUDA GPU 150 times each, the way
``chip_smoke.device_ms`` does (20 back-to-back calls inside one
``torch.profiler.profile``), in two variants taken in turn:

- ``bare``: the calls, then ``torch.cuda.synchronize()``, as the trace's
  whole window;
- ``padded``: the same with a host pause of 5 ms before the first
  call and after the synchronize, so the trace's window reaches well past
  the device work on both sides.

For every trace it counts the device activities and the kernels of the
workload, and for a full trace it records the offset of the first device
activity from the first launch on the host (the clock skew between the
two, with the launch latency).  A trace whose device activities fall
outside its window holds fewer kernels than were launched, or none.
Prints one JSON summary; details go to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ROUNDS, ITERS, PAD_S = 150, 20, 0.005


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "build" / "profiler_trace_probe.json"))
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("profiler_trace_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import conv2d3x3 as conv

    dev = torch.device("cuda")
    cuda_type = torch.autograd.DeviceType.CUDA
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((10, 64, 64, 6), generator=gen).to(dev)
    w = torch.randn((3, 3, 6, 8), generator=gen).to(dev)
    b = torch.randn((8,), generator=gen).to(dev)
    xl = x.permute(0, 3, 1, 2)
    wl = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    small = torch.randn(1024, device=dev)
    big = torch.randn(1 << 24, device=dev)
    work = {   # name: (call, the kernel name to count, kernels per call)
        "conv2d3x3_down4_N10": (lambda: conv.conv2d3x3(x, w, b, stride=2),
                                "conv3x3_kernel", 1),
        "cudnn_down4_N10": (lambda: F.conv2d(xl, wl, b, stride=2), None, None),
        "add_1k": (lambda: small + 1.0, None, 1),
        "add_16M": (lambda: big + 1.0, None, 1),
    }

    def trace(fn, pad_s):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            if pad_s:
                time.sleep(pad_s)
            for _ in range(ITERS):
                fn()
            torch.cuda.synchronize()
            if pad_s:
                time.sleep(pad_s)
        events = prof.events()
        on_dev = [e for e in events if e.device_type == cuda_type]
        launches = [e for e in events if e.device_type != cuda_type
                    and "LaunchKernel" in e.name]
        skew = None
        if on_dev and launches:
            skew = (min(e.time_range.start for e in on_dev)
                    - min(e.time_range.start for e in launches))
        return on_dev, len(launches), skew

    for fn, _, _ in work.values():   # warm-up, outside any trace
        for _ in range(3):
            fn()
    rows, first = [], None
    for r in range(ROUNDS):
        for name, (fn, kname, per_call) in work.items():
            for variant, pad_s in (("bare", 0.0), ("padded", PAD_S)):
                on_dev, n_launch, skew = trace(fn, pad_s)
                seen = (sum(kname in e.name for e in on_dev) if kname
                        else len(on_dev))
                row = {"round": r, "work": name, "variant": variant,
                       "device_events": len(on_dev), "seen": seen,
                       "host_launches": n_launch, "skew_us": skew,
                       "full": (seen == ITERS * per_call if per_call
                                else seen > 0 and seen % ITERS == 0)}
                if first is None:
                    first = row
                rows.append(row)
    summary = {}
    for name in work:
        for variant in ("bare", "padded"):
            sel = [r for r in rows if r["work"] == name and r["variant"] == variant]
            skews = sorted(r["skew_us"] for r in sel if r["skew_us"] is not None)
            summary[f"{name}/{variant}"] = {
                "traces": len(sel),
                "empty": sum(r["device_events"] == 0 for r in sel),
                "not_full": sum(not r["full"] for r in sel),
                "skew_us_min_median_max": ([skews[0], skews[len(skews) // 2],
                                            skews[-1]] if skews else None)}
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"summary": summary, "first_trace": first,
                               "rows": rows}))
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "card": torch.cuda.get_device_name(0),
                      "first_trace": first, "summary": summary}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
