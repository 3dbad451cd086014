#!/usr/bin/env python3
"""Device time of the conv backward and the Lorenzo inverse of one checkout,
for comparing two checkouts on one card in one call.

    python3 scripts/kernel_ab.py [--root DIR]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout) and times
it with this checkout's ``chip_smoke`` helpers, the same calls that
``chip_smoke.py`` times (``time_bwd``, ``time_lorenzo_inv``: device time
summed from a torch.profiler trace that holds exactly the kernels of the
calls, so host time between launches is not in it):

- ``conv2d3x3_bwd`` at the six conv shapes of one N=10 training step on
  512×512 slices, as the main path calls it (``path_needs_dx``), and
  their sum; where the path needs dx, the same call without dx too;
- ``lorenzo3d_inv`` on a stacked 3×100×500×500 int32 delta (random small
  codes: its time does not depend on their values).

Each time comes with its split by kernel name.  Prints one JSON line.  To
compare two checkouts (each with ``conv2d3x3.bwd_kernels_per_call``),
unpack the other one into a directory (``git archive``) and run this
script on both in turns, A, B, B, A, in one call: two calls may land on
different cards.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(ROOT))
    args = ap.parse_args()
    root = Path(args.root).resolve()

    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(root / "src"), str(ROOT)]
    import chip_smoke
    from repro_torch import device as device_lib
    from repro_torch.kernels import conv2d3x3 as conv
    from repro_torch.kernels import lorenzo3d as lz

    dev = device_lib.resolve("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {"root": str(root), "card": chip_smoke.nvidia_smi_line(),
           "conv2d3x3_bwd_ms": {}, "without_dx_ms": {}, "by_kernel": {}}
    for name, h, cin, cout, s, relu in chip_smoke.LAYERS_512:
        x = torch.randn((10, h, h, cin), generator=gen, device=dev)
        wt = torch.randn((3, 3, cin, cout), generator=gen, device=dev) * 0.3
        b = torch.randn((cout,), generator=gen, device=dev) * 0.1
        y = conv.conv2d3x3(x, wt, b, stride=s, relu=relu)
        g = torch.randn(tuple(y.shape), generator=gen, device=dev)
        need_dx = chip_smoke.path_needs_dx(name)
        split: dict[str, float] = {}
        out["conv2d3x3_bwd_ms"][name] = chip_smoke.time_bwd(
            conv, g, y, x, wt, stride=s, relu=relu, need_dx=need_dx,
            name=f"conv2d3x3_bwd {name}", by_name=split)[0]
        out["by_kernel"][name] = split
        if need_dx:
            out["without_dx_ms"][name] = chip_smoke.time_bwd(
                conv, g, y, x, wt, stride=s, relu=relu, need_dx=False,
                name=f"conv2d3x3_bwd {name} without dx")[0]
    out["conv2d3x3_bwd_sum_ms"] = sum(out["conv2d3x3_bwd_ms"].values())

    delta = torch.randint(-3, 4, (3, 100, 500, 500), generator=gen, device=dev,
                          dtype=torch.int32)
    eb = torch.tensor([1e-3, 2e-3, 5e-3], dtype=torch.float64, device=dev)
    split = {}
    out["lorenzo3d_inv_ms"] = chip_smoke.time_lorenzo_inv(lz, delta, eb,
                                                          by_name=split)
    out["by_kernel"]["lorenzo3d_inv"] = split
    print("kernel_ab", json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
