#!/usr/bin/env python3
"""How far does the summation order of the conv backward move what the
enhancer learns?

    python3 scripts/backward_quality_ab.py [--epochs 100] [--fields cloud,precip]
                                           [--shape 100,500,500]

Compresses fields of the synthetic Hurricane snapshot (100×500×500, seed
0, rel_eb 1e-3, strict, ``szlike``) on one CUDA GPU three times in one
process, changing only the backward of the enhancer's six convs:

- ``kernel``: the hand-written ``conv2d3x3_bwd`` kernels (the port's own);
- ``plain``: the plain-PyTorch nine-tap backward (cuBLAS), with the same
  kernel forward (``chip_smoke.plain_backward_conv3x3``);
- ``plain_f64``: the plain backward with its weight and bias gradients
  summed in float64 and rounded once to float32, a change of rounding
  only.

All three sum the same float32 terms; they differ in rounding, which 3,000
Adam steps carry forward.  Prints one JSON line per run and field
(enhanced PSNR, bit rate, outlier rate, final loss) and a summary; the
strict bound is checked on every decoded field.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def wgrad_f64(g, y, x, *, stride: int, relu: bool):
    """The plain wgrad summed in float64, rounded once to float32."""
    from repro_torch.kernels import conv2d3x3 as conv
    dw, db = conv.conv2d3x3_wgrad_plain(g.double(), y, x.double(),
                                        stride=stride, relu=relu)
    return dw.float(), db.float()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--fields", default="cloud,precip")
    ap.add_argument("--shape", default="100,500,500")
    args = ap.parse_args()
    shape = tuple(int(v) for v in args.shape.split(","))

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("backward_quality_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke
    import repro_torch
    from repro_torch import device as device_lib
    from repro_torch.core import metrics, regulation, skipping_dnn
    from repro_torch.data import fields as fields_lib

    names = args.fields.split(",")
    snap = fields_lib.make_fields("hurricane", shape, seed=0)
    snap = {k: snap[k] for k in names}
    kernel_conv = skipping_dnn.conv3x3
    variants = {"kernel": kernel_conv,
                "plain": chip_smoke.plain_backward_conv3x3(),
                "plain_f64": chip_smoke.plain_backward_conv3x3(wgrad_f64)}
    dev = device_lib.resolve("cuda")
    out = {"card": chip_smoke.nvidia_smi_line(), "shape": list(shape),
           "epochs": args.epochs, "fields": names, "runs": {}}
    try:
        for label, fn in variants.items():
            skipping_dnn.conv3x3 = fn
            t0 = time.perf_counter()
            arc = repro_torch.NeurLZ(epochs=args.epochs, device=dev).compress(
                snap, rel_eb=1e-3)
            dec = arc.decode_all()
            run = {"train_s": arc["timing"]["train_s"],
                   "compress_s": time.perf_counter() - t0}
            for name, x in snap.items():
                e = arc["fields"][name]
                chk = regulation.check_bound(x, dec[name], e["abs_eb"], "strict")
                if not chk["ok"]:
                    raise AssertionError(f"{label} {name}: bound broken")
                run[name] = {"psnr_enhanced": metrics.psnr(x, dec[name]),
                             "bitrate": arc.bitrate(name)["bitrate"],
                             "outlier_rate": e["outliers"]["count"] / x.size,
                             "final_loss": e["loss_history"][-1]}
                print(label, name, json.dumps(run[name]), flush=True)
            out["runs"][label] = run
    finally:
        skipping_dnn.conv3x3 = kernel_conv
    spread = {name: float(np.ptp([r[name]["psnr_enhanced"]
                                  for r in out["runs"].values()]))
              for name in names}
    out["psnr_spread_db"] = spread
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
