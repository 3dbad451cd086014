#!/usr/bin/env python3
"""The LM serving path's decode times of one checkout, for comparing two
checkouts on one card in one call.

    python3 scripts/lm_decode_ab.py [--root DIR]

Imports ``DIR/chip_smoke.py`` and ``repro_torch`` from ``DIR/src``
(default: this checkout) and serves the full-width bf16 qwen3-4b,
granite-moe-3b-a800m, zamba2-7b and xlstm-350m on the card with that
checkout's ``_lm_serve_full`` (batch 4, prompt 32, 32 greedy tokens, as
its lm path serves them).  Prints one JSON line: each model's decode ms a
step, device ms a step and kernels a step.
Decode is host-bound, so its time moves with the host's per-call overhead.
To compare two checkouts, unpack the other one into a directory
(``git archive``) and run this script on both in turns, A, B, B, A, in one
call: two calls may land on different hosts.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
MODELS = ("qwen3-4b", "granite-moe-3b-a800m", "zamba2-7b", "xlstm-350m")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(ROOT))
    args = ap.parse_args()
    root = Path(args.root).resolve()

    import torch
    if not torch.cuda.is_available():
        print("lm_decode_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root / "src"))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from repro_torch import configs
    from repro_torch import device as device_lib

    def check(ok: bool, what: str) -> None:
        if not ok:
            raise AssertionError(what)

    dev = device_lib.resolve("cuda")
    models = {}
    for arch in MODELS:
        r = smoke._lm_serve_full(dev, configs.get_config(arch), 0, check)
        smoke._lm_free()
        models[arch] = {k: r[k] for k in ("decode_ms_per_step",
                                          "device_ms_per_step",
                                          "device_kernels_per_step")}
    out = {"root": str(root), "card": smoke.nvidia_smi_line(), "models": models}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
