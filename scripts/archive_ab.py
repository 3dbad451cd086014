#!/usr/bin/env python3
"""The main path's archive and kernel launches of one checkout, for showing
that two checkouts write the same entries.

    python3 scripts/archive_ab.py [--root DIR]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout), builds
its kernels, and compresses the synthetic Hurricane snapshot (3×100×500×500
float32, seed 0) on the card as ``chip_smoke.py``'s main path does:
``NeurLZ(epochs=100).compress(fields, rel_eb=1e-3)``, strict, ``szlike``, no
telemetry and no faults.  Prints one JSON line: the SHA-256 of each
field's packed entry (the archive less its ``timing``), the kernel launch
counts, counted from 0 just before the compress, and the compress time.  Run it on a ``git archive`` of the other
checkout and on this one in the same call and compare the lines.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SHAPE = (100, 500, 500)     # chip_smoke.py's main path
EPOCHS = 100


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(ROOT))
    args = ap.parse_args()
    root = Path(args.root).resolve()

    import torch
    if not torch.cuda.is_available():
        print("archive_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root / "src"))
    import repro_torch
    from repro_torch import kernels
    from repro_torch.core import archive as arc_io
    from repro_torch.data import fields as fields_lib
    from repro_torch.kernels import _build

    _build.build()
    fields = fields_lib.make_fields("hurricane", SHAPE, seed=0)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    arc = repro_torch.NeurLZ(epochs=EPOCHS).compress(fields, rel_eb=1e-3)
    torch.cuda.synchronize()
    out = {"root": str(root), "package": repro_torch.__file__,
           "device": torch.cuda.get_device_name(0),
           "compress_s": time.perf_counter() - t0,
           "launches": kernels.launch_counts(),
           "entry_sha256": {n: hashlib.sha256(arc_io.dumps(e)).hexdigest()
                            for n, e in arc["fields"].items()},
           "bitrate": {n: b["bitrate"] for n, b in arc["bitrate"].items()}}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
