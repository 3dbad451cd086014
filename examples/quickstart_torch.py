"""NeurLZ quickstart on the PyTorch port: compress a scientific field with
online neural enhancement, decompress, verify the bound — via the port's
session API, on the card unless ``--device cpu``.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse
import os
import tempfile

import numpy as np

import repro_torch
from repro_torch.core import metrics
from repro_torch.data import fields


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    # 1. a synthetic cosmology block (stands in for a Nyx field)
    flds = fields.make_fields("nyx", shape=(32, 48, 48), seed=0)
    x = flds["dark_matter_density"]

    # 2. a compression session: strict 1e-3 value-range-relative bound, the
    #    enhancer trains online for 5 epochs during compression
    sess = repro_torch.NeurLZ(mode="strict", epochs=5, compressor="szlike",
                              device=args.device)
    archive = sess.compress({"dmd": x},
                            bounds=repro_torch.ErrorBound(rel=1e-3))

    # 3. round-trip through disk, then lazy random-access decode
    path = os.path.join(tempfile.gettempdir(), "quickstart_torch.nlz")
    archive.save(path)
    with repro_torch.Archive.open(path, device=sess.device) as arc:
        out = arc.decode("dmd")
        eb = arc.entry("dmd")["abs_eb"]
        br = arc.bitrate("dmd")["bitrate"]

    print(f"max |err|/eb : {np.abs(out.astype(np.float64) - x).max() / eb:.4f}  (must be <= 1)")
    print(f"PSNR         : {metrics.psnr(x, out):.2f} dB")
    print(f"bitrate      : {br:.3f} bits/value (fp32 raw = 32)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
