"""Archive serving + transcode walkthrough on the PyTorch port
(``repro_torch.serve``), on the card unless ``--device cpu``.

Compresses a synthetic snapshot to a streaming container, then drives a
:class:`repro_torch.ArchiveServer` against it: cold vs hot decode, a burst
of concurrent requests coalescing into one stacked dispatch, a ROI read,
and finally a :func:`repro_torch.transcode` to cheaper bounds — everything
under one shared residency ledger.

    PYTHONPATH=src python examples/serve_archive_torch.py
        [--shape 16,32,32] [--eb 1e-3] [--epochs 4]
        [--budget-mb 64] [--serve PATH] [--device cuda|cpu]

With ``--serve PATH`` the synthetic-compress step is skipped and the
given container is served instead.
"""
import argparse
import os
import tempfile
import time

import numpy as np

import repro_torch
from repro_torch.serve import ArchiveServer, transcode
from repro_torch.streaming import ResidencyLedger


def build_snapshot(path: str, shape, eb: float, epochs: int, device) -> dict:
    from repro_torch.data import fields as F
    flds = F.make_fields("nyx", shape=shape, seed=0)
    names = list(flds)
    nlz = repro_torch.NeurLZ(epochs=epochs, engine="streaming",
                             cross_field={names[0]: (names[1],)},
                             device=device)
    arc = nlz.compress_to(flds, path, rel_eb=eb)
    print(f"compressed {len(names)} fields -> {path} "
          f"({os.path.getsize(path)} bytes)")
    arc.close()
    return flds


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shape", default="16,32,32",
                    help="synthetic field shape (comma ints)")
    ap.add_argument("--eb", type=float, default=1e-3)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--budget-mb", type=int, default=64,
                    help="shared residency ceiling for cache + transcode")
    ap.add_argument("--serve", default=None, metavar="PATH",
                    help="serve this existing container instead of "
                         "compressing a synthetic snapshot")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    tmp = tempfile.mkdtemp(prefix="repro-torch-serve-")
    path = args.serve or os.path.join(tmp, "snapshot.nlzs")
    flds = None
    if args.serve is None:
        shape = tuple(int(s) for s in args.shape.split(","))
        flds = build_snapshot(path, shape, args.eb, args.epochs, args.device)

    tel = repro_torch.Telemetry()
    ledger = ResidencyLedger(args.budget_mb << 20, telemetry=tel)
    with repro_torch.Archive.open(path, device=args.device) as probe:
        names = list(probe.field_names)
        first = names[0]
        eb = probe.entry(first)["abs_eb"]
    with ArchiveServer(path, ledger=ledger, telemetry=tel,
                       device=args.device) as srv:

        t0 = time.perf_counter()
        x = srv.decode(first)
        cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        srv.decode(first)
        hot = time.perf_counter() - t0
        print(f"cold decode {first!r}: {cold * 1e3:.1f} ms   "
              f"hot (cached): {hot * 1e3:.2f} ms")
        if flds is not None:
            err = np.abs(x.astype(np.float64)
                         - flds[first].astype(np.float64)).max()
            print(f"served {first!r} max |err|/eb: {err / eb:.4f} "
                  "(must be <= 1)")
            assert err <= eb, "bound violated!"

        futs = [srv.submit(n) for n in names]       # concurrent burst
        for f in futs:
            f.result(60)
        st = srv.stats()
        print(f"burst of {len(names)} requests -> "
              f"{st['decode']['dispatches']} decode dispatches "
              f"(widest stacked: {st['decode']['max_width']})")

        roi = (slice(0, max(1, x.shape[0] // 2)),)
        slab = srv.decode(first, roi=roi)
        print(f"ROI {roi} -> shape {slab.shape} (full field {x.shape})")
        print(f"server stats: {st['counters']}, "
              f"resident {st['resident_bytes']} / {st['max_bytes']} B")

    cheap = os.path.join(tmp, "cheap.nlzs")
    out = transcode(path, cheap, rel_eb=args.eb * 10,
                    config=repro_torch.NeurLZConfig(engine="streaming",
                                                    epochs=args.epochs),
                    ledger=ledger, telemetry=tel, device=args.device)
    r1 = os.path.getsize(path)
    r2 = os.path.getsize(cheap)
    print(f"transcode to {args.eb * 10:g} rel bound: {r1} -> {r2} bytes "
          f"({r1 / max(r2, 1):.2f}x smaller), peak resident "
          f"{out.report['peak_resident_bytes']} B under the same ledger")
    out.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
