#!/usr/bin/env python3
"""How far rounding alone moves one field's enhanced result over a paper
set's epochs on the card (``scripts/paper_sets.SETS``).

    python3 scripts/rounding_spread.py --set hurricane-cf-100 --field precip \
        [--nudges 4] [--out FILE]

It runs the set's conventional stage for the field and its aux fields,
then the field's enhancer stage serially with the kernels
(``paper_quality.enhancer_variant``), from the reference's initial weights
and batch order (``<set>.npz``) and again ``--nudges`` times from the same
weights each moved by one unit in the last place, up or down by a seeded
draw a weight.  For every run it prints the enhanced PSNR, the bit rate
and the first epoch at which its loss parts from the reference's record by
more than 1e-3 and 1e-2 relative, beside the reference and the variants of
the set's ``.card.json``; ``--out`` gets the loss histories too.  Imports
``repro_torch``, the ported example and ``paper_quality``; nothing of the
JAX package.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "examples"), str(ROOT),
                str(ROOT / "scripts")]

import numpy as np  # noqa: E402

import paper_sets  # noqa: E402


def nudged(tree: dict, seed: int) -> dict:
    """Every float of ``tree`` moved one unit in the last place, its
    direction drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = nudged(v, rng.integers(1 << 31))
        else:
            toward = np.where(rng.random(v.shape) < 0.5, -np.inf, np.inf)
            out[k] = np.nextafter(v, toward.astype(v.dtype)).astype(v.dtype)
    return out


def parted_at(history, ref, rtol: float) -> int | None:
    """The first epoch (1-based) whose loss parts from ``ref`` by more than
    ``rtol`` relative; None if none does."""
    for i, (a, b) in enumerate(zip(history, ref)):
        if abs(a - b) > rtol * abs(b):
            return i + 1
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--set", required=True, choices=sorted(paper_sets.SETS))
    ap.add_argument("--field", required=True)
    ap.add_argument("--nudges", type=int, default=4)
    ap.add_argument("--out", default=str(ROOT / "build" / "rounding_spread.json"))
    args = ap.parse_args(argv)

    import torch
    import chip_smoke
    import compress_field_torch as cft
    import paper_quality
    from repro_torch import device as device_lib
    from repro_torch.core import conv_stage, skipping_dnn
    from repro_torch.kernels import _build

    dev = device_lib.resolve("cuda")
    _build.build()
    smi = chip_smoke.nvidia_smi_line()
    rec = paper_sets.load_record(args.set)
    card = paper_sets.load_card(args.set)
    init, sched = paper_sets.load_draws(args.set)
    want = rec["fields"][args.field]
    names = [args.field] + list(want["aux"])
    os.environ["REPRO_CODEC"] = rec["codec"]
    flds = paper_sets.snapshot(rec["dataset"], rec["shape"], rec["seed"])
    if paper_sets.field_digests(flds) != rec["field_sha256"]:
        raise AssertionError(f"{args.set}: the snapshot differs from the record's")
    conv = conv_stage.ConvStage("szlike", rec["rel_eb"], device=dev).run(
        {n: flds[n] for n in names})
    entries = {n: {"conv": a, "abs_eb": a["abs_eb"],
                   "aux": list(rec["fields"][n]["aux"])}
               for n, (a, _) in conv.items()}
    del conv
    for n in names:
        got = {k: paper_sets.sha256(entries[n]["conv"][k]["payload"])
               for k in paper_sets.PAYLOAD_KEYS}
        if got != rec["fields"][n]["payload_sha256"]:
            raise AssertionError(f"{n}: conventional payloads differ from the record's")
    session = cft.build_session(cft.build_parser().parse_args([
        "--dataset", rec["dataset"],
        "--shape", ",".join(str(s) for s in rec["shape"]),
        "--eb", repr(rec["rel_eb"]), "--epochs", str(rec["epochs"]),
        "--mode", rec["mode"], "--device", str(dev)]))

    runs = {}
    starts = {"kernel": init[args.field]}
    starts.update({f"kernel_ulp{i}": nudged(init[args.field], i)
                   for i in range(1, args.nudges + 1)})
    for label, start in starts.items():
        t = time.perf_counter()
        r = paper_quality.enhancer_variant(
            {args.field: flds[args.field]}, entries, skipping_dnn.conv3x3,
            session, {args.field: start}, sched, dev)
        f = r[args.field]
        f["seconds"] = time.perf_counter() - t
        f["parted_1e-3"] = parted_at(f["loss_history"], want["loss_history"], 1e-3)
        f["parted_1e-2"] = parted_at(f["loss_history"], want["loss_history"], 1e-2)
        runs[label] = f
        print(label, json.dumps({k: v for k, v in f.items()
                                 if k != "loss_history"}), flush=True)
        torch.cuda.empty_cache()

    psnr = [f["psnr_enhanced"] for f in runs.values()]
    summary = {
        "set": args.set, "field": args.field, "card": smi,
        "epochs": rec["epochs"], "reference_psnr": want["psnr_enhanced"],
        "reference_bitrate": want["bitrate"],
        "card_variants_psnr": ({v: card["runs"][v][args.field]["psnr_enhanced"]
                                for v in card["runs"]} if card else None),
        "runs_psnr": dict(zip(runs, psnr)),
        "runs_bitrate": {k: f["bitrate"] for k, f in runs.items()},
        "runs_parted_1e-3": {k: f["parted_1e-3"] for k, f in runs.items()},
        "runs_spread_db": max(psnr) - min(psnr),
    }
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({**summary, "runs": runs,
                               "reference_loss_history": want["loss_history"]},
                              indent=1) + "\n")
    print("rounding_spread", json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
