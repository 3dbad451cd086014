#!/usr/bin/env python3
"""The port on the card against the JAX package's record of one of the
paper's evaluation sets (``scripts/paper_sets.SETS``).

    python3 scripts/paper_quality.py --set hurricane-cf-5 [--out-dir DIR]
    PYTHONPATH=src python scripts/paper_quality.py --set S --conv-only --device cpu

On a machine with one CUDA GPU, one set a process (``nyx-cf-5`` takes
about 22 minutes on an H100, ``hurricane-cf-100`` 12):

    python3 scripts/paper_quality.py --set nyx-cf-5

It draws the set's snapshot (``repro_torch.data.fields.make_fields``, seed
0, through ``paper_sets.snapshot``; its SHA-256 must equal the record's)
and compresses it, payloads coded as the record's (zlib), through
``examples/compress_field_torch.py``'s ``build_session`` and ``run``: the
batched engine, cross-field learning, strict, rel_eb 1e-3, with each
field's initial weights and batch order carried across from the
reference's ``<set>.npz``; the archive is saved, opened from disk and
decoded.  Then it trains each field again with the two other rounding
variants of ``scripts/backward_quality_ab.py`` (the plain-PyTorch conv
backward, and the plain backward with its weight and bias gradients summed
in float64), on the first run's conventional reconstruction: only the
enhancer stage runs again, serially, as ``chip_smoke.main_path`` does.

Checks, each field of each variant (``paper_sets.verdict``):
(a) the strict bound; (b) the conventional payloads' SHA-256, ``abs_eb``
and the rest of the conventional header equal the reference's exactly, and
the normalization ``stats`` and the header's ``mean`` (float64 numpy sums,
which round otherwise under the card host's numpy) within
``paper_sets.STATS_TOL`` of the reference's standard deviation; (c) the
reference's enhanced PSNR within ``max(0.05 dB, spread)`` of the median of
the three variants, and each variant's PSNR within ``max(0.05 dB, spread
of the other two)`` of the reference's, so a variant far off cannot widen
its own bound; (d) the same for the bit rate, with a floor of 2% and the
spread taken relative to the median; (e) the kernel variant's first-epoch
loss within 1e-3 relative of the reference's.  Writes ``<set>.card.json``
(the ensemble with each variant's loss history, the checks, each variant's
tolerance, the card's name and power limit, compress and decode MB/s, stage
times, device peak, launches per kernel) and exits 1 if a check fails.

``--conv-only`` runs the conventional stage and the stats alone, a field at
a time, on any device with this host's numpy, and compares them with both
the record and the card's run: it shows whose numpy a stats gap follows.

Imports ``repro_torch``, the ported example and ``chip_smoke``'s plain
backward; nothing of the JAX package.
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

import paper_sets  # noqa: E402

def variant_convs() -> dict:
    """The enhancer's conv under each rounding variant of
    ``scripts/backward_quality_ab.py`` (None: the kernels)."""
    import chip_smoke
    from backward_quality_ab import wgrad_f64
    return {"kernel": None,
            "plain": chip_smoke.plain_backward_conv3x3(),
            "plain_f64": chip_smoke.plain_backward_conv3x3(wgrad_f64)}


def enhancer_variant(fields: dict, entries: dict, conv_fn, session, init,
                     sched, dev) -> dict:
    """Each field's enhancer stage again, serially, on the archived
    conventional reconstruction, with ``conv_fn`` as the enhancer's conv:
    per field PSNR, bit rate, bound and losses."""
    import torch
    from repro_torch.compressors import registry
    from repro_torch.core import metrics, neurlz, regulation, skipping_dnn

    cfg = session.config
    kernel_conv = skipping_dnn.conv3x3
    recs = {n: registry.decompress(e["conv"], device=dev)
            for n, e in entries.items()}
    t = {k: 0.0 for k in ("train_s", "predict_s", "enhance_s", "pack_s")}
    out = {}
    skipping_dnn.conv3x3 = conv_fn
    try:
        for name, x in fields.items():
            e0 = entries[name]
            aux_names = list(e0["aux"])
            aux = [recs[a] for a in aux_names]
            net_cfg = cfg.net_config(1 + len(aux_names))
            entry, history, _ = neurlz._enhance_field(
                x, recs[name], aux, aux_names, e0["abs_eb"], e0["conv"], cfg,
                net_cfg, init.get(name), sched.get(name), dev,
                neurlz.obs_lib.of(cfg), neurlz.faults_lib.of(cfg), True, t)
            dec = neurlz.decode_field_entry(entry, recs[name], aux, 0, dev)
            chk = regulation.check_bound(x, dec, entry["abs_eb"], "strict")
            br = neurlz.field_bitrate({"fields": {name: entry}}, name, x.size)
            out[name] = {"max_err_over_eb": chk["max_abs_err"] / entry["abs_eb"],
                         "bound_ok": bool(chk["ok"]),
                         "psnr_enhanced": metrics.psnr(x, dec),
                         "bitrate": br["bitrate"],
                         "outliers": int(entry["outliers"]["count"]),
                         "loss_first": float(history[0]),
                         "loss_last": float(history[-1]),
                         "loss_history": [float(v) for v in history]}
            del dec
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    finally:
        skipping_dnn.conv3x3 = kernel_conv
    out["timing"] = t
    return out


def conv_only(name: str, dev) -> dict:
    """(b) alone, a field at a time: the set's conventional stage (the
    port's ``ConvStage``) and each field's normalization stats on ``dev``
    with this host's numpy, against the record and against the card's run
    (``<set>.card.json``).  The stats and header means are numpy sums, so
    this shows whose numpy a gap between the card and the reference
    follows: on the card's host it reproduces the card's run, on the
    reference's the reference."""
    import numpy as np
    from repro_torch.core import archive as arc_io
    from repro_torch.core import conv_stage, online_trainer

    rec = paper_sets.load_record(name)
    card = paper_sets.load_card(name)
    os.environ["REPRO_CODEC"] = rec["codec"]
    flds = paper_sets.snapshot(rec["dataset"], rec["shape"], rec["seed"])
    if paper_sets.field_digests(flds) != rec["field_sha256"]:
        raise AssertionError(f"{name}: the snapshot differs from the record's")
    entries, stats = {}, {}
    for n in list(flds):
        (a, r), = conv_stage.ConvStage("szlike", rec["rel_eb"], device=dev).run(
            {n: flds.pop(n)}).values()
        stats[n] = online_trainer.normalize_stats(np.asarray(r))
        entries[n] = {"conv": a, "abs_eb": a["abs_eb"]}
        del r
    for n, e in entries.items():
        e["stats"] = [list(stats[n])] + [list(stats[x])
                                         for x in rec["fields"][n]["aux"]]
    port = paper_sets.port_exact(entries, rec, arc_io.dumps)
    out = {}
    for n, want in rec["fields"].items():
        out[n] = paper_sets.exact_check(port[n], want)
        out[n]["stats_equal_reference"] = port[n]["stats"] == want["stats"]
        out[n]["mean_equal_reference"] = port[n]["mean"] == want["conv_mean"]
        if card is not None:
            c = card["exact"][n]
            out[n]["stats_equal_card"] = port[n]["stats"] == c["stats"]
            out[n]["mean_equal_card"] = port[n]["mean"] == c["mean"]
    return out


def run_set(name: str, out_dir: Path, dev) -> dict:
    import torch
    import compress_field_torch as cft
    import chip_smoke
    from repro_torch import kernels
    from repro_torch.core import archive as arc_io

    rec = paper_sets.load_record(name)
    init, sched = paper_sets.load_draws(name)
    cuda = dev.type == "cuda"
    smi = chip_smoke.nvidia_smi_line() if cuda else "cpu"
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    os.environ["REPRO_CODEC"] = rec["codec"]
    t = time.perf_counter()
    flds = paper_sets.snapshot(rec["dataset"], rec["shape"], rec["seed"])
    make_s = time.perf_counter() - t
    if paper_sets.field_digests(flds) != rec["field_sha256"]:
        raise AssertionError(f"{name}: the snapshot differs from the record's")
    raw_mb = sum(x.nbytes for x in flds.values()) / 1e6
    print(f"data: {rec['dataset']} {rec['shape']} x {list(flds)} "
          f"{next(iter(flds.values())).dtype}, {raw_mb:.1f} MB, "
          f"{make_s:.1f} s to generate", flush=True)

    out_dir.mkdir(parents=True, exist_ok=True)
    argv = ["--dataset", rec["dataset"],
            "--shape", ",".join(str(s) for s in rec["shape"]),
            "--eb", repr(rec["rel_eb"]), "--epochs", str(rec["epochs"]),
            "--mode", rec["mode"], "--engine", "batched",
            "--out", str(out_dir / f"{name}.nlz"), "--device", str(dev)]
    args = cft.build_parser().parse_args(argv)
    session = cft.build_session(args)
    kernels.reset_launch_counts()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    res = cft.run(args, fields=flds, init_params=init, batch_schedules=sched)
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    entries = res["entries"]

    exact = paper_sets.port_exact(entries, rec, arc_io.dumps)
    runs = {"kernel": {n: {**f, "bound_ok": f["max_err_over_eb"] <= 1.0,
                           "loss_first": float(entries[n]["loss_history"][0]),
                           "loss_last": float(entries[n]["loss_history"][-1]),
                           "loss_history": [float(v) for v in
                                            entries[n]["loss_history"]]}
                       for n, f in res["fields"].items()}}
    del res["decoded"]
    variant_s = {}
    for label, fn in variant_convs().items():
        if fn is None:
            continue
        t = time.perf_counter()
        r = enhancer_variant(flds, entries, fn, session, init, sched, dev)
        variant_s[label] = {"total_s": time.perf_counter() - t, **r.pop("timing")}
        runs[label] = r
        for f, v in r.items():
            print(label, f, json.dumps({k: x for k, x in v.items()
                                        if k != "loss_history"}), flush=True)
    v = paper_sets.verdict(rec, exact, runs)

    card = {
        "set": name, "card": smi, "torch": torch.__version__,
        "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "dataset": rec["dataset"], "shape": list(rec["shape"]),
        "epochs": rec["epochs"], "engine": "batched", "ok": v["ok"],
        "make_s": make_s, "raw_MB": raw_mb,
        "compress_s": res["compress_s"], "save_s": res["save_s"],
        "decode_s": res["decode_s"],
        "compress_MB_per_s": raw_mb / res["compress_s"],
        "decode_MB_per_s": raw_mb / res["decode_s"],
        "archive_bytes": res["archive_bytes"], "stages": res["timing"],
        "device_peak_bytes": peak, "launches": launches,
        "variant_s": variant_s, "bounds_ok": v["bounds_ok"],
        "exact": v["exact"], "runs": runs, "checks": v["checks"],
        "reference": {f: {k: rec["fields"][f][k] for k in
                          ("psnr_conv", "psnr_enhanced", "bitrate",
                           "conv_bitrate", "outliers")}
                      | {"loss_first": rec["fields"][f]["loss_history"][0]}
                      for f in rec["fields"]},
        "tolerance": v["tolerance"],
    }
    print("paper_quality", json.dumps({k: card[k] for k in (
        "set", "ok", "compress_MB_per_s", "decode_MB_per_s", "compress_s",
        "decode_s", "device_peak_bytes", "launches", "variant_s")}))
    print_verdict(v)
    paper_sets.record_path(name, ".card.json").write_text(
        json.dumps(card, indent=1) + "\n")
    return card


def print_verdict(v: dict) -> None:
    """One line a field: (b) with its stats and mean gaps, (c) and (d) for
    the ensemble and each member's miss beside its own tolerance, (e)."""
    for f, c in v["checks"].items():
        ex = v["exact"][f]
        members = " ".join(
            f"{m}:{r['psnr_diff']:+.4f}/{r['psnr_tol']:.4f} dB,"
            f"{r['bitrate_diff_rel']:+.4f}/{r['bitrate_tol_rel']:.4f}"
            f"{'' if r['ok'] else ' MISS'}" for m, r in c["members"].items())
        print(f"  {f:22s} (b) {ex['ok']} (stats gap {ex['stats_gap']:.1e}, "
              f"mean gap {ex['mean_gap']:.1e} of sd)  "
              f"(c) ref {c['c']['ref']:.4f} median {c['c']['median']:.4f} "
              f"tol {c['c']['tol']:.4f} {c['c']['ok']}  "
              f"(d) ref {c['d']['ref']:.5f} median {c['d']['median']:.5f} "
              f"tol {c['d']['tol_rel']:.4f} {c['d']['ok']}  "
              f"members {members}  (e) rel {c['e']['rel']:.2e} {c['e']['ok']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--set", required=True, choices=sorted(paper_sets.SETS))
    ap.add_argument("--out-dir", default=str(ROOT / "build" / "paper_quality"),
                    help="where the archive is written")
    ap.add_argument("--conv-only", action="store_true",
                    help="check (b) alone, with this host's numpy, against "
                         "the record and the card's run")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card), or cpu "
                         "with --conv-only")
    args = ap.parse_args(argv)
    from repro_torch import device as device_lib
    dev = device_lib.resolve(args.device)
    if args.conv_only:
        exact = conv_only(args.set, dev)
        for f, e in exact.items():
            print(f, json.dumps(e))
        return 0 if all(e["ok"] for e in exact.values()) else 1
    if dev.type != "cuda":
        ap.error("the whole set runs on the card; --device cpu needs --conv-only")
    from repro_torch.kernels import _build
    _build.build()
    card = run_set(args.set, Path(args.out_dir), dev)
    print(f"[{args.set}] {'ok' if card['ok'] else 'FAILED'}")
    return 0 if card["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
