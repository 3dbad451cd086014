"""End-to-end NeurLZ driver on the PyTorch port (the paper's workload):
multi-field block, cross-field learning, per-field error bounds, strict
error regulation, archive on disk, full validation report — on the port's
session API (``repro_torch.NeurLZ`` / ``repro_torch.Archive``), on the card
unless ``--device cpu``.

    PYTHONPATH=src python examples/compress_field_torch.py [--dataset nyx]
        [--shape 32,48,48] [--eb 1e-3] [--epochs 8] [--mode strict]
        [--field-eb name=1e-2 --field-eb other=abs:0.5:relaxed]
        [--device cuda|cpu]

The options are ``examples/compress_field.py``'s, with its names and
defaults, but for ``--lowering``: the JAX lowering layer has no port (the
tensors' device picks the kernel or its plain version).  ``--device``
(default ``cuda``) raises where there is no card; it never falls back to
the CPU.  :func:`build_session` and :func:`run` are what
``scripts/paper_quality.py`` and ``chip_smoke.py`` call.
"""
import argparse
import os
import resource
import sys
import tempfile
import time

import numpy as np

import repro_torch
from repro_torch.compressors import registry
from repro_torch.core import metrics
from repro_torch.data import fields as F


def list_compressors() -> None:
    """Print the compressor registry (names, archive kinds, batching)."""
    print(f"{'name':18s} {'kind':10s} {'batchable':9s} {'dec_batch':9s}")
    for e in registry.entries():
        print(f"{e.name:18s} {e.kind:10s} "
              f"{str(e.compress_batched is not None):9s} "
              f"{str(e.decompress_batched is not None):9s}")


def parse_field_eb(spec: str) -> tuple[str, repro_torch.ErrorBound]:
    """``name=1e-2`` (relative) | ``name=abs:0.5`` | ``name=1e-3:relaxed``
    | ``name=abs:0.5:strict`` -> per-field ErrorBound."""
    name, _, rest = spec.partition("=")
    if not rest:
        raise argparse.ArgumentTypeError(f"bad --field-eb {spec!r}")
    parts = rest.split(":")
    kind = "rel"
    if parts[0] in ("rel", "abs"):
        kind = parts.pop(0)
    if not parts:
        raise argparse.ArgumentTypeError(
            f"bad --field-eb {spec!r}: missing bound value after {kind!r}")
    try:
        value = float(parts.pop(0))
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"bad --field-eb {spec!r}: bound value must be a number")
    mode = parts.pop(0) if parts else None
    return name, repro_torch.ErrorBound(rel=value if kind == "rel" else None,
                                        abs=value if kind == "abs" else None,
                                        mode=mode)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default="nyx",
                    choices=["nyx", "miranda", "hurricane"])
    ap.add_argument("--shape", default="32,48,48")
    ap.add_argument("--eb", type=float, default=1e-3,
                    help="default value-range-relative bound")
    ap.add_argument("--field-eb", action="append", default=[],
                    metavar="NAME=[rel:|abs:]VALUE[:MODE]",
                    help="per-field bound override (repeatable), e.g. "
                         "velocity_x=1e-2 or temperature=abs:0.5:relaxed")
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--mode", default="strict",
                    choices=["strict", "relaxed", "unregulated"])
    ap.add_argument("--compressor", default="szlike",
                    choices=registry.names(),
                    help="conventional stage (any registered compressor)")
    ap.add_argument("--list-compressors", action="store_true",
                    help="print the compressor registry and exit")
    ap.add_argument("--engine", default="batched",
                    choices=["serial", "batched", "streaming"],
                    help="batched = multi-field stacked engine; streaming = "
                         "bounded-memory pipeline + async archive writer "
                         "(both bit-identical to serial)")
    ap.add_argument("--max-resident-mb", type=float, default=0.0,
                    help="streaming engine residency budget in MiB "
                         "(0 = track peak only, no ceiling)")
    ap.add_argument("--decode-field", default=None,
                    help="also time a lazy single-field random-access "
                         "decode of this field (streaming archives)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="record telemetry and write a Chrome/Perfetto "
                         "trace_event JSON here (load it at ui.perfetto.dev);"
                         " PATH.jsonl gets the line-per-event log")
    ap.add_argument("--resume", action="store_true",
                    help="streaming engine: salvage a partial container at "
                         "--out left by a killed run (same config) and "
                         "compress only the remaining fields")
    ap.add_argument("--verify", action="store_true",
                    help="after compressing, re-read every entry through "
                         "the checksum path and report per-entry status")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap


def parse_bounds(args) -> dict:
    return dict(parse_field_eb(s) for s in args.field_eb)


def build_session(args, telemetry=None) -> repro_torch.NeurLZ:
    """The example's session: cross-field learning on (the dataset's
    ``DEFAULT_CROSS_FIELD``), the engine, compressor, residency budget and
    mode of ``args``, on ``args.device``."""
    cross = F.DEFAULT_CROSS_FIELD[args.dataset]
    return repro_torch.NeurLZ(
        model=repro_torch.ModelConfig(epochs=args.epochs, cross_field=cross),
        engine=repro_torch.EngineConfig(
            engine=args.engine, compressor=args.compressor,
            max_resident_bytes=int(args.max_resident_mb * 2**20),
            telemetry=telemetry),
        regulation=repro_torch.RegulationConfig(mode=args.mode),
        device=args.device)


def _sync(dev) -> None:
    if dev.type == "cuda":
        import torch
        torch.cuda.synchronize(dev)


def run(args, *, fields=None, init_params=None, batch_schedules=None,
        log=print) -> dict:
    """Compress, save, reopen from disk, decode and check, as ``main``
    prints it.  ``fields`` defaults to ``make_fields(args.dataset, shape,
    seed=0)``; ``init_params`` / ``batch_schedules`` (in-memory engines)
    fix each field's initial weights and batch order.  Returns the printed
    numbers: per field ``max_err_over_eb``, ``psnr_conv``,
    ``psnr_enhanced``, ``bitrate`` (with ``abs_eb``, ``mode``,
    ``conv_bitrate``, ``outliers``), and the archive's bytes, the stage
    times, the archive entries read back from disk and the decode."""
    shape = tuple(int(s) for s in args.shape.split(","))
    flds = (F.make_fields(args.dataset, shape=shape, seed=0)
            if fields is None else fields)
    bounds = parse_bounds(args)
    tel = repro_torch.Telemetry() if args.trace_out else None
    sess = build_session(args, tel)
    dev = sess.device
    log(f"[compress] {args.dataset} {shape} eb={args.eb} mode={args.mode} "
        f"epochs={args.epochs} cross_field=on engine={args.engine} "
        f"device={dev}"
        + (f" field_eb={ {n: (b.rel, b.abs, b.mode) for n, b in bounds.items()} }"
           if bounds else ""))
    path = args.out or os.path.join(
        tempfile.gettempdir(),
        f"{args.dataset}.nlzs" if args.engine == "streaming"
        else f"{args.dataset}.nlz")
    out: dict = {"dataset": args.dataset, "shape": list(shape),
                 "engine": args.engine, "epochs": args.epochs,
                 "device": str(dev), "path": path}
    t0 = time.perf_counter()
    if args.engine == "streaming":
        # Full out-of-core path: incremental container straight to disk,
        # reopened as a lazy Archive handle.
        if init_params or batch_schedules:
            raise ValueError("the streaming engine draws its own weights "
                             "and batches")
        arc = sess.compress_to(flds, path, bounds=bounds or None,
                               rel_eb=args.eb, resume=args.resume)
        _sync(dev)
        out["compress_s"] = time.perf_counter() - t0
        out["save_s"] = 0.0
        report = arc.report
        nbytes = report["bytes_written"]
        if args.resume:
            done = report["resumed_fields"]
            log(f"[resume]   salvaged {len(done)} field"
                f"{'s' if len(done) != 1 else ''} from the partial "
                f"container" + (f": {', '.join(done)}" if done else ""))
        log(f"[resident] pipeline peak {report['peak_resident_bytes']/2**20:.2f} MiB"
            + (f" (budget {args.max_resident_mb:.2f} MiB)"
               if args.max_resident_mb else " (no ceiling)")
            + f", writer busy {report['writer_busy_s']:.2f}s")
        if report["degraded_fields"]:
            log(f"[degraded] conv-only fallback (bound still honored): "
                f"{', '.join(report['degraded_fields'])}")
    else:
        arc = sess.compress(flds, bounds=bounds or None, rel_eb=args.eb,
                            init_params=init_params,
                            batch_schedules=batch_schedules)
        _sync(dev)
        out["compress_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        nbytes = arc.save(path)
        out["save_s"] = time.perf_counter() - t0
    out["archive_bytes"] = int(nbytes)
    if args.verify:
        rep = arc.verify()
        bad = {n: e for n, e in rep["entries"].items() if not e["ok"]}
        log(f"[verify]   {len(rep['entries'])} entries checksum-verified: "
            + ("all ok" if rep["ok"] else f"{len(bad)} FAILED {bad}"))
        assert rep["ok"], "container verification failed"
    timing = dict(arc["timing"])
    out["timing"] = timing
    cs = timing.get("conv_stage")
    if cs:
        log(f"[conv]     {cs['fields']} fields -> {cs['groups']} groups, "
            f"{cs['calls']} compressor calls "
            f"({cs['batched_fields']} batched / "
            f"{cs['fallback_fields']} per-field), {cs['conv_s']:.2f}s")
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    rss_b = rss if sys.platform == "darwin" else rss * 1024
    log(f"[archive]  {path}  ({nbytes/2**20:.2f} MiB on disk, "
        f"process peak RSS {rss_b/2**20:.0f} MiB)")

    # Decode from disk to prove the round-trip (lazy open for streaming).
    t0 = time.perf_counter()
    with repro_torch.Archive.open(path, device=dev) as arc_disk:
        if args.decode_field:
            t1 = time.perf_counter()
            one = arc_disk.decode(args.decode_field)
            t1 = time.perf_counter() - t1
            reads = (len(arc_disk.reader.entry_reads)
                     if arc_disk.streaming else len(flds))
            log(f"[random]   decode({args.decode_field!r}) {t1*1e3:.0f} ms, "
                f"{reads} entr{'y' if reads == 1 else 'ies'} read, "
                f"{one.nbytes/2**20:.2f} MiB out")
        dec = sess.decompress(arc_disk)
        _sync(dev)
        out["decode_s"] = time.perf_counter() - t0
        entries = {n: arc_disk.entry(n) for n in flds}
        br = arc_disk.bitrate()
    raw = sum(v.nbytes for v in flds.values())
    total = sum(br[n]["total_bytes"] for n in flds)
    out.update(raw_bytes=int(raw), total_bytes=float(total))
    log(f"[totals]   raw {raw/2**20:.1f} MiB -> {total/2**20:.2f} MiB "
        f"(CR {raw/total:.1f}x)")
    per_field = {}
    for name, x in flds.items():
        entry = entries[name]
        eb = entry["abs_eb"]
        mode = entry["mode"]
        err = float(np.abs(dec[name].astype(np.float64)
                           - x.astype(np.float64)).max())
        conv = registry.decompress(entry["conv"], device=dev)
        f = {"abs_eb": eb, "mode": mode, "max_err_over_eb": err / eb,
             "psnr_conv": metrics.psnr(x, conv),
             "psnr_enhanced": metrics.psnr(x, dec[name]),
             "bitrate": br[name]["bitrate"],
             "conv_bitrate": br[name]["conv_bitrate"],
             "outliers": int(entry["outliers"]["count"])
             if "outliers" in entry else 0}
        per_field[name] = f
        log(f"  {name:22s} [{mode:11s}] maxerr/eb={err/eb:6.3f}  "
            f"PSNR {f['psnr_conv']:6.2f} -> {f['psnr_enhanced']:6.2f} dB  "
            f"bitrate {f['bitrate']:6.3f} b/val")
        limit = eb if mode == "strict" else (
            2 * eb if mode == "relaxed" else np.inf)
        assert err <= limit * (1 + 1e-9), "bound violated!"
    log("[ok] all error bounds verified")
    out.update(fields=per_field, entries=entries, decoded=dec)

    if tel is not None:
        tel.export_chrome_trace(args.trace_out)
        tel.export_jsonl(args.trace_out + ".jsonl")
        s = tel.summary()
        top = sorted(s["spans"].items(), key=lambda kv: -kv[1]["wall_s"])[:6]
        log(f"[trace]    {args.trace_out} (+.jsonl): "
            f"{sum(a['count'] for _, a in top)} spans, top wall: "
            + ", ".join(f"{n} {a['wall_s']:.2f}s" for n, a in top))
    return out


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.list_compressors:
        list_compressors()
        return 0
    try:
        parse_bounds(args)
    except argparse.ArgumentTypeError as exc:
        ap.error(str(exc))
    if args.resume and args.engine != "streaming":
        ap.error("--resume requires --engine streaming (the incremental "
                 "container is what a killed run leaves behind)")
    run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
