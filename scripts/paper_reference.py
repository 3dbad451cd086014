#!/usr/bin/env python3
"""The JAX package's records of the paper's evaluation sets, which the port
is held against (``scripts/paper_quality.py``, ``chip_smoke.py``).  A tool
of the reference, not part of the port: it imports ``repro``.

    PYTHONPATH=src python scripts/paper_reference.py --set hurricane-cf-5
        [--out-dir DIR]

For the set (``scripts/paper_sets.SETS``) it makes the snapshot with
``repro.data.fields.make_fields(dataset, shape, seed=0)``, drawn under
``paper_sets.SNAPSHOT_NUMPY_ENV`` (``paper_sets.snapshot``: numpy's
vector loops for pow differ between hosts and numpy versions) and
compresses it, its payloads coded with ``paper_sets.CODEC`` (zlib: the
card's host has no ``zstandard``),
with ``repro.NeurLZ(engine="serial", lowering="eager", conv_batch=False,
epochs=E, seed=0, cross_field=DEFAULT_CROSS_FIELD[dataset],
mode="strict").compress(fields, rel_eb=1e-3)`` (the serial engine and eager
lowering are what the port is held against), then decodes the archive.  It
writes ``<set>.json`` (per field ``abs_eb``, ``stats``, SHA-256 of the
conventional payloads, ``loss_history``, PSNR of the conventional stage and
enhanced, bit rates, outliers) and ``<set>.npz``: each field's initial
parameters (``init_params`` at ``c_in = 1 +`` its aux count) and its
``[epochs, steps, batch]`` batch order (``epoch_batches``), as the
reference draws them.

The reference's compress takes no draws as input, so the script proves the
``.npz`` holds the run's own draws by capturing them from the run: it wraps
``skipping_dnn.init_params`` and the trainer's jitted epoch for the
duration of the compress, evaluates each call's batch order from the key
and sizes that call was given, and asserts both equal the ``.npz``'s
arrays exactly.

CPU time per set on an 8-core x86 host (Intel Xeon, AVX-512), the
five sets run at once, each pinned to its cores with
``taskset`` (``reference.make_s`` / ``compress_s`` / ``decode_s`` of
each record):

    set                (cores)  snapshot   compress   decode
    hurricane-cf-5     (1)        101.6 s   1,120.9 s  126.2 s
    hurricane-cf-100   (4)         75.0 s   5,880.6 s   44.1 s
    miranda-cf-5       (1)        144.2 s   1,449.6 s  168.1 s
    nyx-cf-5           (2)        512.9 s   3,458.6 s  402.0 s
    miranda-cf-smoke   (2)         26.6 s     390.0 s   31.0 s
"""
from __future__ import annotations

import argparse
import json
import os
import platform
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "scripts")]

import paper_sets  # noqa: E402


def draws(dataset: str, shape, epochs: int, seed: int = paper_sets.SEED):
    """What the reference's serial engine draws for each field of the
    snapshot: ``init_params(PRNGKey(seed), c_in = 1 + aux)`` and each
    epoch's ``epoch_batches(fold_in(key, e), n, steps, batch)`` over the
    slices of axis 0 (``TrainConfig``'s batch of 10)."""
    import jax
    from repro.core import online_trainer, skipping_dnn
    from repro.data import fields as F

    cross = F.DEFAULT_CROSS_FIELD[dataset]
    n = int(shape[0])
    batch = min(online_trainer.TrainConfig.batch, n)
    steps = max(1, n // batch)
    key = jax.random.PRNGKey(seed)
    sched = np.stack([np.asarray(online_trainer.epoch_batches(
        jax.random.fold_in(key, e), n, steps, batch), np.int32)
        for e in range(epochs)])
    params, scheds = {}, {}
    for name in F.DATASET_FIELDS[dataset]:
        c_in = 1 + len(cross.get(name, ()))
        params[name] = jax.tree.map(np.asarray, skipping_dnn.init_params(
            key, skipping_dnn.SkippingDNNConfig(c_in=c_in)))
        scheds[name] = sched
    return params, scheds


class _Capture:
    """Records the draws of the reference's training calls while active."""

    def __enter__(self):
        from repro.core import online_trainer, skipping_dnn
        self._tr, self._dnn = online_trainer, skipping_dnn
        self._epoch, self._init = online_trainer._train_epoch, skipping_dnn.init_params
        self.params, self.epochs = [], []

        def init(key, cfg):
            p = self._init(key, cfg)
            self.params.append(flat(p))
            return p

        def epoch(params, opt_state, inputs, targets, epoch_key, start_step,
                  **kw):
            self.epochs.append(np.asarray(online_trainer.epoch_batches(
                epoch_key, inputs.shape[0], kw["steps"], kw["batch"]),
                np.int32))
            return self._epoch(params, opt_state, inputs, targets, epoch_key,
                               start_step, **kw)

        def flat(p):
            import jax
            return paper_sets.flatten_params(jax.tree.map(np.asarray, p))

        skipping_dnn.init_params = init
        online_trainer._train_epoch = epoch
        return self

    def __exit__(self, *exc):
        self._tr._train_epoch = self._epoch
        self._dnn.init_params = self._init
        return False


def run(name: str, out_dir: Path) -> dict:
    import jax
    import repro
    from repro.compressors import registry
    from repro.core import archive as arc_io
    from repro.core import metrics
    from repro.data import fields as F

    spec = paper_sets.SETS[name]
    dataset = spec["dataset"]
    shape, epochs = tuple(spec["shape"]), spec["epochs"]
    cross = F.DEFAULT_CROSS_FIELD[dataset]

    os.environ["REPRO_CODEC"] = paper_sets.CODEC
    t = time.time()
    flds = paper_sets.snapshot(dataset, shape, package="repro")
    make_s = time.time() - t
    params, sched = draws(dataset, shape, epochs)

    sess = repro.NeurLZ(engine="serial", lowering="eager", conv_batch=False,
                        epochs=epochs, seed=paper_sets.SEED,
                        cross_field=cross, mode=paper_sets.MODE)
    t = time.time()
    with _Capture() as cap:
        arc = sess.compress(flds, rel_eb=paper_sets.REL_EB)
    compress_s = time.time() - t
    names = list(flds)
    # One init and ``epochs`` epochs per field, in field order.
    assert len(cap.params) == len(names), len(cap.params)
    assert len(cap.epochs) == len(names) * epochs, len(cap.epochs)
    for i, f in enumerate(names):
        want = paper_sets.flatten_params(params[f])
        assert sorted(cap.params[i]) == sorted(want), f
        for k, v in want.items():
            assert cap.params[i][k].tobytes() == v.tobytes(), (f, k)
        got = np.stack(cap.epochs[i * epochs:(i + 1) * epochs])
        assert np.array_equal(got, sched[f]), f

    t = time.time()
    dec = arc.decode_all()
    decode_s = time.time() - t

    out_fields = {}
    for f, x in flds.items():
        e = arc["fields"][f]
        eb = e["abs_eb"]
        conv = registry.decompress(e["conv"])
        br = arc.bitrate(f)
        err = float(np.abs(dec[f].astype(np.float64)
                           - x.astype(np.float64)).max())
        assert err <= eb, (f, err, eb)
        out_fields[f] = {
            "aux": list(e["aux"]),
            "mode": e["mode"],
            "abs_eb": eb,
            "stats": e["stats"],
            "payload_sha256": {k: paper_sets.sha256(e["conv"][k]["payload"])
                               for k in paper_sets.PAYLOAD_KEYS},
            "conv_sha256": paper_sets.sha256(arc_io.dumps(e["conv"])),
            "conv_mean": e["conv"]["mean"],
            "loss_history": [float(v) for v in e["loss_history"]],
            "psnr_conv": metrics.psnr(x, conv),
            "psnr_enhanced": metrics.psnr(x, dec[f]),
            "bitrate": br["bitrate"],
            "conv_bitrate": br["conv_bitrate"],
            "outliers": int(e["outliers"]["count"]),
            "max_err_over_eb": err / eb,
        }
    rec = {
        "set": name, "dataset": dataset, "shape": list(shape),
        "dtype": str(next(iter(flds.values())).dtype),
        "fields": out_fields, "epochs": epochs, "seed": paper_sets.SEED,
        "field_sha256": paper_sets.field_digests(flds),
        "codec": paper_sets.CODEC, "numpy_env": paper_sets.SNAPSHOT_NUMPY_ENV,
        "rel_eb": paper_sets.REL_EB, "mode": paper_sets.MODE,
        "cross_field": {k: list(v) for k, v in cross.items()},
        "reduced": spec["reduced"],
        "raw_bytes": int(sum(v.nbytes for v in flds.values())),
        "reference": {
            "call": ("repro.NeurLZ(engine='serial', lowering='eager', "
                     "conv_batch=False, epochs=E, seed=0, cross_field="
                     "DEFAULT_CROSS_FIELD[dataset], mode='strict')"
                     ".compress(fields, rel_eb=1e-3)"),
            "make_s": make_s, "compress_s": compress_s, "decode_s": decode_s,
            "cpus": len(os.sched_getaffinity(0)),
            "host": platform.machine(), "jax": jax.__version__,
            "numpy": np.__version__,
        },
    }
    out_dir.mkdir(parents=True, exist_ok=True)
    paper_sets.save_draws(out_dir / f"{name}.npz", params, sched)
    (out_dir / f"{name}.json").write_text(json.dumps(rec, indent=1) + "\n")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--set", required=True, choices=sorted(paper_sets.SETS))
    ap.add_argument("--out-dir", default=str(paper_sets.RECORDS))
    args = ap.parse_args(argv)
    rec = run(args.set, Path(args.out_dir))
    r = rec["reference"]
    print(f"[{args.set}] make {r['make_s']:.1f}s compress "
          f"{r['compress_s']:.1f}s decode {r['decode_s']:.1f}s "
          f"on {r['cpus']} cpus")
    for f, e in rec["fields"].items():
        print(f"  {f:22s} maxerr/eb={e['max_err_over_eb']:.3f} PSNR "
              f"{e['psnr_conv']:.3f} -> {e['psnr_enhanced']:.3f} dB "
              f"bitrate {e['bitrate']:.4f} b/val")
    return 0


if __name__ == "__main__":
    sys.exit(main())
