"""The paper's evaluation sets, their reference records and the tolerance
rule that holds the port against them.  numpy and the standard library
only: ``scripts/paper_reference.py`` (the JAX package), and
``scripts/paper_quality.py`` and ``chip_smoke.py`` (the port) import it.

A set is one synthetic snapshot of ``repro.data.fields`` at SDRBench's
published size of its dataset (or a listed cut of it), compressed at
``rel_eb`` 1e-3, strict, with cross-field learning as
``DEFAULT_CROSS_FIELD`` has it, from seed 0.  Its files in
``scripts/paper_reference/``:

- ``<set>.json``: the JAX package's run (per field ``abs_eb``, ``stats``,
  the conventional payloads' SHA-256, ``loss_history``, PSNR of the
  conventional stage and enhanced, bit rates, outliers);
- ``<set>.npz``: that run's own draws, carried across to the port: each
  field's initial parameters (``params/<field>/<layer>/<w|b>``) and its
  ``[epochs, steps, batch]`` batch order (``sched/<field>``);
- ``<set>.card.json``: the port's ensemble on the card
  (``scripts/paper_quality.py``).
"""
from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

RECORDS = Path(__file__).resolve().parent / "paper_reference"

REL_EB, SEED, MODE = 1e-3, 0, "strict"

# SDRBench's published sizes: Hurricane ISABEL 100×500×500, Miranda
# 256×384×384, Nyx 512³.  ``reduced`` lists every cut of that size.
SETS = {
    "hurricane-cf-5": {"dataset": "hurricane", "shape": (100, 500, 500),
                       "epochs": 5, "reduced": []},
    "hurricane-cf-100": {"dataset": "hurricane", "shape": (100, 500, 500),
                         "epochs": 100, "reduced": []},
    "miranda-cf-5": {"dataset": "miranda", "shape": (256, 384, 384),
                     "epochs": 5, "reduced": []},
    "nyx-cf-5": {"dataset": "nyx", "shape": (512, 512, 512),
                 "epochs": 5, "reduced": []},
    "miranda-cf-smoke": {"dataset": "miranda", "shape": (32, 384, 384),
                         "epochs": 5,
                         "reduced": ["depth 256 -> 32 (chip_smoke.py's "
                                     "time limit); widths as published"]},
}

# The tolerance floors: test_main_path_matches_reference's at 9×20×24.
PSNR_FLOOR_DB = 0.05
BITRATE_FLOOR_REL = 0.02
LOSS_RTOL = 1e-3
# (b)'s bound on the normalization stats and the header mean, relative to
# the standard deviation: numpy's float64 mean of n values rounds by at
# most about log2(n) units in the last place of the values' magnitude, and
# numpy sums in another order on another version or host (the card's host
# runs 2.3, the reference's 2.0).  The five sets' gaps read at most 1.2e-14
# (miranda-cf-5's stats) and 4.3e-15 (its header means); a float32 step of
# the data is 6e-8 of a value.
STATS_TOL = 1e-12
PAYLOAD_KEYS = ("codes", "unpred", "literals")

# The byte codec of both packages' payloads ($REPRO_CODEC): the card's
# host has no ``zstandard``, so the records are made with zlib too.
CODEC = "zlib"
# ``make_fields`` is not a function of its arguments alone: numpy picks its
# pow / exp / log loops by the host's SIMD features and its version (2.0.2
# with AVX-512 takes SVML's pow, 2.3.5 another), and its float sums block by
# the ufunc buffer, which numpy 2.3 sets up anew, so ``_grf``'s ``mean`` and
# ``std`` round otherwise on another host.  The snapshot is drawn with
# numpy's dispatch held to its x86-64 baseline (SSE3: libm's pow, exp and
# log on both hosts; features a host lacks are ignored) and with ``_grf``'s
# two reductions taken exactly (``math.fsum``, ``_EXACT_GRF``).
SNAPSHOT_NUMPY_ENV = {"NPY_DISABLE_CPU_FEATURES": " ".join((
    "SSSE3", "SSE41", "POPCNT", "SSE42", "AVX", "F16C", "FMA3", "AVX2",
    "AVX512F", "AVX512CD", "AVX512_KNL", "AVX512_KNM", "AVX512_SKX",
    "AVX512_CLX", "AVX512_CNL", "AVX512_ICL", "AVX512_SPR"))}

# ``fields._grf`` with its mean and standard deviation summed exactly; every
# other step is the module's own.
_EXACT_GRF = """
import math
def _grf(rng, shape, slope, aniso=None):
    kfreqs = [np.fft.fftfreq(n) * n for n in shape]
    grids = np.meshgrid(*kfreqs, indexing="ij")
    if aniso:
        grids = [g * a for g, a in zip(grids, aniso)]
    k2 = sum(g ** 2 for g in grids)
    k2[(0,) * len(shape)] = 1.0
    amp = k2 ** (-slope / 4.0)
    amp[(0,) * len(shape)] = 0.0
    noise = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    f = np.fft.ifftn(np.fft.fftn(noise) * amp).real
    f -= math.fsum(f.flat) / f.size
    d = f - math.fsum(f.flat) / f.size
    sd = math.sqrt(math.fsum((d * d).flat) / f.size)
    return f / (sd if sd > 0 else 1.0)
"""


def record_path(name: str, suffix: str = ".json", root=None) -> Path:
    return Path(root or RECORDS) / f"{name}{suffix}"


def load_record(name: str, root=None) -> dict:
    """The reference's record of set ``name``."""
    path = record_path(name, root=root)
    rec = json.loads(path.read_text())
    if rec["set"] != name:
        raise ValueError(f"{path} holds set {rec['set']!r}")
    rec["shape"] = tuple(rec["shape"])
    return rec


def load_card(name: str, root=None) -> dict | None:
    """The port's ensemble of set ``name`` on the card, if recorded."""
    p = record_path(name, ".card.json", root)
    return json.loads(p.read_text()) if p.exists() else None


def sha256(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def field_digests(fields: dict) -> dict[str, str]:
    return {n: sha256(np.ascontiguousarray(x).tobytes())
            for n, x in fields.items()}


def snapshot(dataset: str, shape, seed: int = SEED,
             package: str = "repro_torch") -> dict[str, np.ndarray]:
    """``<package>.data.fields.make_fields(dataset, shape, seed)`` in a child
    process whose numpy runs under ``SNAPSHOT_NUMPY_ENV``, with the module's
    ``_grf`` summing exactly (``_EXACT_GRF``), so that two numpy builds on
    two hosts draw one snapshot (``package`` is ``repro``, the JAX package,
    on the reference's side; the module is numpy only and loads from its
    file, without its package).  The records carry the fields' SHA-256
    (``field_digests``) to prove it."""
    path = Path(__file__).resolve().parent.parent / "src" / package / "data" / "fields.py"
    with tempfile.TemporaryDirectory() as tmp:
        code = ("import importlib.util, numpy as np\n"
                f"spec = importlib.util.spec_from_file_location('fields', {str(path)!r})\n"
                "F = importlib.util.module_from_spec(spec)\n"
                "spec.loader.exec_module(F)\n"
                f"exec({_EXACT_GRF!r}, F.__dict__)\n"
                f"f = F.make_fields({dataset!r}, {tuple(shape)!r}, seed={seed})\n"
                "for n, x in f.items():\n"
                f"    np.save({tmp!r} + '/' + n + '.npy', x)\n"
                f"open({tmp!r} + '/order', 'w').write('\\n'.join(f))\n")
        subprocess.run([sys.executable, "-c", code], check=True,
                       env=dict(os.environ, **SNAPSHOT_NUMPY_ENV))
        names = Path(tmp, "order").read_text().split("\n")
        return {n: np.load(Path(tmp, f"{n}.npy")) for n in names}


def flatten_params(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten_params(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def unflatten_params(flat: dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        *heads, leaf = path.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[leaf] = v
    return tree


def save_draws(path, params: dict, sched: dict) -> None:
    """``params``: field -> parameter tree; ``sched``: field -> int array
    ``[epochs, steps, batch]``."""
    arrays = {}
    for name, tree in params.items():
        for k, v in flatten_params(tree).items():
            arrays[f"params/{name}/{k}"] = v
    for name, s in sched.items():
        arrays[f"sched/{name}"] = np.asarray(s, np.int32)
    np.savez_compressed(path, **arrays)


def load_draws(name: str, root=None) -> tuple[dict, dict]:
    """``(init_params, batch_schedules)`` of set ``name`` as the port's
    ``compress`` takes them: field -> tree of numpy arrays, field ->
    ``[epochs, steps, batch]``."""
    path = record_path(name, ".npz", root)
    params: dict = {}
    sched: dict = {}
    with np.load(path) as z:
        for key in z.files:
            kind, field, *rest = key.split("/")
            if kind == "params":
                params.setdefault(field, {})["/".join(rest)] = z[key]
            elif kind == "sched":
                sched[field] = z[key]
    return {f: unflatten_params(p) for f, p in params.items()}, sched


def tolerance(values, floor: float) -> float:
    """``max(floor, spread)``: the spread (max - min) of an ensemble that
    differs only in rounding, never below the floor."""
    v = np.asarray(values, np.float64)
    return float(max(floor, v.max() - v.min()))


def psnr_check(ref: float, ensemble) -> dict:
    """(c): the reference's enhanced PSNR within ``max(0.05 dB, spread)``
    of the ensemble's median."""
    med = float(np.median(np.asarray(ensemble, np.float64)))
    tol = tolerance(ensemble, PSNR_FLOOR_DB)
    return {"ref": float(ref), "median": med, "tol": tol,
            "diff": float(ref) - med, "ok": abs(float(ref) - med) <= tol}


def bitrate_tolerance(ensemble) -> float:
    """``max(2%, spread / median)`` of an ensemble of bit rates."""
    v = np.asarray(ensemble, np.float64)
    return float(max(BITRATE_FLOOR_REL, (v.max() - v.min()) / np.median(v)))


def bitrate_check(ref: float, ensemble) -> dict:
    """(d): the reference's bit rate within ``max(2%, spread)`` of the
    ensemble's median, the spread taken relative to the median."""
    med = float(np.median(np.asarray(ensemble, np.float64)))
    tol = bitrate_tolerance(ensemble)
    rel = (float(ref) - med) / med
    return {"ref": float(ref), "median": med, "tol_rel": tol,
            "diff_rel": rel, "ok": abs(rel) <= tol}


def within(ref_psnr: float, ref_bitrate: float, psnr: float,
           bitrate: float, psnr_tol: float, bitrate_tol_rel: float) -> dict:
    """A run's PSNR within ``psnr_tol`` dB and its bit rate within
    ``bitrate_tol_rel`` (relative) of a reference's."""
    diff = float(psnr) - float(ref_psnr)
    rel = (float(bitrate) - float(ref_bitrate)) / float(ref_bitrate)
    return {"psnr_diff": diff, "psnr_tol": float(psnr_tol),
            "bitrate_diff_rel": rel, "bitrate_tol_rel": float(bitrate_tol_rel),
            "ok": abs(diff) <= psnr_tol and abs(rel) <= bitrate_tol_rel}


def member_check(ref_psnr: float, ref_bitrate: float, psnr: float,
                 bitrate: float, others_psnr, others_bitrate) -> dict:
    """(c) and (d) for one member of the ensemble, its tolerance taken from
    the other members only, so that a member far from the reference cannot
    widen its own bound: its PSNR within ``max(0.05 dB, spread of the
    others)`` of the reference's, its bit rate within ``max(2%, spread of
    the others / their median)``."""
    return within(ref_psnr, ref_bitrate, psnr, bitrate,
                  tolerance(others_psnr, PSNR_FLOOR_DB),
                  bitrate_tolerance(others_bitrate))


def loss_check(ref_first: float, port_first: float) -> dict:
    """(e): the first epoch's loss within 1e-3 relative."""
    rel = abs(float(port_first) - float(ref_first)) / abs(float(ref_first))
    return {"ref": float(ref_first), "port": float(port_first),
            "rel": rel, "ok": rel <= LOSS_RTOL}


def exact_check(port: dict, want: dict) -> dict:
    """(b) for one field: ``port`` holds whether the conventional payloads,
    ``abs_eb`` and the conventional header (with the reference's ``mean``
    in place of the port's) equal the reference's (``payloads``,
    ``abs_eb``, ``header``), and the port's normalization ``stats`` and
    header ``mean``.  Those two are float64 means and deviations that both
    packages take with numpy; they must lie within ``STATS_TOL`` of the
    reference's, each relative to the reference's standard deviation of the
    same channel (the mean to the field's)."""
    got = np.asarray(port["stats"], np.float64)
    ref = np.asarray(want["stats"], np.float64)
    stats_gap = float((np.abs(got - ref) / ref[:, 1:2]).max())
    mean_gap = abs(float(port["mean"]) - float(want["conv_mean"])) / float(ref[0, 1])
    out = {k: bool(port[k]) for k in ("payloads", "abs_eb", "header")}
    out.update(stats=port["stats"], mean=float(port["mean"]),
               stats_gap=stats_gap, mean_gap=mean_gap)
    out["ok"] = (all(out[k] for k in ("payloads", "abs_eb", "header"))
                 and stats_gap <= STATS_TOL and mean_gap <= STATS_TOL)
    return out


def verdict(rec: dict, exact: dict, runs: dict) -> dict:
    """Every check of one set: (a) bounds, (b) ``exact_check`` per field
    (``exact``: field -> its ``port`` dict), and per field over ``runs``
    (variant -> field -> numbers, ``kernel`` first) (c) and (d) for the
    ensemble as a whole and for each member on the others' spread, and (e)
    the kernel member's first loss.  Returns ``{"ok", "bounds_ok", "exact",
    "checks", "tolerance"}``; ``tolerance`` is each member's own, taken
    from the others."""
    bounds_ok = all(runs[v][f]["max_err_over_eb"] <= 1.0
                    for v in runs for f in rec["fields"])
    ex = {f: exact_check(exact[f], want) for f, want in rec["fields"].items()}
    checks, tol = {}, {}
    for name, want in rec["fields"].items():
        psnr = {v: runs[v][name]["psnr_enhanced"] for v in runs}
        rate = {v: runs[v][name]["bitrate"] for v in runs}
        members = {v: member_check(
            want["psnr_enhanced"], want["bitrate"], psnr[v], rate[v],
            [psnr[o] for o in runs if o != v], [rate[o] for o in runs if o != v])
            for v in runs}
        checks[name] = {
            "c": psnr_check(want["psnr_enhanced"], list(psnr.values())),
            "d": bitrate_check(want["bitrate"], list(rate.values())),
            "members": members,
            "e": loss_check(want["loss_history"][0],
                            runs["kernel"][name]["loss_first"])}
        tol[name] = {v: {"psnr_db": m["psnr_tol"],
                         "bitrate_rel": m["bitrate_tol_rel"]}
                     for v, m in members.items()}
    ok = (bounds_ok and all(e["ok"] for e in ex.values()) and all(
        c["c"]["ok"] and c["d"]["ok"] and c["e"]["ok"]
        and all(m["ok"] for m in c["members"].values())
        for c in checks.values()))
    return {"ok": ok, "bounds_ok": bounds_ok, "exact": ex, "checks": checks,
            "tolerance": tol}


def port_exact(entries: dict, rec: dict, dumps) -> dict:
    """Each field's ``port`` dict for ``exact_check`` from the port's
    archive entries: payload digests, ``abs_eb`` and the conventional
    header hashed by ``dumps`` (the port's archive serializer) with the
    reference's ``mean`` in place of the port's, beside the port's
    ``stats`` and ``mean``."""
    out = {}
    for name, want in rec["fields"].items():
        e = entries[name]
        header = {**e["conv"], "mean": want["conv_mean"]}
        out[name] = {
            "payloads": {k: sha256(e["conv"][k]["payload"])
                         for k in PAYLOAD_KEYS} == want["payload_sha256"],
            "abs_eb": e["abs_eb"] == want["abs_eb"],
            "header": sha256(dumps(header)) == want["conv_sha256"],
            "stats": json.loads(json.dumps(e["stats"])),
            "mean": e["conv"]["mean"]}
    return out
