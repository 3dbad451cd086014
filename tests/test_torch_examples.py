"""The ported examples (``examples/*_torch.py``) run with ``--device cpu``
and print their bound lines; ``compress_field_torch`` on each engine and
with ``--verify``, ``--resume`` and ``--list-compressors``, and never on
the CPU unasked.  The records of the paper's evaluation sets
(``scripts/paper_sets.py``): the tolerance rule of
``scripts/paper_quality.py`` (b)–(e), each member held to the others'
spread, the loader, each set's record and recorded verdict,
``paper_sets.snapshot`` and ``scripts/rounding_spread.py``'s nudge (the ``miranda-cf-smoke`` draws are held
against the JAX package's in ``tests/test_torch_e2e.py``, beside the
reference's 2-channel trainer that compiles the same draws)."""
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path[:0] = [os.path.join(ROOT, "examples"), os.path.join(ROOT, "scripts")]

import compress_field_torch  # noqa: E402
import paper_sets  # noqa: E402
import quickstart_torch  # noqa: E402
import serve_archive_torch  # noqa: E402

torch.set_num_threads(1)

BOUND_LINE = "[ok] all error bounds verified"
SMALL = ["--dataset", "hurricane", "--shape", "8,16,16", "--epochs", "2",
         "--device", "cpu"]


@pytest.mark.parametrize("engine,extra", [
    ("serial", []),
    ("batched", ["--verify"]),
    ("streaming", ["--verify", "--decode-field", "w"]),
])
def test_compress_field_engines(tmp_path, capsys, engine, extra):
    out = tmp_path / "a.nlz"
    assert compress_field_torch.main(
        SMALL + ["--engine", engine, "--out", str(out)] + extra) == 0
    text = capsys.readouterr().out
    assert BOUND_LINE in text
    assert text.count("maxerr/eb=") == 3
    if "--verify" in extra:
        assert "entries checksum-verified: all ok" in text
    if engine == "streaming":
        assert "decode('w')" in text


def test_compress_field_resume_and_run(tmp_path, capsys):
    """A second streaming run with ``--resume`` salvages every field of the
    first's container; ``run`` returns the printed numbers."""
    out = str(tmp_path / "s.nlzs")
    args = compress_field_torch.build_parser().parse_args(
        SMALL + ["--engine", "streaming", "--out", out])
    first = compress_field_torch.run(args)
    assert first["archive_bytes"] == os.path.getsize(out)
    assert compress_field_torch.main(
        SMALL + ["--engine", "streaming", "--out", out, "--resume"]) == 0
    text = capsys.readouterr().out
    assert "[resume]   salvaged 3 fields" in text and BOUND_LINE in text
    assert sorted(first["fields"]) == ["cloud", "precip", "w"]
    for f in first["fields"].values():
        assert f["max_err_over_eb"] <= 1.0 and f["mode"] == "strict"
        assert f["psnr_enhanced"] > 0 and f["bitrate"] > 0
    assert {"compress_s", "decode_s", "timing", "entries"} <= set(first)


def test_compress_field_options(capsys):
    assert compress_field_torch.main(["--list-compressors"]) == 0
    names = [ln.split()[0] for ln in capsys.readouterr().out.splitlines()[1:]]
    assert names == ["szlike", "szlike-lorenzo", "zfplike"]
    name, eb = compress_field_torch.parse_field_eb("w=abs:0.5:relaxed")
    assert (name, eb.abs, eb.rel, eb.mode) == ("w", 0.5, None, "relaxed")
    # The session: cross-field on, the example's engine and mode, no fallback.
    args = compress_field_torch.build_parser().parse_args(["--device", "cpu"])
    sess = compress_field_torch.build_session(args)
    assert sess.config.engine == "batched" and sess.config.mode == "strict"
    assert dict(sess.config.cross_field)["temperature"] == ("dark_matter_density",)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            compress_field_torch.main(["--shape", "4,8,8"])


def test_serve_archive_example(capsys):
    assert serve_archive_torch.main(
        ["--shape", "8,16,16", "--epochs", "2", "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert "max |err|/eb" in text and "(must be <= 1)" in text
    assert "decode dispatches" in text and "transcode to" in text


def test_quickstart_example(capsys):
    assert quickstart_torch.main(["--device", "cpu"]) == 0
    text = capsys.readouterr().out
    ratio = float(text.split("max |err|/eb :")[1].split()[0])
    assert ratio <= 1.0 and "PSNR" in text


# ---- the records and the tolerance rule (numpy only) ----

def test_tolerance_rule():
    # (c): the floor where the ensemble agrees, the spread where it does not.
    c = paper_sets.psnr_check(60.04, [60.0, 60.0, 60.0])
    assert c["ok"] and c["tol"] == 0.05 and c["median"] == 60.0
    assert not paper_sets.psnr_check(60.06, [60.0, 60.0, 60.0])["ok"]
    c = paper_sets.psnr_check(61.0, [60.0, 60.3, 61.1])
    assert c["tol"] == pytest.approx(1.1) and c["median"] == 60.3 and c["ok"]
    assert not paper_sets.psnr_check(58.9, [60.0, 60.3, 61.1])["ok"]
    # (d): relative to the median, never below 2%.
    d = paper_sets.bitrate_check(2.039, [2.0, 2.0, 2.0])
    assert d["ok"] and d["tol_rel"] == 0.02
    assert not paper_sets.bitrate_check(2.041, [2.0, 2.0, 2.0])["ok"]
    d = paper_sets.bitrate_check(2.2, [2.0, 2.1, 2.3])
    assert d["tol_rel"] == pytest.approx(0.3 / 2.1) and d["ok"]
    assert not paper_sets.bitrate_check(1.7, [2.0, 2.1, 2.3])["ok"]
    e = paper_sets.loss_check(0.5, 0.5004)
    assert e["ok"] and not paper_sets.loss_check(0.5, 0.501)["ok"]


@pytest.mark.parametrize("psnr,others,ok", [
    (60.04, [60.0, 60.0], True),     # the floor where the others agree
    (60.06, [60.0, 60.0], False),
    (60.9, [60.0, 61.0], True),      # the others' spread, 1 dB
    (58.9, [60.0, 61.0], False),
    (58.0, [60.0, 60.01], False),    # far off: its own gap widens nothing
])
def test_member_tolerance_comes_from_the_others(psnr, others, ok):
    m = paper_sets.member_check(60.0, 2.0, psnr, 2.0, others, [2.0, 2.0])
    assert m["ok"] is ok and m["psnr_tol"] == max(0.05, max(others) - min(others))
    # The whole ensemble's rule (c) alone is widened by a far-off member.
    assert paper_sets.psnr_check(60.0, [58.0, 60.0, 60.01])["ok"]
    # (d): 2% or the others' spread over their median.
    assert paper_sets.member_check(60.0, 2.0, 60.0, 2.039, [60.0] * 2,
                                   [2.0, 2.0])["ok"]
    assert not paper_sets.member_check(60.0, 2.0, 60.0, 2.2, [60.0] * 2,
                                       [2.0, 2.1])["ok"]


def _exact(stats_shift=0.0, mean_shift=0.0, **flags):
    want = {"stats": [[1.0, 0.25], [3.0, 2.0]], "conv_mean": 1.0}
    port = {"payloads": True, "abs_eb": True, "header": True,
            "stats": [[1.0 + stats_shift, 0.25], [3.0, 2.0 + 8 * stats_shift]],
            "mean": 1.0 + mean_shift, **flags}
    return paper_sets.exact_check(port, want)


def test_exact_check_bounds_stats_and_mean():
    assert _exact()["ok"] and _exact()["stats_gap"] == 0.0
    # Gaps relative to each channel's standard deviation.
    e = _exact(stats_shift=2e-14, mean_shift=1e-14)
    assert e["ok"] and e["stats_gap"] == pytest.approx(8e-14)
    assert e["mean_gap"] == pytest.approx(4e-14)
    assert not _exact(stats_shift=1e-12)["ok"]
    assert not _exact(mean_shift=1e-12)["ok"]
    for flag in ("payloads", "abs_eb", "header"):
        assert not _exact(**{flag: False})["ok"]


def _runs(kernel_psnr):
    field = {"psnr_enhanced": 60.0, "bitrate": 2.0, "max_err_over_eb": 0.9,
             "loss_first": 0.5}
    return {"kernel": {"f": {**field, "psnr_enhanced": kernel_psnr}},
            "plain": {"f": dict(field)},
            "plain_f64": {"f": {**field, "psnr_enhanced": 60.02}}}


def test_verdict_holds_each_member_to_the_others():
    rec = {"fields": {"f": {"psnr_enhanced": 60.01, "bitrate": 2.0,
                            "loss_history": [0.5], "stats": [[1.0, 0.25]],
                            "conv_mean": 1.0}}}
    exact = {"f": {"payloads": True, "abs_eb": True, "header": True,
                   "stats": [[1.0, 0.25]], "mean": 1.0}}
    v = paper_sets.verdict(rec, exact, _runs(60.03))
    assert v["ok"] and v["tolerance"]["f"]["kernel"]["psnr_db"] == 0.05
    v = paper_sets.verdict(rec, exact, _runs(58.0))
    assert v["checks"]["f"]["c"]["ok"]          # the ensemble's median holds
    assert not v["checks"]["f"]["members"]["kernel"]["ok"] and not v["ok"]
    runs = _runs(60.0)
    runs["plain"]["f"]["max_err_over_eb"] = 1.01
    assert not paper_sets.verdict(rec, exact, runs)["ok"]


def test_rounding_spread_nudges_one_ulp():
    import rounding_spread
    w = np.linspace(-1, 1, 64, dtype=np.float32).reshape(8, 8)
    tree = {"conv_in": {"w": w, "b": np.zeros(4, np.float32)}}
    a, b = rounding_spread.nudged(tree, 1), rounding_spread.nudged(tree, 1)
    assert a["conv_in"]["w"].tobytes() == b["conv_in"]["w"].tobytes()
    got = a["conv_in"]["w"]
    up, down = np.nextafter(w, np.float32(np.inf)), np.nextafter(w, np.float32(-np.inf))
    assert ((got == up) | (got == down)).all()
    assert (got == up).any() and (got == down).any()
    assert a["conv_in"]["b"].dtype == np.float32 and (a["conv_in"]["b"] != 0).all()
    assert rounding_spread.parted_at([1.0, 1.0005, 1.02], [1.0] * 3, 1e-3) == 3
    assert rounding_spread.parted_at([1.0], [1.0], 1e-3) is None


def test_draws_round_trip(tmp_path):
    params = {"a": {"conv_in": {"w": np.arange(6, dtype=np.float32).reshape(3, 2),
                                "b": np.zeros(2, np.float32)}}}
    sched = {"a": np.arange(12).reshape(2, 2, 3)}
    paper_sets.save_draws(tmp_path / "s.npz", params, sched)
    p, s = paper_sets.load_draws("s", tmp_path)
    assert p["a"]["conv_in"]["w"].tobytes() == params["a"]["conv_in"]["w"].tobytes()
    assert s["a"].dtype == np.int32 and np.array_equal(s["a"], sched["a"])


@pytest.mark.parametrize("dataset", ["hurricane", "miranda", "nyx"])
def test_snapshot_is_make_fields_of_both_packages(dataset):
    """``paper_sets.snapshot`` draws the same bytes from either package's
    ``make_fields`` under its pinned numpy dispatch."""
    port = paper_sets.snapshot(dataset, (6, 12, 10))
    ref = paper_sets.snapshot(dataset, (6, 12, 10), package="repro")
    assert paper_sets.field_digests(port) == paper_sets.field_digests(ref)
    assert list(port) == list(ref)


@pytest.mark.parametrize("name", sorted(paper_sets.SETS))
def test_reference_records(name):
    """Every set's record and draws load and agree with the set's table."""
    spec = paper_sets.SETS[name]
    rec = paper_sets.load_record(name)
    assert rec["shape"] == spec["shape"] and rec["epochs"] == spec["epochs"]
    assert rec["dataset"] == spec["dataset"] and rec["reduced"] == spec["reduced"]
    assert (rec["rel_eb"], rec["mode"], rec["seed"]) == (
        paper_sets.REL_EB, paper_sets.MODE, paper_sets.SEED)
    assert rec["codec"] == paper_sets.CODEC
    assert rec["numpy_env"] == paper_sets.SNAPSHOT_NUMPY_ENV
    assert sorted(rec["field_sha256"]) == sorted(rec["fields"])
    init, sched = paper_sets.load_draws(name)
    n = spec["shape"][0]
    batch = min(10, n)
    for field, f in rec["fields"].items():
        assert f["max_err_over_eb"] <= 1.0
        assert len(f["loss_history"]) == spec["epochs"]
        assert sorted(f["payload_sha256"]) == sorted(paper_sets.PAYLOAD_KEYS)
        assert isinstance(f["conv_mean"], float)
        assert sched[field].shape == (spec["epochs"], max(1, n // batch), batch)
        assert init[field]["conv_in"]["w"].shape == (3, 3, 1 + len(f["aux"]), 4)
    card = paper_sets.load_card(name)
    if card is not None:
        assert card["set"] == name
        assert sorted(card["runs"]) == ["kernel", "plain", "plain_f64"]
        # The recorded verdict is the rule's on the recorded runs; every set
        # passes but hurricane-cf-100, whose kernel member misses on precip
        # (ROADMAP §3).
        v = paper_sets.verdict(rec, card["exact"], card["runs"])
        assert v == {k: card[k] for k in v}
        assert card["ok"] is (name != "hurricane-cf-100")
        if name == "hurricane-cf-100":
            missed = [(f, m) for f, c in v["checks"].items()
                      for m, r in c["members"].items() if not r["ok"]]
            assert missed == [("precip", "kernel")]
