"""The port's streaming engine (``repro_torch.streaming``) against the port's
own serial engine, and its pure-Python pieces against the JAX package's, at
the port's test shapes (9×20×24 Hurricane fields, 2 epochs).

The JAX package's streamed archives do not always equal its serial ones
(its own ``tests/test_streaming.py`` property fails), so a reference
streaming archive is never the oracle here: streamed entries are held byte
for byte against the port's serial engine, which ``test_torch_e2e.py``
holds against the reference's serial eager engine.

* streamed entries equal serial ones: group sizes 0/1/2, ragged fields,
  the Hurricane cross-field cycle, per-field bounds, an ``.npy`` directory,
  a ``BytesIO`` sink and ``engine="streaming"``;
* the residency ledger's peak under a budget, its exact value reckoned
  from the ledger's keys, and a budget too small to admit a group;
* group order and plan equal the reference's on the same metadata;
* resume after a failed append equals an uninterrupted run;
* ``iter_decompress``, ROI decode and blocked containers decode as the
  serial decode does, reading only the covering blocks;
* the straggler watchdog, writer- and reader-thread errors;
* the Nyx and Miranda generators, ``snapshot_specs`` / ``load_spec``, and
  ``bfloat16`` weights without ``ml_dtypes``, against the reference's bytes.
"""
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch
from repro.core import archive as ref_archive
from repro.core import batched_engine as ref_be
from repro.core import neurlz as ref_neurlz
from repro.data import fields as ref_fields
from repro.streaming import pipeline as ref_pipeline
from repro.streaming import source as ref_source
from repro_torch import streaming
from repro_torch.core import archive as arc_io
from repro_torch.core import batched_engine as port_be
from repro_torch.core import neurlz
from repro_torch.data import fields as port_fields

# The suite runs in parallel workers on a few cores: one intra-op thread
# per worker keeps the port's tests from crowding out the others.
torch.set_num_threads(1)

SHAPE = (9, 20, 24)
EPOCHS, REL_EB = 2, 1e-3
FIELDS = port_fields.make_fields("hurricane", SHAPE, seed=1)
RAGGED = {**FIELDS, "precip": FIELDS["precip"][:7]}
CYCLE = port_fields.DEFAULT_CROSS_FIELD["hurricane"]    # cloud<-w<-precip<-cloud
BOUNDS = {"w": repro_torch.ErrorBound(abs=0.05),
          "cloud": repro_torch.ErrorBound(rel=1e-2, mode="relaxed")}


def _sess(**kw):
    return repro_torch.NeurLZ(device="cpu", **{"epochs": EPOCHS, **kw})


_SERIAL: dict = {}


def _serial(fields, key, **kw):
    """The port's serial archive of ``fields`` (cached per case)."""
    if key not in _SERIAL:
        bounds = kw.pop("bounds", None)
        _SERIAL[key] = _sess(**kw).compress(fields, bounds, rel_eb=REL_EB)
    return _SERIAL[key]


def _entries(arc) -> bytes:
    return arc_io.dumps(arc["fields"])


# ---- streamed entries equal the serial engine's ----------------------------

STREAM_CASES = {
    "group0": (FIELDS, {"group_size": 0}, {}),
    "group1": (FIELDS, {"group_size": 1}, {}),
    "group2": (FIELDS, {"group_size": 2}, {}),
    "ragged": (RAGGED, {"group_size": 2}, {}),
    "cross_field_cycle": (FIELDS, {"group_size": 1, "cross_field": CYCLE}, {}),
    "bounds": (FIELDS, {"group_size": 0}, {"bounds": BOUNDS}),
}


@pytest.mark.parametrize("case", sorted(STREAM_CASES))
def test_streamed_entries_equal_serial(tmp_path, case):
    fields, kw, extra = STREAM_CASES[case]
    serial_kw = {k: v for k, v in kw.items() if k == "cross_field"}
    want = _serial(fields, case if serial_kw or extra else
                   ("ragged" if fields is RAGGED else "plain"),
                   **serial_kw, **extra)
    path = tmp_path / "snap.nlzs"
    arc = _sess(**kw).compress_to(fields, path, extra.get("bounds"),
                                  rel_eb=REL_EB)
    assert arc.streaming and arc.reader.entry_reads == []
    assert _entries(arc.to_dict()) == _entries(want)
    assert arc.report["entries"] == len(fields)
    assert arc.report["field_order"] == list(fields)


def test_npy_directory_and_bytesio_sink_equal_serial(tmp_path):
    for name, x in FIELDS.items():
        np.save(tmp_path / f"{name}.npy", x)
    src = streaming.NpyDirSource(str(tmp_path))
    assert src.names() == sorted(FIELDS) == list(FIELDS)
    assert isinstance(src.load("w"), np.memmap)
    buf = io.BytesIO()
    arc = _sess(group_size=1).compress_to(src, buf, rel_eb=REL_EB)
    assert _entries(arc.to_dict()) == _entries(_serial(FIELDS, "plain"))
    # A directory path is a source too.
    arc2 = _sess(group_size=1).compress_to(str(tmp_path), io.BytesIO(),
                                           rel_eb=REL_EB)
    assert _entries(arc2.to_dict()) == _entries(_serial(FIELDS, "plain"))


def test_engine_streaming_through_compress():
    arc = _sess(engine="streaming", max_resident_bytes=10 ** 8).compress(
        FIELDS, rel_eb=REL_EB)
    assert _entries(arc) == _entries(_serial(FIELDS, "plain"))
    t = arc["timing"]
    assert t["max_resident_bytes"] == 10 ** 8
    assert 0 < t["peak_resident_bytes"] <= 10 ** 8
    assert t["entries"] == 3 and t["writer_busy_s"] >= 0
    with pytest.raises(ValueError, match="streaming engine"):
        _sess(engine="streaming").compress(FIELDS, rel_eb=REL_EB,
                                           init_params={"w": {}})


# ---- the residency budget ---------------------------------------------------

def test_peak_residency_is_two_working_sets_under_its_budget():
    """Four Nyx fields of 9×20×24 float32, one a group.  A working set is
    x + rec + ds = 17,280 + 17,280 + 34,560 = 69,120 bytes; under 2.25 of
    them the depth-2 pipeline holds two at a time (the next group is
    prefetched once the one before it retired), never three."""
    src = streaming.synthetic_snapshot_source(4, shape=SHAPE, dataset="nyx")
    x_b = int(np.prod(SHAPE)) * 4
    working = x_b + x_b + x_b * 2
    assert working == 69_120
    budget = int(2.25 * working)
    tel = repro_torch.Telemetry()
    arc = _sess(group_size=1, max_resident_bytes=budget,
                telemetry=tel).compress_to(src, io.BytesIO(), rel_eb=REL_EB)
    assert arc.report["peak_resident_bytes"] == 2 * working <= budget
    assert tel.counters["stream.evictions"] == 4 * 3
    fields = {n: src.load(n) for n in src.names()}
    assert _entries(arc.to_dict()) == _entries(
        _sess().compress(fields, rel_eb=REL_EB))


def test_a_budget_below_one_group_raises():
    with pytest.raises(MemoryError, match="max_resident_bytes=1000"):
        _sess(group_size=1, max_resident_bytes=1000).compress_to(
            FIELDS, io.BytesIO(), rel_eb=REL_EB)


PLAN_SHAPES = {"a": (9, 20, 24), "b": (9, 20, 24), "c": (7, 20, 24),
               "d": (9, 16, 24), "e": (9, 20, 24)}
PLAN_AUX = {"a": ["e"], "b": [], "c": ["a"], "d": [], "e": ["d"]}


@pytest.mark.parametrize("cross", [False, True])
@pytest.mark.parametrize("group_size", [0, 1, 2])
def test_plan_and_order_match_reference(group_size, cross):
    aux = PLAN_AUX if cross else {n: [] for n in PLAN_SHAPES}
    c_ins = {n: 1 + len(a) for n, a in aux.items()}
    metas = {n: streaming.FieldMeta.of(s, np.float32)
             for n, s in PLAN_SHAPES.items()}
    ref_metas = {n: ref_source.FieldMeta.of(s, np.float32)
                 for n, s in PLAN_SHAPES.items()}
    groups = port_be.plan_groups_from_meta(
        PLAN_SHAPES, c_ins, neurlz.NeurLZConfig(group_size=group_size))
    ref_groups = ref_be.plan_groups_from_meta(
        PLAN_SHAPES, c_ins, ref_neurlz.NeurLZConfig(group_size=group_size))
    assert [g.names for g in groups] == [g.names for g in ref_groups]
    got = streaming.order_groups(groups, aux, metas)
    want = ref_pipeline.order_groups(ref_groups, aux, ref_metas)
    assert [g.names for g in got] == [g.names for g in want]


# ---- resume -----------------------------------------------------------------

def test_resume_after_a_failed_append_equals_an_uninterrupted_run(tmp_path):
    path = str(tmp_path / "snap.nlzs")
    faults = repro_torch.FaultConfig(
        injector=repro_torch.FaultInjector({"writer.add_entry": 2}))
    with pytest.raises(RuntimeError, match="writer thread failed") as info:
        _sess(group_size=1, faults=faults).compress_to(FIELDS, path,
                                                       rel_eb=REL_EB)
    assert isinstance(info.value.__cause__, repro_torch.InjectedFault)
    with repro_torch.open(path, repair=True, device="cpu") as torn:
        assert torn.salvaged and torn.field_names == ["cloud", "precip"]
    arc = _sess(group_size=1).compress_to(FIELDS, path, rel_eb=REL_EB,
                                          resume=True)
    assert arc.report["resumed_fields"] == ["cloud", "precip"]
    assert arc.report["groups"] == 1
    assert _entries(arc.to_dict()) == _entries(_serial(FIELDS, "plain"))
    arc.close()
    with pytest.raises(ValueError, match="different configuration"):
        _sess(group_size=1, epochs=EPOCHS + 1).compress_to(
            FIELDS, path, rel_eb=REL_EB, resume=True)


# ---- decode -----------------------------------------------------------------

def test_iter_decompress_and_roi_equal_the_serial_decode(tmp_path):
    path = tmp_path / "snap.nlzs"
    _sess(group_size=1, cross_field=CYCLE).compress_to(FIELDS, path,
                                                        rel_eb=REL_EB)
    want = _serial(FIELDS, "cross_field_cycle", cross_field=CYCLE).decode_all()
    got = list(streaming.iter_decompress(path, device="cpu"))
    assert [n for n, _ in got] == list(FIELDS)
    for name, x in got:
        assert x.tobytes() == want[name].tobytes()
    with repro_torch.open(path, device="cpu") as arc:
        assert arc.block_manifest == {}
        roi = (slice(2, 7, 2), slice(None), slice(3, 20))
        assert np.array_equal(arc.decode("w", roi=roi), want["w"][roi])
        assert np.array_equal(arc.decode("cloud", roi=slice(4, 5)),
                              want["cloud"][4:5])
        with pytest.raises(TypeError, match="slices"):
            arc.decode("w", roi=(1,))


def test_blocked_source_entries_decode_and_roi(tmp_path):
    block = 4 * SHAPE[1] * SHAPE[2] * 4        # 4 slices of float32
    src = streaming.BlockedSource(streaming.DictSource(FIELDS), block)
    assert src.manifest["w"] == {"axis": 0, "blocks": [
        ["w#b0", 0, 4], ["w#b1", 4, 8], ["w#b2", 8, 9]]}
    presplit = {f"{n}#b{i}": x[lo:lo + 4]
                for n, x in FIELDS.items() for i, lo in enumerate((0, 4, 8))}
    assert src.names() == list(presplit)
    path = tmp_path / "blocked.nlzs"
    _sess(group_size=0).compress_to(src, path, rel_eb=REL_EB)
    serial = _serial(presplit, "presplit")
    want = serial.decode_all()
    with repro_torch.open(path, device="cpu") as arc:
        assert _entries(arc.to_dict()) == _entries(serial)
        assert arc.block_manifest == src.manifest
        arc.reader.entry_reads.clear()
        roi = (slice(5, 7), slice(2, 9))
        got = arc.decode("w", roi=roi)
        assert arc.reader.entry_reads == ["w#b1"]     # only the covering block
        full = np.concatenate([want[f"w#b{i}"] for i in range(3)])
        assert np.array_equal(got, full[roi])
        assert np.array_equal(arc.decode("w"), full)
        assert np.array_equal(arc.decode("w", roi=slice(7, 3, -1)),
                              full[7:3:-1])
        assert arc.decode("w", roi=slice(3, 3)).shape == (0, 20, 24)
        joined = arc.decode_all(reassemble=True)
        assert list(joined) == list(FIELDS)
        assert np.array_equal(joined["w"], full)
        assert set(arc.decode_all()) == set(presplit)
    assert list(streaming.decompress(path, device="cpu")) == list(FIELDS)


# ---- watchdog and thread errors ----------------------------------------------

def test_straggler_watchdog_counts_overruns():
    tel = repro_torch.Telemetry()
    faults = repro_torch.FaultConfig(straggler_deadline_s=1e-6)
    arc = _sess(group_size=1, telemetry=tel, faults=faults).compress_to(
        FIELDS, io.BytesIO(), rel_eb=REL_EB)
    # Each of the three groups runs far past 1 µs; a timer that the OS
    # schedules only after its group ended is cancelled, so "at least one".
    assert 1 <= arc.report["straggler_overruns"] <= 3
    assert 1 <= tel.counters["faults.stragglers"] <= 3
    wd = repro_torch.faults.StepWatchdog(10.0)
    with wd.step(0):
        pass
    assert wd.stats()["steps"] == 1 and wd.overruns == []


def test_a_writer_thread_error_surfaces(monkeypatch):
    def boom(*args, **kwargs):
        raise ValueError("pack failed")
    monkeypatch.setattr(neurlz, "pack_entry", boom)
    with pytest.raises(RuntimeError, match="writer thread failed") as info:
        _sess(group_size=1).compress_to(FIELDS, io.BytesIO(), rel_eb=REL_EB)
    assert isinstance(info.value.__cause__, ValueError)


def test_a_reader_thread_error_surfaces():
    # The second load is the reader thread's prefetch of the next group.
    faults = repro_torch.FaultConfig(
        injector=repro_torch.FaultInjector({"reader.load": 1}))
    with pytest.raises(repro_torch.InjectedFault):
        _sess(group_size=1, faults=faults).compress_to(
            FIELDS, io.BytesIO(), rel_eb=REL_EB)


# ---- the reference's generators and weight bytes ----------------------------

@pytest.mark.parametrize("dataset", ["nyx", "miranda"])
def test_generators_give_the_reference_bytes(dataset):
    got = port_fields.make_fields(dataset, (6, 10, 12), seed=4)
    want = ref_fields.make_fields(dataset, (6, 10, 12), seed=4)
    assert list(got) == list(want) == port_fields.DATASET_FIELDS[dataset]
    for name in want:
        assert got[name].dtype == port_fields.DATASET_DTYPES[dataset]
        assert got[name].tobytes() == want[name].tobytes()
    specs = port_fields.snapshot_specs(5, shape=(6, 10, 12), dataset=dataset)
    assert specs == ref_fields.snapshot_specs(5, shape=(6, 10, 12),
                                              dataset=dataset)
    last = list(specs)[-1]
    assert (port_fields.load_spec(specs[last]).tobytes()
            == ref_fields.load_spec(specs[last]).tobytes())
    assert port_fields.DEFAULT_CROSS_FIELD == ref_fields.DEFAULT_CROSS_FIELD


_BF16_SCRIPT = """
import sys
sys.modules["ml_dtypes"] = None          # no numpy bfloat16 dtype anywhere
import numpy as np
from repro_torch.core import archive
tree = np.load(sys.argv[1], allow_pickle=True).item()
blob = archive.pack_weights(tree, "bfloat16")
back = archive.unpack_weights(blob, {k: {"b": None, "w": None} for k in tree})
sys.stdout.write(blob["payload"].hex() + " " + str(blob["raw_nbytes"]) + " "
                 + back["l"]["w"].astype(np.float32).tobytes().hex())
"""


def test_bfloat16_weights_without_ml_dtypes(tmp_path):
    import ml_dtypes
    rng = np.random.default_rng(0)
    v = (rng.standard_normal(4000)
         * 10.0 ** rng.uniform(-30, 20, 4000)).astype(np.float32)
    v[:4] = [0.0, -0.0, np.inf, -np.inf]
    tree = {"l": {"b": v[:1000].reshape(10, 100),
                  "w": v[1000:].reshape(3, 10, 100)}}
    np.save(tmp_path / "tree.npy", tree, allow_pickle=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"))
    out = subprocess.run([sys.executable, "-c", _BF16_SCRIPT,
                          str(tmp_path / "tree.npy")], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    payload, raw_nbytes, back = out.stdout.split()
    want = ref_archive.pack_weights(tree, "bfloat16")
    assert bytes.fromhex(payload) == want["payload"]
    assert int(raw_nbytes) == want["raw_nbytes"]
    rounded = np.asarray(tree["l"]["w"], ml_dtypes.bfloat16).astype(np.float32)
    assert bytes.fromhex(back) == rounded.tobytes()
