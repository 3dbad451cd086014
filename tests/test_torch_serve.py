"""The port's serving tier (``repro_torch.serve``) and the rest of its
``core`` / ``compressors`` surface, against the JAX package's, at the port's
test shapes (9×20×24 Hurricane fields, 2 epochs, the cross-field pair
``w <- precip`` so that an aux closure exists).

No reference training call is made: every archive here is the port's, and
the reference is held against it through its server (which reads the
port's container), its cache, coalescer, conventional compressor and
metrics.

* the hot-field cache: the reference's seeded stress sequence on both
  caches in lockstep (LRU keys, resident bytes, counters after every op),
  refcounted pins and the everything-pinned rejection, torch tensors
  charged by their bytes;
* the coalescer splits the same queue into the same batches;
* the server on one port-written container: ``DecodeStats``, counters and
  cache keys equal the reference server's, results equal the port's
  ``Archive.decode`` bit for bit and the reference's within
  ``1e-3 * abs_eb``; a container written by the reference's appender is
  served too; the aux closure is cached and pinned while its dependant
  decodes; ROI, multi-archive with two decode keys, fault isolation;
* transcode: entries equal the port's serial compress of the decoded
  fields, conventional payloads and ``abs_eb`` equal the reference's
  ``registry.compress``, the new bounds hold, resume, blocked sources,
  a shared ledger, the default configuration taken from the container;
* a source that loads on the device is loaded on the calling thread;
* metrics, legacy dict shims, ``registry.entries``, ``archive.load``,
  ``skipping_dnn.param_count``, ``NeurLZ.replace``, ``resolve_bounds``.
"""
import importlib
import io
import os
import threading
import warnings

import jax
import numpy as np
import pytest
import torch

import repro_torch
from repro import obs as ref_obs
from repro.compressors import registry as ref_registry
from repro.core import archive as ref_archive
from repro.core import bounds as ref_bounds
from repro.core import metrics as ref_metrics
from repro.core import skipping_dnn as ref_dnn
from repro.serve import (ArchiveServer as RefServer, Coalescer as RefCoalescer,
                         HotFieldCache as RefCache, Request as RefRequest)
from repro.streaming.pipeline import ResidencyLedger as RefLedger
from repro_torch import serve, streaming
from repro_torch.compressors import registry
from repro_torch.core import archive as arc_io
from repro_torch.core import metrics, neurlz, regulation, skipping_dnn
from repro_torch.data import fields as port_fields
from repro_torch.streaming import pipeline as port_pipeline
from repro_torch.streaming.pipeline import ResidencyLedger

# The package re-exports the function under the module's name.
ref_transcode_mod = importlib.import_module("repro.serve.transcode")

torch.set_num_threads(1)

SHAPE = (9, 20, 24)
EPOCHS, REL_EB = 2, 1e-3
FIELDS = port_fields.make_fields("hurricane", SHAPE, seed=1)
NAMES = list(FIELDS)                    # cloud, precip, w
CROSS = {"w": ("precip",)}
GIB = 1 << 30


def _cfg(**kw):
    return neurlz.NeurLZConfig(epochs=EPOCHS, engine="streaming", **kw)


@pytest.fixture(scope="module")
def snap(tmp_path_factory):
    """A port-written container of the three fields, its decode and each
    field's ``abs_eb``."""
    path = os.fspath(tmp_path_factory.mktemp("serve") / "snap.nlzs")
    streaming.compress(FIELDS, path, REL_EB, config=_cfg(cross_field=CROSS),
                       device="cpu")
    with repro_torch.Archive.open(path, device="cpu") as arc:
        decoded = {n: arc.decode(n) for n in NAMES}
        ebs = {n: arc.entry(n)["abs_eb"] for n in NAMES}
    return path, decoded, ebs


# ---- the hot-field cache -----------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 7, 42])
def test_cache_stress_matches_reference(seed):
    """The reference's ``_stress_cache`` sequence, both caches in lockstep."""
    ceiling = 1000
    rng = np.random.default_rng(seed)
    tels = (repro_torch.Telemetry(), ref_obs.Telemetry())
    port = serve.HotFieldCache(ResidencyLedger(ceiling, telemetry=tels[0]),
                               tels[0])
    ref = RefCache(RefLedger(ceiling, telemetry=tels[1]), tels[1])
    pinned: list = []
    for step in range(200):
        op = rng.integers(0, 4)
        key = int(rng.integers(0, 12))
        if op == 0:
            value = np.zeros(int(rng.integers(1, ceiling)), np.uint8)
            assert port.put(key, value) == ref.put(key, value.copy()), step
        elif op == 1:
            assert (port.get(key) is None) == (ref.get(key) is None), step
        elif op == 2:
            port.pin(key)
            ref.pin(key)
            pinned.append(key)
        elif op == 3 and pinned:
            k = pinned.pop(int(rng.integers(0, len(pinned))))
            port.unpin(k)
            ref.unpin(k)
        assert port.keys == ref.keys, step
        assert port.resident_bytes == ref.resident_bytes \
            == port.ledger.current == ref.ledger.current <= ceiling, step
        assert tels[0].counters == tels[1].counters, step
    for k in pinned:
        port.unpin(k)
        ref.unpin(k)
    port.clear()
    ref.clear()
    assert port.ledger.current == ref.ledger.current == 0


def _pin_cases(mod_cache, mod_ledger):
    """The reference's pin tests as a list of outcomes."""
    out = []
    cache = mod_cache(mod_ledger(100))
    out.append(cache.put("a", np.zeros(20, np.uint8)))
    cache.pin("a")
    out.append(cache.put("b", np.zeros(90, np.uint8)))     # a is pinned
    out += ["a" in cache, "b" in cache, cache.ledger.current]
    cache.unpin("a")
    out.append(cache.put("b", np.zeros(90, np.uint8)))     # a may go now
    out += ["a" in cache, "b" in cache, cache.ledger.current]
    cache = mod_cache(mod_ledger(100))
    cache.put("x", np.zeros(60, np.uint8))
    cache.pin("x")
    cache.pin("x")
    cache.unpin("x")
    out += [cache.pinned("x"), cache.put("y", np.zeros(80, np.uint8))]
    cache.unpin("x")
    out += [cache.pinned("x"), cache.put("y", np.zeros(80, np.uint8)),
            cache.keys]
    return out


def test_cache_pins_and_rejection_match_reference():
    port = _pin_cases(serve.HotFieldCache, ResidencyLedger)
    assert port == _pin_cases(RefCache, RefLedger)
    assert port[:2] == [True, False] and port[5] is True


def test_cache_charges_torch_tensors_and_refuses_unsized_values():
    cache = serve.HotFieldCache(ResidencyLedger(1000))
    assert cache.put("t", torch.zeros(10, dtype=torch.float64))
    assert cache.put("l", [np.zeros(3, np.float32), torch.zeros(4)])
    assert cache.resident_bytes == cache.ledger.current == 80 + 12 + 16
    with pytest.raises(TypeError):
        cache.put("o", object())


# ---- the coalescer -------------------------------------------------------------

def _batches(coalescer_cls, request_cls):
    co = coalescer_cls(window_s=0.0, max_batch=3)
    reqs = [co.submit(request_cls("a" if i % 3 else "b", f"f{i}"))
            for i in range(7)]
    co.close()
    with pytest.raises(RuntimeError):
        co.submit(request_cls("a", "late"))
    out = []
    while True:
        batch, stopping = co.drain(block=False)
        out.append([(r.archive_id, r.name) for r in batch])
        if stopping or not batch:
            break
    assert [r.seq for r in reqs] == sorted(r.seq for r in reqs)
    return out


def test_coalescer_splits_like_the_reference():
    port = _batches(serve.Coalescer, serve.Request)
    assert port == _batches(RefCoalescer, RefRequest)
    assert [len(b) for b in port] == [3, 3, 1]
    fut = serve.Future()
    with pytest.raises(TimeoutError):
        fut.result(0.0)
    fut.set_error(KeyError("x"))
    assert fut.done()
    with pytest.raises(KeyError):
        fut.result()


# ---- transcode -------------------------------------------------------------------

NEW_BOUNDS = {"w": repro_torch.ErrorBound(rel=5e-2, mode="relaxed")}
NEW_REL = 1e-2
LEDGER = 64 << 20


@pytest.fixture(scope="module")
def transcoded(snap, tmp_path_factory):
    path, decoded, _ = snap
    dst = os.fspath(tmp_path_factory.mktemp("transcode") / "re.nlzs")
    ledger = ResidencyLedger(LEDGER)
    out = serve.transcode(path, dst, NEW_BOUNDS, rel_eb=NEW_REL,
                          config=_cfg(cross_field=CROSS), ledger=ledger,
                          device="cpu")
    serial = repro_torch.NeurLZ(epochs=EPOCHS, cross_field=CROSS,
                                device="cpu").compress(
        decoded, NEW_BOUNDS, rel_eb=NEW_REL)
    return dst, out, ledger, serial


@pytest.mark.parametrize("against", ["serial", "reference"])
def test_transcode_equals_the_serial_recompress_and_reference_payloads(
        snap, transcoded, against):
    """Each entry equals the port's serial recompress of the decoded field;
    its conventional payload equals the reference's ``compress`` at the new
    bound (the reference's eager compile at SHAPE, in a case of its own)."""
    _, decoded, _ = snap
    _, out, ledger, serial = transcoded
    assert out.field_names == NAMES
    for n in NAMES:
        e = out.entry(n)
        if against == "serial":
            assert arc_io.dumps(e) == arc_io.dumps(serial["fields"][n]), n
            continue
        rel = NEW_BOUNDS[n].rel if n in NEW_BOUNDS else NEW_REL
        ref_conv, _ = ref_registry.compress(decoded[n], rel)
        assert e["conv"]["abs_eb"] == ref_conv["abs_eb"], n
        assert arc_io.dumps(e["conv"]) == ref_archive.dumps(ref_conv), n
    assert out.report["peak_resident_bytes"] <= LEDGER
    assert ledger.current == 0              # every charge released


def test_transcode_holds_the_new_bounds(snap, transcoded):
    _, decoded, _ = snap
    _, out, _, _ = transcoded
    for n in NAMES:
        e = out.entry(n)
        assert e["mode"] == ("relaxed" if n == "w" else "strict")
        chk = regulation.check_bound(decoded[n], out.decode(n), e["abs_eb"],
                                     e["mode"])
        assert chk["ok"], (n, chk)


def test_transcode_resume_is_byte_identical(tmp_path, snap, transcoded):
    path, _, _ = snap
    whole, out, _, _ = transcoded
    torn = os.fspath(tmp_path / "torn.nlzs")
    blob = open(whole, "rb").read()
    open(torn, "wb").write(blob[:int(len(blob) * 0.6)])
    res = serve.transcode(path, torn, NEW_BOUNDS, rel_eb=NEW_REL,
                          config=_cfg(cross_field=CROSS), resume=True,
                          device="cpu")
    assert res.report["resumed_fields"]
    rep = res.verify()
    assert rep["ok"] and rep["sealed"]
    for n in NAMES:
        assert arc_io.dumps(res.entry(n)) == arc_io.dumps(out.entry(n)), n
    res.close()


def test_transcode_keeps_a_blocked_source_manifest(tmp_path):
    big = FIELDS["w"]
    bsrc = streaming.BlockedSource(streaming.DictSource({"huge": big}),
                                   max_block_bytes=big.nbytes // 3)
    src = os.fspath(tmp_path / "blocked.nlzs")
    streaming.compress(bsrc, src, REL_EB, config=_cfg(), device="cpu")
    with repro_torch.Archive.open(src, device="cpu") as a:
        manifest, dec = a.block_manifest, a.decode("huge")
    out = serve.transcode(src, os.fspath(tmp_path / "re.nlzs"),
                          {"huge": 1e-2}, rel_eb=REL_EB, config=_cfg(),
                          device="cpu")
    assert out.block_manifest == manifest and "huge" in manifest
    assert len(out.field_names) == len(manifest["huge"]["blocks"]) > 1
    got = out.decode("huge")
    assert got.shape == big.shape
    axis = manifest["huge"]["axis"]
    for bname, lo, hi in manifest["huge"]["blocks"]:
        part = [np.take(a, np.arange(lo, hi), axis=axis) for a in (dec, got)]
        assert regulation.check_bound(*part, out.entry(bname)["abs_eb"],
                                      "strict")["ok"], bname
    out.close()


def test_transcode_default_config_comes_from_the_container(snap,
                                                           monkeypatch):
    """Without ``config`` both packages configure the same streaming run
    from the container's meta (compressor, slice axis, cross-field map)."""
    path, _, _ = snap
    seen = []

    def capture(pkg_pipeline, tag):
        def fake(source, dst, rel_eb, **kw):
            c = kw["config"]
            seen.append((tag, c.engine, c.compressor, c.slice_axis,
                         {k: tuple(v) for k, v in c.cross_field.items()},
                         c.epochs, source.names()))
            raise StopIteration
        monkeypatch.setattr(pkg_pipeline, "compress", fake)

    capture(port_pipeline, "port")
    capture(ref_transcode_mod.pipeline, "ref")
    for fn in (lambda: serve.transcode(path, "unused", rel_eb=NEW_REL,
                                       device="cpu"),
               lambda: ref_transcode_mod.transcode(path, "unused",
                                                   rel_eb=NEW_REL)):
        with pytest.raises(StopIteration):
            fn()
    assert seen[0][1:] == seen[1][1:]
    assert seen[0][1:5] == ("streaming", "szlike", 0, CROSS)


# ---- the server ----------------------------------------------------------------

def _serve(server, names):
    """Queue ``names`` first, then start: one deterministic batch."""
    futs = [server.submit(n) for n in names]
    server.start()
    out = [f.result(120) for f in futs]
    keys = server.cache.keys
    server.close()
    return out, keys


def test_server_matches_reference_on_a_port_container(snap):
    path, decoded, ebs = snap
    names = NAMES + ["w"]                   # a duplicate shares one decode
    ptel, rtel = repro_torch.Telemetry(), ref_obs.Telemetry()
    psrv = serve.ArchiveServer(path, max_bytes=GIB, auto_start=False,
                               telemetry=ptel, device="cpu")
    rsrv = RefServer(path, max_bytes=GIB, auto_start=False, telemetry=rtel)
    pout, pkeys = _serve(psrv, names)
    rout, rkeys = _serve(rsrv, names)
    # one batch: the three fields (precip once, though w takes it as aux)
    # are one stacked conventional decode
    assert psrv.decode_stats.as_dict() == rsrv.decode_stats.as_dict() == {
        "batched": 1, "single": 0, "dispatches": 1, "archives": 3,
        "max_width": 3}
    assert ptel.counters == rtel.counters
    assert ptel.counters["serve.requests"] == len(names)
    # the aux closure of w is cached under the reference's key
    assert pkeys == rkeys and ("aux", "default", "precip") in pkeys
    for n, p, r in zip(names, pout, rout):
        assert p.tobytes() == decoded[n].tobytes(), n
        assert np.abs(p.astype(np.float64) - r).max() <= 1e-3 * ebs[n], n


def test_port_serves_a_container_the_reference_wrote(tmp_path, snap):
    path, decoded, _ = snap
    with arc_io.ArchiveReader(path) as r:
        meta = r.meta
        entries = {n: r.read_entry(n) for n in r.entries}
    ref_path = os.fspath(tmp_path / "ref.nlzs")
    app = ref_archive.ArchiveAppender(ref_path)
    for n in meta["field_order"]:
        app.add_entry(n, entries[n])
    app.finalize(meta)
    with serve.ArchiveServer(ref_path, max_bytes=GIB, device="cpu") as srv:
        for n in NAMES:
            assert srv.decode(n).tobytes() == decoded[n].tobytes(), n


def test_aux_closure_is_cached_and_pinned_while_its_dependant_decodes(
        snap, monkeypatch):
    path, decoded, _ = snap
    arc = repro_torch.Archive.open(path, device="cpu")
    srv = serve.ArchiveServer(arc, max_bytes=GIB, device="cpu")
    assert srv.decode("w").tobytes() == decoded["w"].tobytes()
    akey = ("aux", "default", "precip")
    assert akey in srv.cache and not srv.cache.pinned(akey)
    srv.cache.invalidate(("default", "w", None))
    seen, real = [], registry.decompress_many

    def spy(conv, **kw):
        seen.append((sorted(conv), srv.cache.pinned(akey)))
        return real(conv, **kw)
    monkeypatch.setattr(registry, "decompress_many", spy)
    n_reads = len(arc.reader.entry_reads)
    assert srv.decode("w").tobytes() == decoded["w"].tobytes()
    assert "precip" not in arc.reader.entry_reads[n_reads:]
    assert seen == [([("default", "w")], True)]
    assert not srv.cache.pinned(akey)
    srv.close(close_archives=True)


@pytest.fixture(scope="module")
def lorenzo_arc():
    """A whole-dict ``szlike-lorenzo`` archive of the fields and its decode."""
    arc = repro_torch.NeurLZ(compressor="szlike-lorenzo", epochs=EPOCHS,
                             device="cpu").compress(FIELDS, rel_eb=REL_EB)
    return arc.to_dict(), arc.decode_all()


def test_two_archives_two_decode_keys_roi_and_hot_hits(snap, lorenzo_arc):
    """The chip run's burst at small size: six fields of two archives are
    two stacked conventional decodes; a ROI and a hot hit after it."""
    path, decoded, _ = snap
    lz, lz_dec = lorenzo_arc
    tel = repro_torch.Telemetry()
    cap = 2 * FIELDS["w"].nbytes + 100      # holds two decoded fields
    srv = serve.ArchiveServer({"interp": path, "lorenzo": lz}, max_bytes=cap,
                              auto_start=False, telemetry=tel, device="cpu")
    # Interp last: its fields are the ones the cache still holds after.
    want = {("lorenzo", n): lz_dec[n] for n in NAMES}
    want.update({("interp", n): decoded[n] for n in NAMES})
    futs = [(k, srv.submit(k[1], archive_id=k[0])) for k in want]
    futs += [(k, srv.submit("w", archive_id=k[0]))
             for k in (("lorenzo", "w"), ("interp", "w"))]
    srv.start()
    for k, f in futs:
        assert f.result(120).tobytes() == want[k].tobytes(), k
    assert srv.decode_stats.as_dict() == {
        "batched": 2, "single": 0, "dispatches": 2, "archives": 6,
        "max_width": 3}
    assert srv.ledger.current <= cap
    assert tel.counters["serve.cache.evictions"] > 0
    hot = next(k for k in srv.cache.keys if k[0] == "interp")
    hits, reads = (tel.counters.get(k, 0)
                   for k in ("serve.cache.hits", "archive.entry_reads"))
    assert srv.decode(hot[1], archive_id="interp").tobytes() \
        == decoded[hot[1]].tobytes()
    assert tel.counters["serve.cache.hits"] == hits + 1
    assert tel.counters["archive.entry_reads"] == reads
    roi = (slice(2, 6), slice(None), slice(0, 8))
    out = srv.decode("w", archive_id="interp", roi=roi)
    assert out.tobytes() == decoded["w"][roi].tobytes()
    with pytest.raises(ValueError):         # ambiguous without an id
        srv.submit("w")
    srv.close()
    assert srv.ledger.current == 0


def test_a_fault_fails_only_its_field_and_the_server_keeps_serving(
        snap, monkeypatch):
    path, decoded, _ = snap
    fc = repro_torch.FaultConfig(
        injector=repro_torch.FaultInjector({"serve.request": 0}))
    srv = serve.ArchiveServer(path, max_bytes=GIB, faults=fc,
                              telemetry=repro_torch.Telemetry(),
                              auto_start=False, device="cpu")
    futs = {n: srv.submit(n) for n in NAMES}
    srv.start()
    with pytest.raises(repro_torch.InjectedFault):
        futs[NAMES[0]].result(120)
    for n in NAMES[1:]:
        assert futs[n].result(120).tobytes() == decoded[n].tobytes(), n
    with pytest.raises(KeyError):
        srv.decode("no_such_field")
    assert srv.running
    # A failed conventional decode fails its batch's futures; no fallback.
    monkeypatch.setattr(registry, "decompress_many",
                        lambda *a, **k: (_ for _ in ()).throw(
                            RuntimeError("kernel launch failed")))
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        srv.decode(NAMES[0])
    monkeypatch.undo()
    assert srv.decode(NAMES[0]).tobytes() == decoded[NAMES[0]].tobytes()
    assert srv.stats()["counters"]["serve.request_errors"] == 3
    srv.close()


def test_a_closed_server_serves_what_was_queued_on_its_dispatcher(snap):
    path, decoded, _ = snap
    srv = serve.ArchiveServer(path, max_bytes=GIB, auto_start=False,
                              device="cpu")
    fut = srv.submit("cloud")
    srv.close()
    srv.close()                             # idempotent
    assert fut.result(0).tobytes() == decoded["cloud"].tobytes()
    assert not srv.running


# ---- threads ---------------------------------------------------------------------

class _RecordingSource:
    """A dict source that records the thread of every load."""

    def __init__(self, fields, on_device):
        self._inner = streaming.DictSource(fields)
        self.loads_on_device = on_device
        self.threads = []

    def names(self):
        return self._inner.names()

    def meta(self, name):
        return self._inner.meta(name)

    def load(self, name):
        self.threads.append(threading.current_thread())
        return self._inner.load(name)


@pytest.mark.parametrize("on_device", [False, True])
def test_a_source_that_loads_on_the_device_loads_on_the_calling_thread(
        on_device):
    src = _RecordingSource(FIELDS, on_device)
    streaming.compress(src, io.BytesIO(), REL_EB,
                       config=_cfg(group_size=1), device="cpu")
    me = threading.current_thread()
    assert len(src.threads) == len(NAMES)
    # Without the attribute the reader thread prefetches the later groups.
    assert all(t is me for t in src.threads) == on_device
    assert serve.ArchiveSource.loads_on_device is True


# ---- metrics, shims and helpers --------------------------------------------------

def test_metrics_equal_the_reference():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((6, 17, 13)).astype(np.float32)
    y = (x + 1e-2 * rng.standard_normal(x.shape)).astype(np.float32)
    x_nan = x.copy()
    x_nan[0, 0, :3] = np.nan
    for fn in ("psnr", "mae", "nrmse"):
        for a, b in ((x, y), (x_nan, y), (x, x)):
            assert getattr(metrics, fn)(a, b) == getattr(ref_metrics, fn)(a, b)
    for axis in (0, 2):
        assert metrics.dssim(x, y, slice_axis=axis) \
            == ref_metrics.dssim(x, y, slice_axis=axis)
    assert metrics.dssim(x[0], y[0]) == ref_metrics.dssim(x[0], y[0])
    assert metrics._ssim_2d(x[1], y[1], win=5) \
        == ref_metrics._ssim_2d(x[1], y[1], win=5)
    assert metrics.compression_ratio(x.nbytes, 1234.5) \
        == ref_metrics.compression_ratio(x.nbytes, 1234.5)
    assert metrics.bitrate_reduction(2.5, 1.75) \
        == ref_metrics.bitrate_reduction(2.5, 1.75)


def test_legacy_shims_warn_once_and_round_trip(tmp_path, snap, monkeypatch):
    path, decoded, _ = snap
    monkeypatch.setattr(neurlz, "_warned_shims", set())
    cfg = neurlz.NeurLZConfig(epochs=1)
    dst = os.fspath(tmp_path / "legacy.nlz")
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        arc = neurlz.compress({"w": FIELDS["w"]}, REL_EB, config=cfg,
                              device="cpu")
        dec = [neurlz.decompress(arc, "cpu") for _ in range(2)]
        assert neurlz.save(dst, arc) == neurlz.save(dst, arc) > 0
        back = [neurlz.load(dst) for _ in range(2)]
        lazy = neurlz.load(path, device="cpu")
        neurlz.save(os.fspath(tmp_path / "whole.nlz"), lazy)
    msgs = [str(w.message) for w in got
            if issubclass(w.category, DeprecationWarning)]
    assert len(msgs) == 4
    for fn in ("compress", "decompress", "save", "load"):
        assert sum(f"core.{fn}()" in m for m in msgs) == 1, fn
    assert isinstance(lazy, repro_torch.Archive) and lazy.streaming
    assert lazy.decode("w").tobytes() == decoded["w"].tobytes()
    lazy.close()
    assert arc_io.dumps(back[0]) == arc_io.dumps(arc)
    assert dec[0]["w"].tobytes() == dec[1]["w"].tobytes() \
        == repro_torch.Archive(arc, device="cpu").decode("w").tobytes()
    whole = arc_io.load(os.fspath(tmp_path / "whole.nlz"))
    assert arc_io.dumps(whole["fields"]) == arc_io.dumps(
        repro_torch.Archive.open(path, device="cpu").to_dict()["fields"])


def test_small_helpers_match_the_reference(tmp_path, snap):
    path, _, _ = snap
    assert [e.name for e in registry.entries()] \
        == [e.name for e in ref_registry.entries()] == registry.names()
    whole = os.fspath(tmp_path / "w.nlz")
    repro_torch.Archive.open(path, device="cpu").save(whole)
    dict_file = os.fspath(tmp_path / "d.nlz")
    arc_io.save(dict_file, {"kind": "neurlz", "n": [1, 2.5, "x"]})
    assert arc_io.load(dict_file) == ref_archive.load(dict_file)
    for c_in in (1, 2):
        cfg = skipping_dnn.SkippingDNNConfig(c_in=c_in)
        ref_cfg = ref_dnn.SkippingDNNConfig(c_in=c_in)
        n = ref_dnn.param_count(ref_dnn.init_params(jax.random.PRNGKey(0),
                                                    ref_cfg))
        assert skipping_dnn.param_count(skipping_dnn.init_params(cfg)) == n
        assert skipping_dnn.param_count(
            skipping_dnn.SkippingDNN(cfg, device="cpu")) == n
    sess = repro_torch.NeurLZ(epochs=3, device="cpu").replace(epochs=5,
                                                              mode="relaxed")
    assert (sess.model.epochs, sess.regulation.mode, str(sess.device)) \
        == (5, "relaxed", "cpu")
    spec = {"w": repro_torch.ErrorBound(abs=0.5)}
    got = repro_torch.api.resolve_bounds(NAMES, spec, 1e-3, None)
    want = ref_bounds.resolve_bounds(NAMES, spec and {
        "w": ref_bounds.ErrorBound(abs=0.5)}, 1e-3, None)
    assert {n: (b.rel, b.abs, b.mode) for n, b in got.items()} \
        == {n: (b.rel, b.abs, b.mode) for n, b in want.items()}
