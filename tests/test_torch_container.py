"""The port's streaming containers (``NLZSTRM1``/``NLZSTRM2``) against the
JAX package's: byte-identical writes for the same records, each package
reading the other's, and the same salvage scan, verification and error
offsets on torn and corrupted containers (the torn-write matrix of
``tests/test_crash_recovery.py``).  Then ``Archive`` over a container: a
lazy open, transient entry reads through the fault layer, ``verify`` and
``repair=True``.
"""
import io
import os

import numpy as np
import pytest
import torch

import repro_torch
from repro.core import archive as ref_archive
from repro_torch.core import archive as port_archive
from repro_torch.core import neurlz
from repro_torch.data import fields as port_fields

# The suite runs in parallel workers on a few cores: one intra-op thread
# per worker keeps the port's tests from crowding out the others.
torch.set_num_threads(1)

SHAPE = (9, 20, 24)      # the shape of the port's other tests
FIELDS = port_fields.make_fields("hurricane", SHAPE, seed=1)
PACKAGES = {"port": port_archive, "ref": ref_archive}


@pytest.fixture(scope="module")
def snapshot():
    """A port archive of the snapshot (1 epoch, CPU) with ``cloud``
    learning from ``w``, its entries written as they would be streamed."""
    cfg = neurlz.NeurLZConfig(epochs=1, cross_field={"cloud": ("w",)})
    arc = neurlz.compress_impl(FIELDS, 1e-3, config=cfg, device="cpu")
    meta = {"field_order": list(FIELDS),
            "shapes": {n: list(x.shape) for n, x in FIELDS.items()},
            "slice_axis": 0, "compressor": "szlike",
            "aux": {n: list(e["aux"]) for n, e in arc["fields"].items()},
            "timing": {"total_s": 1.5, "conv_stage": {"calls": 3}}}
    return arc, meta


def _write(pkg, sink, arc, meta, **kw):
    app = pkg.ArchiveAppender(sink, **kw)
    for name in reversed(meta["field_order"]):   # out of snapshot order
        app.add_entry(name, arc["fields"][name])
    return app.finalize(meta)


def _container(pkg, tmp_path, snapshot, name="snap.nlz", **kw):
    arc, meta = snapshot
    path = os.fspath(tmp_path / name)
    _write(pkg, path, arc, meta, **kw)
    return path


CONTAINER_KINDS = ([(1, d, False) for d in ("none", "flush", "fsync")]
                   + [(2, d, p) for d in ("none", "flush", "fsync")
                      for p in (False, True)])


@pytest.mark.parametrize("version,durability,prelude", CONTAINER_KINDS)
def test_appender_writes_the_reference_bytes(tmp_path, snapshot, version,
                                             durability, prelude):
    arc, meta = snapshot
    kw = {"version": version, "durability": durability,
          "prelude": ({k: meta[k] for k in ("field_order", "shapes", "aux")}
                      if prelude else None)}
    got = {}
    for tag, pkg in PACKAGES.items():
        path = os.fspath(tmp_path / f"{tag}.nlz")
        size = _write(pkg, path, arc, meta, **kw)
        buf = io.BytesIO()
        assert _write(pkg, buf, arc, meta, **kw) == size
        data = open(path, "rb").read()
        assert buf.getvalue() == data and len(data) == size
        got[tag] = data
    assert got["port"] == got["ref"]


@pytest.mark.parametrize("version", [1, 2])
def test_each_package_reads_the_others_container(tmp_path, snapshot, version):
    arc, meta = snapshot
    for writer, reader in (("port", "ref"), ("ref", "port")):
        path = _container(PACKAGES[writer], tmp_path, snapshot,
                          name=f"{writer}.nlz", version=version)
        with PACKAGES[reader].ArchiveReader(path) as r:
            assert r.version == version
            assert r.meta == meta
            assert list(r.entries) == list(reversed(meta["field_order"]))
            for name in meta["field_order"]:
                assert (ref_archive.dumps(r.read_entry(name))
                        == ref_archive.dumps(arc["fields"][name]))
            assert r.entry_reads == meta["field_order"]


def _same_error(path, **kw):
    """Open ``path`` with both packages' readers: both raise the same
    message and offset, or both open."""
    seen = []
    for pkg in PACKAGES.values():
        try:
            pkg.ArchiveReader(path, **kw).close()
            seen.append(None)
        except pkg.CorruptArchiveError as e:
            seen.append((str(e), e.offset, e.path))
    assert seen[0] == seen[1]
    return seen[0]


def test_torn_write_matrix_agrees_with_reference(tmp_path, snapshot):
    """Cut a v2 container at a sweep of offsets and at every record end:
    neither package opens it sealed, both raise the same error and offset,
    and both salvage exactly the fully written entries, bit for bit."""
    path = _container(port_archive, tmp_path, snapshot,
                      prelude={"field_order": list(FIELDS)})
    data = open(path, "rb").read()
    with port_archive.ArchiveReader(path) as r:
        full = {n: ref_archive.dumps(r.read_entry(n)) for n in r.entries}
        ends = {n: off + port_archive._V2_PREFIX + ln
                for n, (off, ln) in r.entries.items()}
    torn = os.fspath(tmp_path / "torn.nlz")
    cuts = sorted(set(range(9, len(data) - 1, max(1, len(data) // 40)))
                  | set(ends.values()))
    for cut in cuts:
        with open(torn, "wb") as f:
            f.write(data[:cut])
        assert _same_error(torn) is not None, f"cut={cut}"
        scans = [pkg.scan_container(torn) for pkg in PACKAGES.values()]
        assert scans[0] == scans[1], f"cut={cut}"
        with port_archive.ArchiveReader(torn, repair=True) as r:
            assert r.salvaged
            assert set(r.entries) == {n for n, e in ends.items() if e <= cut}
            for n in r.entries:
                assert ref_archive.dumps(r.read_entry(n)) == full[n]
        reports = [pkg.verify_container(torn) for pkg in PACKAGES.values()]
        assert reports[0] == reports[1] and not reports[0]["sealed"]


@pytest.mark.parametrize("where", ["payload", "header"])
def test_verify_pinpoints_a_flipped_bit_as_the_reference(tmp_path, snapshot,
                                                         where):
    path = _container(port_archive, tmp_path, snapshot)
    with port_archive.ArchiveReader(path) as r:
        victim, (off, ln) = sorted(r.entries.items(),
                                   key=lambda kv: kv[1][0])[1]
    data = bytearray(open(path, "rb").read())
    pos = (off + port_archive._V2_PREFIX + ln // 2 if where == "payload"
           else off)
    data[pos] ^= 0x01
    open(path, "wb").write(bytes(data))
    reports = [pkg.verify_container(path) for pkg in PACKAGES.values()]
    assert reports[0] == reports[1]
    rep = reports[0]
    assert rep["sealed"] and not rep["ok"]
    for name, e in rep["entries"].items():
        assert e["ok"] == (name != victim), name
    assert rep["entries"][victim]["offset"] == off
    errs = []
    for pkg in PACKAGES.values():
        with pkg.ArchiveReader(path) as r:
            with pytest.raises(pkg.CorruptArchiveError) as ei:
                r.read_entry(victim)
            errs.append((str(ei.value), ei.value.offset))
    assert errs[0] == errs[1] and errs[0][1] == off
    # The scan resyncs past the damaged record and keeps the others.
    scans = [pkg.scan_container(path) for pkg in PACKAGES.values()]
    assert scans[0] == scans[1]
    assert set(scans[0]["entries"]) == set(FIELDS) - {victim}
    assert any(d["offset"] <= off for d in scans[0]["damage"])


@pytest.mark.parametrize("blob", [
    b"", b"NL", b"NLZSTRM2", b"NLZSTRM2" + b"\x00" * 4,
    b"garbage-not-a-container-at-all", b"NLZSTRM9" + b"\x00" * 64,
])
def test_corrupt_open_raises_the_reference_error(tmp_path, blob):
    path = os.fspath(tmp_path / "bad.nlz")
    open(path, "wb").write(blob)
    assert (port_archive.is_streaming_archive(path)
            == ref_archive.is_streaming_archive(path))
    assert _same_error(path) is not None


def test_rewind_and_abort_as_the_reference(tmp_path):
    """A rewound record leaves no bytes behind; an aborted container is
    footerless, refuses a sealed open and salvages its entries."""
    out = {}
    for tag, pkg in PACKAGES.items():
        buf = io.BytesIO()
        app = pkg.ArchiveAppender(buf, prelude={"field_order": ["a", "b"]})
        app.add_entry("a", {"conv": {"blob": b"A" * 24}})
        boundary = app.bytes_written
        app.add_entry("junk", {"conv": {"blob": b"J" * 100}})
        app.rewind(boundary)
        assert app.bytes_written == boundary and "junk" not in app.entries
        app.add_entry("b", {"conv": {"blob": np.arange(5.0)}})
        app.finalize({"field_order": ["a", "b"]})
        path = os.fspath(tmp_path / f"{tag}_aborted.nlz")
        app = pkg.ArchiveAppender(path, durability="fsync",
                                  prelude={"field_order": ["a", "b"]})
        app.add_entry("a", {"conv": {"blob": b"A" * 24}})
        app.abort()
        out[tag] = (buf.getvalue(), open(path, "rb").read())
    assert out["port"] == out["ref"]
    sealed, aborted = out["port"]
    with port_archive.ArchiveReader(io.BytesIO(sealed)) as r:
        assert list(r.entries) == ["a", "b"]
        assert np.array_equal(r.read_entry("b")["conv"]["blob"], np.arange(5.0))
    path = os.fspath(tmp_path / "port_aborted.nlz")
    assert _same_error(path) is not None
    with port_archive.ArchiveReader(path, repair=True) as r:
        assert r.salvaged and list(r.entries) == ["a"]
        assert r.prelude == {"field_order": ["a", "b"]}


def test_bad_appender_knobs_raise():
    for kw in ({"version": 3}, {"durability": "sometimes"},
               {"checksum": "md5"}, {"version": 1, "prelude": {"x": 1}}):
        with pytest.raises(ValueError):
            port_archive.ArchiveAppender(io.BytesIO(), **kw)


# -- Archive over a container -----------------------------------------------

def test_archive_opens_a_container_lazily(tmp_path, snapshot):
    arc, meta = snapshot
    path = _container(port_archive, tmp_path, snapshot)
    want = repro_torch.Archive.from_dict(arc, device="cpu").decode_all()
    tel = repro_torch.Telemetry()
    with repro_torch.open(path, device="cpu") as opened:
        opened.telemetry = tel
        assert opened.streaming and not opened.salvaged
        assert opened.reader.entry_reads == []
        assert opened.field_names == meta["field_order"]
        assert opened["timing"] == meta["timing"]
        # cloud reads its aux producer w, transiently: nothing is cached.
        assert np.array_equal(opened.decode("cloud"), want["cloud"])
        assert opened.reader.entry_reads == ["cloud", "w"]
        assert opened.bitrate() == arc["bitrate"]
        dec = opened.decode_all()
        assert list(dec) == meta["field_order"]
        for name in FIELDS:
            assert np.array_equal(dec[name], want[name])
        # Every read so far went through the handle's counter; w's
        # reconstruction stayed resident from cloud's decode to its own.
        assert opened.reader.entry_reads[-4:] == ["cloud", "w", "precip", "w"]
        assert tel.counters["archive.entry_reads"] == 9
        assert ref_archive.dumps(opened.to_dict()["fields"]) == \
            ref_archive.dumps(arc["fields"])
        assert opened.verify()["ok"]
        copy = os.fspath(tmp_path / "copy.nlz")
        assert opened.save(copy) == os.path.getsize(path)
        assert open(copy, "rb").read() == open(path, "rb").read()
    assert tel.span_summary()["decode"]["count"] == 1 + len(FIELDS)
    # A region of a plain entry is cut from its full decode; no field of
    # this container was split into blocks.
    with repro_torch.open(path, device="cpu") as opened:
        assert np.array_equal(opened.decode("w", roi=(slice(0, 2),)),
                              want["w"][:2])
        assert opened.block_manifest == {}


def test_archive_retries_a_transient_entry_read(tmp_path, snapshot):
    path = _container(port_archive, tmp_path, snapshot)
    inj = repro_torch.FaultInjector({"decode.entry": [0, 2]})
    tel = repro_torch.Telemetry()
    with repro_torch.Archive.open(path, device="cpu") as opened:
        opened.telemetry, opened.faults = tel, repro_torch.FaultConfig(
            injector=inj, retry=repro_torch.RetryPolicy(backoff_s=0.0))
        opened.decode("precip")
        opened.decode("w")
    assert inj.hits == [("decode.entry", 0), ("decode.entry", 2)]
    assert tel.counters["faults.retries"] == 2
    assert tel.counters["faults.retries.decode.entry"] == 2
    # Without a retry policy the injected fault surfaces.
    with repro_torch.Archive.open(path, device="cpu") as opened:
        opened.faults = repro_torch.FaultConfig(
            injector=repro_torch.FaultInjector({"decode.entry": 0}))
        with pytest.raises(repro_torch.InjectedFault):
            opened.decode("w")


def test_archive_salvages_a_container_cut_before_its_footer(tmp_path, snapshot):
    arc, meta = snapshot
    path = _container(port_archive, tmp_path, snapshot, durability="fsync",
                      prelude={k: meta[k] for k in ("field_order", "shapes",
                                                    "slice_axis", "compressor",
                                                    "aux")})
    with port_archive.ArchiveReader(path) as r:
        foot = max(off + port_archive._V2_PREFIX + ln
                   for off, ln in r.entries.values())
        second = sorted(r.entries.values())[1][0]
    data = open(path, "rb").read()
    want = repro_torch.Archive.from_dict(arc, device="cpu").decode_all()
    for cut, names in ((foot, meta["field_order"]), (second + 40, ["w"])):
        torn = os.fspath(tmp_path / "torn.nlz")
        open(torn, "wb").write(data[:cut])
        with pytest.raises(repro_torch.CorruptArchiveError):
            repro_torch.Archive.open(torn, device="cpu")
        with repro_torch.Archive.open(torn, repair=True, device="cpu") as opened:
            assert opened.salvaged and opened.field_names == names
            assert opened.verify()["sealed"] is False
            dec = opened.decode_all()
            for name in names:
                assert np.array_equal(dec[name], want[name])
