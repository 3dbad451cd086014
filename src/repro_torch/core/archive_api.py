"""``Archive``: a handle over one compressed snapshot, whichever container
holds it.

One object wraps either a **whole-dict** archive (what the serial engine
returns and :func:`repro_torch.core.archive.save` writes) or a **streaming**
``NLZSTRM1``/``NLZSTRM2`` container (records written one entry at a time by
:class:`~repro_torch.core.archive.ArchiveAppender`), and gives one surface:

* ``Archive.open(path)`` sniffs the format.  A container opens lazily: only
  its index footer is read, no entry until one is asked for.
  ``repair=True`` rebuilds the index of a footerless or torn container by
  scanning its records (:attr:`salvaged`, :attr:`damage`).
* ``decode(name, roi=None)`` reads that field's entry and its cross-field
  aux closure and decodes only those; ``roi`` (slices) cuts the result, and
  on a field that a ``BlockedSource`` split into blocks
  (:attr:`block_manifest`) reads and decodes only the blocks that cover
  it.  ``decode_all()`` decodes every field, on a container one field at a
  time with only the live aux set resident
  (:func:`repro_torch.streaming.pipeline.iter_decompress`).
* ``bitrate()``, ``save(path)``, ``verify()``, ``to_dict()``.

Files written by either package open in the other.  The handle is also a
read-only mapping over the whole-dict archive's keys; on a container those
values materialize on first access.  Decoding runs on the handle's device
(``cuda`` unless the caller asks for the CPU).  ``telemetry`` traces decodes
(``decode`` spans, the ``archive.entry_reads`` counter); ``faults`` retries
transient entry reads (site ``"decode.entry"``).
"""
from __future__ import annotations

import os
import shutil
from collections.abc import Mapping

import numpy as np

from .. import compressors
from .. import device as device_lib
from .. import faults as faults_lib
from ..obs import telemetry as obs_lib
from . import archive as arc_io
from . import neurlz

_TOP_KEYS = ("kind", "fields", "slice_axis", "compressor", "timing",
             "bitrate")


def normalize_roi(roi, ndim: int) -> tuple:
    """A region of interest as a full tuple of slices.

    ``roi`` is a slice or a tuple of slices (a shorter tuple extends with
    ``slice(None)`` on the trailing axes, as numpy basic indexing does).
    Integers are refused: a ROI decode keeps the field's rank, so reads of
    covering blocks compose with further slicing.
    """
    if isinstance(roi, slice):
        roi = (roi,)
    if not isinstance(roi, tuple):
        raise TypeError(f"roi must be a slice or tuple of slices, "
                        f"got {type(roi).__name__}")
    if len(roi) > ndim:
        raise ValueError(f"roi has {len(roi)} axes for a {ndim}-d field")
    for s in roi:
        if not isinstance(s, slice):
            raise TypeError("roi entries must be slices (integers would "
                            f"drop an axis), got {type(s).__name__}")
    return roi + (slice(None),) * (ndim - len(roi))


class Archive(Mapping):
    def __init__(self, arc: dict | None = None, *, reader=None,
                 path: str | None = None, device=None):
        if (arc is None) == (reader is None):
            raise ValueError("construct via Archive.open / Archive.from_dict")
        self._arc = arc                    # whole-dict backend
        self._reader = reader              # container backend (ArchiveReader)
        self._path = path
        self._entries: dict[str, dict] = {}     # container: cached entries
        self._bitrate: dict | None = None
        self.device = device_lib.resolve(device)
        self.telemetry = obs_lib.NULL      # a Telemetry handle traces decodes
        self.faults = faults_lib.DEFAULT   # a FaultConfig retries entry reads
        self.report: dict | None = None    # the compression report, if any

    # -- constructors -------------------------------------------------------

    @classmethod
    def open(cls, source, *, repair: bool = False, device=None) -> "Archive":
        """Open either container format from a path or a binary file object.

        A streaming container opens lazily (its footer only); a whole-dict
        file is one msgpack document and loads whole.  ``repair=True``
        (containers only) rebuilds the index by scanning the records, to
        open a footerless or truncated container from a crashed run."""
        device = device_lib.resolve(device)
        if isinstance(source, (str, bytes, os.PathLike)):
            path = os.fspath(source)
            if arc_io.is_streaming_archive(source):
                return cls(reader=arc_io.ArchiveReader(source, repair=repair),
                           path=path, device=device)
            with open(source, "rb") as f:
                return cls(arc_io.loads(f.read()), path=path, device=device)
        source.seek(0)          # sniff from the start, wherever the caller
        head = source.read(8)   # left the position
        source.seek(0)
        if arc_io.is_streaming_archive(head):
            return cls(reader=arc_io.ArchiveReader(source, repair=repair),
                       device=device)
        return cls(arc_io.loads(source.read()), device=device)

    @classmethod
    def from_dict(cls, arc, *, device=None) -> "Archive":
        """Wrap an in-memory archive dict (no copy)."""
        if isinstance(arc, Archive):
            return arc
        return cls(arc, device=device)

    def on_device(self, device) -> "Archive":
        """This handle if it decodes on ``device``, else a handle over the
        same archive that does: a container reopened from its path, any
        other archive wrapped as its whole dict.  Telemetry and faults
        carry over."""
        device = device_lib.resolve(device)
        if device == self.device:
            return self
        if self.streaming and self._path is not None:
            out = Archive.open(self._path, repair=self.salvaged, device=device)
        else:
            out = Archive(self.to_dict(), device=device)
        out.telemetry, out.faults = self.telemetry, self.faults
        return out

    # -- introspection ------------------------------------------------------

    @property
    def streaming(self) -> bool:
        """True when backed by a streaming container (lazy entries)."""
        return self._reader is not None

    @property
    def path(self) -> str | None:
        return self._path

    @property
    def reader(self):
        """The :class:`~repro_torch.core.archive.ArchiveReader` of a
        container (None for a whole-dict archive); its ``entry_reads``
        lists every entry record read."""
        return self._reader

    @property
    def meta(self) -> dict:
        if self.streaming:
            return self._reader.meta
        return {k: self._arc[k] for k in ("slice_axis", "compressor")}

    @property
    def salvaged(self) -> bool:
        """True when opened with ``repair=True`` on an unsealed container."""
        return bool(self._reader is not None and self._reader.salvaged)

    @property
    def damage(self) -> list[dict]:
        """One ``{"offset", "error"}`` per unreadable stretch a repair scan
        skipped (empty otherwise)."""
        return [] if self._reader is None else list(self._reader.damage)

    def verify(self) -> dict:
        """Read every entry again through the checksum path:
        ``{"version", "sealed", "ok", "entries": {name: {"offset", "ok",
        "error"}}}``.  A whole-dict archive has no per-record checksums and
        reports ok (its msgpack load already checked the framing)."""
        if not self.streaming:
            return {"version": 0, "sealed": True, "ok": True,
                    "entries": {n: {"offset": None, "ok": True, "error": None}
                                for n in self.field_names}}
        source = self._path if self._path is not None else self._reader._f
        return arc_io.verify_container(source)

    @property
    def field_names(self) -> list[str]:
        """Entry names in snapshot order (the footer's, or the prelude's on
        a salvaged container, restricted to the entries it holds)."""
        if self.streaming:
            order = self._reader.meta.get("field_order")
            if order is None:       # salvaged without a prelude: record order
                return list(self._reader.entries)
            if self.salvaged:       # the prelude lists the planned order
                return [n for n in order if n in self._reader.entries]
            return list(order)
        return list(self._arc["fields"])

    @property
    def block_manifest(self) -> dict:
        """Reassembly manifest of the fields that a ``BlockedSource`` split
        (empty when none was): original name -> ``{"axis", "blocks":
        [(entry, lo, hi)]}``."""
        if self.streaming:
            return dict(self._reader.meta.get("blocks") or {})
        return {}

    def entry(self, name: str) -> dict:
        """One field's raw entry (on a container: read once, then cached)."""
        if not self.streaming:
            return self._arc["fields"][name]
        if name not in self._entries:
            self._entries[name] = self._read_entry(name)
            self.telemetry.counter("archive.entry_reads").add()
        return self._entries[name]

    def _read_entry(self, name: str) -> dict:
        """An entry read through the fault layer: probes the injection site
        ``"decode.entry"`` and retries under the configured policy."""
        return self.faults.run(lambda: self._reader.read_entry(name),
                               site="decode.entry", tel=self.telemetry)

    def _entry_transient(self, name: str) -> dict:
        """An entry read without caching it (a cached copy is reused), so a
        sweep over a large container leaves no payload resident."""
        if not self.streaming or name in self._entries:
            return self.entry(name)
        self.telemetry.counter("archive.entry_reads").add()
        return self._read_entry(name)

    # -- decode -------------------------------------------------------------

    def decode(self, name: str, roi=None) -> np.ndarray:
        """Decode one field: its entry plus the conventional payloads of its
        aux fields, read transiently from a container (nothing else is
        read).  ``name`` may be a :attr:`block_manifest` original: its
        blocks are decoded and joined.

        ``roi`` (a slice or tuple of slices) restricts the result.  On a
        blocked original only the blocks that cover the slab along the
        split axis are read and decoded; a plain entry is self-contained,
        so its ROI is cut from a full decode."""
        man = self.block_manifest.get(name)
        if man is not None:
            return self._decode_blocked(man, roi)
        out = self._decode(name, {})[0]
        if roi is None:
            return out
        return out[normalize_roi(roi, out.ndim)]

    def _decode_blocked(self, man: dict, roi) -> np.ndarray:
        """Decode a ``BlockedSource`` original, reading only the blocks
        that cover ``roi``'s slab along the split axis."""
        axis, blocks = man["axis"], man["blocks"]
        if roi is None:
            parts = [self.decode(bn) for bn, _, _ in blocks]
            return np.concatenate(parts, axis=axis)
        extent = blocks[-1][2]                 # blocks partition [0, extent)
        bshape = tuple(self._reader.meta["shapes"][blocks[0][0]])
        roi = normalize_roi(roi, len(bshape))
        idx = np.arange(*roi[axis].indices(extent))
        if idx.size == 0:
            e = self._entry_transient(blocks[0][0])
            dtype = np.dtype(e["conv"].get("dtype", "float32"))
            shape = tuple(
                len(range(*s.indices(extent if i == axis else bshape[i])))
                for i, s in enumerate(roi))
            return np.empty(shape, dtype=dtype)
        lo_need, hi_need = int(idx.min()), int(idx.max()) + 1
        # Other-axis slices apply inside each block; the split axis is
        # gathered afterwards, so any step (negative ones too) works.
        sub = tuple(s if i != axis else slice(None)
                    for i, s in enumerate(roi))
        parts, base = [], None
        for bn, lo, hi in blocks:
            if hi <= lo_need or lo >= hi_need:
                continue                       # outside the slab: not read
            if base is None:
                base = lo
            parts.append(self.decode(bn, roi=sub))
        cat = parts[0] if len(parts) == 1 else np.concatenate(parts,
                                                              axis=axis)
        return np.take(cat, idx - base, axis=axis)

    def _decode(self, name: str, recs: dict) -> tuple[np.ndarray, list]:
        """Decode ``name``; the conventional reconstructions of it and of its
        aux fields that ``recs`` lacks are decoded in one call and added to
        ``recs``.  Returns the field and its aux names."""
        with self.telemetry.span("decode", field=name):
            e = self._entry_transient(name)
            due = {}
            for n in dict.fromkeys([name, *e["aux"]]):
                if n not in recs:
                    due[n] = (e if n == name else self._entry_transient(n))["conv"]
            recs.update(compressors.decompress_many(due, device=self.device))
            out = neurlz.decode_field_entry(e, recs[name],
                                            [recs[a] for a in e["aux"]],
                                            self["slice_axis"], self.device)
        return out, e["aux"]

    def decode_all(self, *, engine: str = "serial",
                   reassemble: bool = False) -> dict[str, np.ndarray]:
        """Decode every field.  A container decodes one field at a time
        (:func:`repro_torch.streaming.pipeline.iter_decompress`) through
        transient reads, keeping only the reconstructions a later field
        still needs as aux (the footer's ``aux`` map counts them).
        ``engine="batched"`` decodes the same way: the batched engine's
        decode is the serial one
        (:func:`repro_torch.core.batched_engine.decompress`).
        ``reassemble=True`` joins ``BlockedSource`` blocks back into their
        original fields."""
        if engine not in ("serial", "batched"):
            raise ValueError(f"unknown decode engine {engine!r}")
        if not self.streaming:
            return neurlz.decompress_impl(self._arc, self.device)
        from ..streaming import pipeline
        return dict(pipeline.iter_decompress(self, reassemble=reassemble))

    # -- accounting / persistence ------------------------------------------

    def _num_points(self, name: str) -> int:
        if self.streaming:
            return int(np.prod(self._reader.meta["shapes"][name]))
        return int(np.prod(self._arc["fields"][name]["conv"]["shape"]))

    def bitrate(self, name: str | None = None) -> dict:
        """Paper bit-rate accounting of one field, or of all.  On a
        container each entry is read transiently, so nothing stays
        resident."""
        have_table = self._arc is not None and "bitrate" in self._arc
        if name is not None:
            if have_table:
                return self._arc["bitrate"][name]
            view = {"fields": {name: self._entry_transient(name)}}
            return neurlz.field_bitrate(view, name, self._num_points(name))
        if self._bitrate is None:
            self._bitrate = (self._arc["bitrate"] if have_table else
                             {n: self.bitrate(n) for n in self.field_names})
        return self._bitrate

    def to_dict(self) -> dict:
        """The whole-dict archive (on a container: every entry read, in the
        footer's field order, packing to the in-memory engine's bytes)."""
        if self._arc is None:
            self._arc = neurlz.assemble_streaming_archive(self._reader)
        return self._arc

    def save(self, path) -> int:
        """Write the archive to ``path`` in its own container format;
        returns bytes written.  A streaming container is copied byte for
        byte (no entry is decoded)."""
        path = os.fspath(path)
        if not self.streaming:
            return arc_io.save(path, self._arc)
        if self._path is not None:
            shutil.copyfile(self._path, path)
            return os.path.getsize(path)
        f = self._reader._f
        pos = f.tell()
        f.seek(0)
        with open(path, "wb") as out:
            shutil.copyfileobj(f, out)
        f.seek(pos)
        return os.path.getsize(path)

    def close(self) -> None:
        if self._reader is not None:
            self._reader.close()

    def __del__(self):
        # Releases the container's file where a caller rebinds handles
        # without closing them; the context manager is the usual form.
        try:
            self.close()
        except Exception:
            pass

    def __enter__(self) -> "Archive":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- read-only Mapping over the whole-dict archive keys -----------------

    def __getitem__(self, key):
        if not self.streaming:
            return self._arc[key]
        if key == "kind":
            return "neurlz"
        if key in ("slice_axis", "compressor"):
            return self._reader.meta[key]
        if key == "timing":
            return self._reader.meta.get("timing", {})
        if key == "fields":
            return self.to_dict()["fields"]
        if key == "bitrate":
            return self.bitrate()
        raise KeyError(key)

    def __iter__(self):
        return iter(_TOP_KEYS if self.streaming else self._arc)

    def __len__(self) -> int:
        return len(_TOP_KEYS) if self.streaming else len(self._arc)

    def __repr__(self) -> str:
        kind = "streaming" if self.streaming else "dict"
        where = f" path={self._path!r}" if self._path else ""
        return (f"<Archive {kind}{where} fields={len(self.field_names)} "
                f"device={self.device}>")
