"""NeurLZ archive serialization (paper Fig. 2, file format).

An archive holds, for every field, the conventional payload, the enhancer
weights, the outlier coordinates and the normalization stats.  The port
carries its own packer and unpacker for the subset of msgpack an archive
uses — nil, bool, int, float64, str, bin, array, map, and numpy arrays as
the ``{b"__nd__": True, ...}`` map — because it must run where no msgpack
wheel is installed.  Its bytes equal
``msgpack.packb(obj, default=_default, use_bin_type=True)`` of the JAX
package, so files written by either package open in the other.

Three container formats, as in the JAX package:

* **whole-dict** — one msgpack document for the whole archive (:func:`save`).
* **streaming v1** (``NLZSTRM1``) — an 8-byte magic, length-prefixed msgpack
  records (one per field entry, in the order they were appended), an index
  footer record (field name → ``[offset, length]`` plus snapshot metadata),
  the footer's offset and the magic again as a trailer.
  :class:`ArchiveReader` reads the footer, then one entry at a time.
* **streaming v2** (``NLZSTRM2``) — the durable container: the same
  topology, but every record is self-delimiting (an 8-byte sync marker, a
  checksum-algorithm flag byte, the payload length and a CRC-32 of the
  payload precede it), and an optional **prelude** record after the magic
  carries the snapshot's static metadata, so a container whose footer was
  never written still says what it holds.  :func:`scan_container` /
  ``ArchiveReader(..., repair=True)`` walk a footerless or torn container
  record by record, resynchronizing on the sync marker, and salvage every
  intact entry; :func:`verify_container` names a corrupt entry and its
  offset.  :class:`ArchiveAppender`'s ``durability`` (``"none"``,
  ``"flush"``, ``"fsync"``) sets how eagerly records reach the disk.

For the same records, every container this module writes is byte-identical
to the JAX package's ``repro.core.archive``.
"""
from __future__ import annotations

import io
import os
import struct
import zlib

import numpy as np
import torch

from ..compressors import codec

_F64 = struct.Struct(">d")


def _default(obj):
    """Map the numpy types the archive may hold onto msgpack types."""
    if isinstance(obj, np.ndarray):
        return {b"__nd__": True, b"dtype": str(obj.dtype),
                b"shape": list(obj.shape), b"data": obj.tobytes()}
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.bool_):
        return bool(obj)
    raise TypeError(f"cannot serialize {type(obj)}")


def _hook(obj: dict):
    if b"__nd__" in obj:
        return np.frombuffer(obj[b"data"], dtype=obj[b"dtype"]
                             ).reshape(obj[b"shape"]).copy()
    return obj


def _pack_int(v: int, out: bytearray) -> None:
    if v < -(1 << 5):
        if v < -(1 << 15):
            if v < -(1 << 31):
                if v < -(1 << 63):
                    raise OverflowError("Integer value out of range")
                out += b"\xd3" + struct.pack(">q", v)
            else:
                out += b"\xd2" + struct.pack(">i", v)
        elif v < -(1 << 7):
            out += b"\xd1" + struct.pack(">h", v)
        else:
            out += b"\xd0" + struct.pack(">b", v)
    elif v < (1 << 7):
        out += struct.pack(">b", v)                 # positive/negative fixint
    elif v < (1 << 8):
        out += b"\xcc" + struct.pack(">B", v)
    elif v < (1 << 16):
        out += b"\xcd" + struct.pack(">H", v)
    elif v < (1 << 32):
        out += b"\xce" + struct.pack(">I", v)
    elif v < (1 << 64):
        out += b"\xcf" + struct.pack(">Q", v)
    else:
        raise OverflowError("Integer value out of range")


def _pack_len(n: int, fix: int, fix_max: int, codes: tuple, out: bytearray):
    """Header of a sized type: fix form, then 8/16/32-bit length forms
    (``codes`` lists the marker bytes for those; None where absent)."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
    elif codes[0] is not None and n < (1 << 8):
        out += bytes((codes[0], n))
    elif n < (1 << 16):
        out += bytes((codes[1],)) + struct.pack(">H", n)
    elif n < (1 << 32):
        out += bytes((codes[2],)) + struct.pack(">I", n)
    else:
        raise ValueError("object too large for msgpack")


def _pack(obj, out: bytearray, default_used: bool = False) -> None:
    # Type order as msgpack's Packer: None, bools, int, float, bytes, str,
    # dict, list/tuple, then ``default`` once.
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += _F64.pack(obj)
    elif isinstance(obj, (bytes, bytearray)):
        _pack_len(len(obj), None, 0, (0xC4, 0xC5, 0xC6), out)
        out += obj
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_len(len(raw), 0xA0, 32, (0xD9, 0xDA, 0xDB), out)
        out += raw
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 16, (None, 0xDE, 0xDF), out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 16, (None, 0xDC, 0xDD), out)
        for v in obj:
            _pack(v, out)
    elif not default_used:
        _pack(_default(obj), out, default_used=True)
    else:
        raise TypeError(f"cannot serialize {type(obj)}")


def dumps(obj) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


# Type bytes the reader takes besides the fix forms: constants, numbers
# (struct format), and sized types (length format, kind).
_SIMPLE = {0xC0: None, 0xC2: False, 0xC3: True}
_NUMBERS = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
            0xCA: ">f", 0xCB: ">d"}
_SIZED = {0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
          0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
          0xDC: (">H", "arr"), 0xDD: (">I", "arr"),
          0xDE: (">H", "map"), 0xDF: (">I", "map")}


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        v = self.data[self.pos:self.pos + n]
        self.pos += n
        return v

    def unpack(self, fmt: str):
        st = struct.Struct(fmt)
        return st.unpack(self.take(st.size))[0]

    def obj(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.obj() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        if b in _SIMPLE:
            return _SIMPLE[b]
        if b in _NUMBERS:
            return self.unpack(_NUMBERS[b])
        if b not in _SIZED:
            raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")
        fmt, kind = _SIZED[b]
        n = self.unpack(fmt)
        if kind == "bin":
            return bytes(self.take(n))
        if kind == "str":
            return str(self.take(n), "utf-8")
        if kind == "arr":
            return [self.obj() for _ in range(n)]
        return self.map(n)

    def map(self, n: int):
        d = {}
        for _ in range(n):
            k = self.obj()
            d[k] = self.obj()
        return _hook(d)


def loads(data: bytes):
    r = _Reader(data)
    obj = r.obj()
    if r.pos != len(r.data):
        raise ValueError("extra data after msgpack document")
    return obj


def save(path: str, obj) -> int:
    data = dumps(obj)
    with open(path, "wb") as f:
        f.write(data)
    return len(data)


# ---------------------------------------------------------------------------
# Streaming containers (v1 and the durable v2): records + index footer
# ---------------------------------------------------------------------------

STREAM_MAGIC = b"NLZSTRM1"
STREAM_MAGIC_V2 = b"NLZSTRM2"
_MAGICS = (STREAM_MAGIC, STREAM_MAGIC_V2)
_LEN = struct.Struct("<Q")

# v2 record = SYNC(8) ‖ <BQI>(checksum-algorithm flag, payload length,
# checksum) ‖ msgpack payload.  The sync marker lets the salvage scan
# resynchronize past torn bytes; the flag keeps each record self-describing.
RECORD_SYNC = b"\xf9NLZREC\xa5"
_V2_HDR = struct.Struct("<BQI")
_V2_PREFIX = len(RECORD_SYNC) + _V2_HDR.size

#: name -> flag byte.  ``crc32`` is zlib's, always available; ``crc32c`` is
#: honoured only when the optional ``crc32c`` wheel imports, and is never
#: chosen by default, so every container stays verifiable everywhere.
CHECKSUM_ALGOS = {"crc32": 0, "crc32c": 1}

try:  # optional wheel; flag byte 1 in record headers
    import crc32c as _crc32c_mod
except ImportError:  # pragma: no cover - depends on the installation
    _crc32c_mod = None

_DURABILITY_LEVELS = ("none", "flush", "fsync")


class CorruptArchiveError(ValueError):
    """A streaming container (or one record in it) failed validation.

    Carries ``offset`` (byte position of the bad record, when known) and
    ``path``; raised instead of bare ``struct`` or msgpack errors on
    truncated or garbage input.
    """

    def __init__(self, message: str, *, offset: int | None = None,
                 path: str | None = None):
        ctx = []
        if path is not None:
            ctx.append(f"path={path!r}")
        if offset is not None:
            ctx.append(f"offset={offset}")
        super().__init__(message + (f" [{', '.join(ctx)}]" if ctx else ""))
        self.offset = offset
        self.path = path


def _checksum(algo: int, data: bytes) -> int:
    if algo == 0:
        return zlib.crc32(data) & 0xFFFFFFFF
    if algo == 1:
        if _crc32c_mod is None:
            raise RuntimeError(
                "archive record uses crc32c checksums but the optional "
                "'crc32c' wheel is not installed")
        return _crc32c_mod.crc32c(data) & 0xFFFFFFFF
    raise CorruptArchiveError(f"unknown checksum algorithm flag {algo}")


def _is_path(source) -> bool:
    return isinstance(source, (str, bytes, os.PathLike))


def is_streaming_archive(path_or_bytes) -> bool:
    """Sniff the streaming-container magic (path or leading bytes); False,
    never an exception, for short or garbage input."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        head = bytes(path_or_bytes[:8])
    else:
        try:
            with open(path_or_bytes, "rb") as f:
                head = f.read(8)
        except (OSError, TypeError, ValueError):
            return False
    return head in _MAGICS


def _read_record_at(f, offset: int, version: int, *, path=None):
    """Read and decode the record at ``offset``: ``(obj, payload_len,
    next_offset)``.  Truncation, a missing sync marker, a checksum mismatch
    and undecodable msgpack all raise :class:`CorruptArchiveError` with the
    offset."""
    f.seek(offset)
    if version == 1:
        hdr = f.read(_LEN.size)
        if len(hdr) < _LEN.size:
            raise CorruptArchiveError("truncated record header",
                                      offset=offset, path=path)
        (n,) = _LEN.unpack(hdr)
        body_off = offset + _LEN.size
    else:
        pre = f.read(_V2_PREFIX)
        if len(pre) < _V2_PREFIX:
            raise CorruptArchiveError("truncated record header",
                                      offset=offset, path=path)
        if pre[:len(RECORD_SYNC)] != RECORD_SYNC:
            raise CorruptArchiveError("missing record sync marker",
                                      offset=offset, path=path)
        algo, n, crc = _V2_HDR.unpack(pre[len(RECORD_SYNC):])
        body_off = offset + _V2_PREFIX
    payload = f.read(n)
    if len(payload) < n:
        raise CorruptArchiveError(
            f"truncated record payload ({len(payload)}/{n} bytes)",
            offset=offset, path=path)
    if version == 2 and _checksum(algo, payload) != crc:
        raise CorruptArchiveError("record checksum mismatch",
                                  offset=offset, path=path)
    try:
        obj = loads(payload)
    except Exception as e:
        raise CorruptArchiveError(f"undecodable record: {e}",
                                  offset=offset, path=path) from e
    return obj, n, body_off + n


def _find_sync(f, start: int, end: int, chunk: int = 1 << 16):
    """The next RECORD_SYNC at or after ``start`` (a chunked scan whose
    chunks overlap by a marker's length less one), or None."""
    overlap = len(RECORD_SYNC) - 1
    pos = start
    while pos < end:
        f.seek(pos)
        buf = f.read(min(chunk + overlap, end - pos))
        i = buf.find(RECORD_SYNC)
        if i >= 0:
            return pos + i
        if len(buf) <= overlap:
            return None
        pos += len(buf) - overlap
    return None


class ArchiveAppender:
    """Incremental streaming-container writer.

    ``add_entry`` appends one field's entry record; ``finalize`` seals the
    container with the index footer.  ``sink`` is a path or a binary file
    object.  ``version=2`` (default) writes ``NLZSTRM2``: per-record sync
    markers and checksums, an optional ``prelude`` metadata record readable
    before any entry lands, and a ``durability`` policy — ``"none"``
    (buffered), ``"flush"`` (a flush per entry) or ``"fsync"`` (a flush and
    an fsync per entry, so a sealed entry survives an OS crash, not only the
    process's death).  ``version=1`` writes the ``NLZSTRM1`` byte stream.
    """

    def __init__(self, sink, *, version: int = 2, durability: str = "none",
                 checksum: str = "crc32", prelude: dict | None = None):
        if version not in (1, 2):
            raise ValueError(f"unknown container version {version!r}")
        if durability not in _DURABILITY_LEVELS:
            raise ValueError(f"durability must be one of {_DURABILITY_LEVELS},"
                             f" got {durability!r}")
        if checksum not in CHECKSUM_ALGOS:
            raise ValueError(f"checksum must be one of "
                             f"{tuple(CHECKSUM_ALGOS)}, got {checksum!r}")
        if prelude is not None and version == 1:
            raise ValueError("prelude records require container version 2")
        self.version = version
        self.durability = durability
        self._algo = CHECKSUM_ALGOS[checksum]
        self._magic = STREAM_MAGIC if version == 1 else STREAM_MAGIC_V2
        self._own = _is_path(sink)
        self._f = open(sink, "wb") if self._own else sink
        self._f.write(self._magic)
        self._offset = len(self._magic)
        self.entries: dict[str, list[int]] = {}   # name -> [offset, length]
        self.bytes_written = self._offset
        if prelude is not None:
            self.append({"prelude": version, "meta": prelude})
            self._sync()

    def append(self, obj) -> tuple[int, int]:
        """Write one record; returns ``(offset, payload length)``."""
        data = dumps(obj)
        off = self._offset
        if self.version == 1:
            self._f.write(_LEN.pack(len(data)))
            self._f.write(data)
            self._offset += _LEN.size + len(data)
        else:
            crc = _checksum(self._algo, data)
            self._f.write(RECORD_SYNC)
            self._f.write(_V2_HDR.pack(self._algo, len(data), crc))
            self._f.write(data)
            self._offset += _V2_PREFIX + len(data)
        self.bytes_written = self._offset
        return off, len(data)

    def add_entry(self, name: str, entry: dict) -> None:
        off, ln = self.append({"name": name, "entry": entry})
        self.entries[name] = [off, ln]
        self._sync()

    def _sync(self) -> None:
        if self.durability == "none":
            return
        self._f.flush()
        if self.durability == "fsync":
            try:
                os.fsync(self._f.fileno())
            except (OSError, AttributeError, io.UnsupportedOperation):
                pass  # in-memory sinks (BytesIO) have nothing to fsync

    def finalize(self, meta: dict) -> int:
        """Write the index footer and the trailer; returns the container's
        size in bytes."""
        footer = {"version": self.version, "meta": meta,
                  "entries": self.entries}
        foff, _ = self.append(footer)
        self._f.write(_LEN.pack(foff))
        self._f.write(self._magic)
        self._offset += _LEN.size + len(self._magic)
        self.bytes_written = self._offset
        self._f.flush()
        if self.durability == "fsync":
            self._sync()
        if self._own:
            self._f.close()
        return self._offset

    def rewind(self, offset: int) -> None:
        """Roll the container back to ``offset`` (a record boundary), so a
        retried record never leaves torn bytes behind."""
        self._f.seek(offset)
        try:
            self._f.truncate(offset)
        except (OSError, io.UnsupportedOperation):
            pass  # a sink that cannot truncate: the retried record overwrites
        self._offset = offset
        self.bytes_written = offset
        self.entries = {n: v for n, v in self.entries.items()
                        if v[0] < offset}

    def abort(self) -> None:
        """Close without a footer.  The file still sniffs as a streaming
        container but will not open sealed: a half-written snapshot must not
        decode silently.  On v2 its sealed entries are recoverable with
        ``repair=True``."""
        self._f.flush()
        if self._own:
            self._f.close()


def scan_container(source, *, path: str | None = None) -> dict:
    """Salvage scan: walk a streaming container record by record from the
    front, whatever its footer says.

    Works on sealed, footerless and truncated containers.  Returns::

        {"version", "sealed", "entries": {name: [off, len]}, "meta",
         "prelude", "footer_offset", "damage": [{"offset", "error"}, ...]}

    Every intact entry record is indexed; damaged stretches are reported
    and, on v2, skipped by resynchronizing on the sync marker (v1 has none,
    so its scan stops at the first bad record).  ``meta`` comes from the
    footer when the walk reaches one, else from the prelude, else ``{}``.
    """
    own = _is_path(source)
    if own and path is None:
        path = os.fspath(source)
    f = open(source, "rb") if own else source
    try:
        end = f.seek(0, io.SEEK_END)
        f.seek(0)
        head = f.read(8)
        if head not in _MAGICS:
            raise CorruptArchiveError(
                "not a NeurLZ streaming archive (bad magic)", path=path)
        version = 1 if head == STREAM_MAGIC else 2
        out = {"version": version, "sealed": False, "entries": {},
               "meta": None, "prelude": None, "footer_offset": None,
               "damage": []}
        footer_meta = None
        off = len(head)
        trailer_len = _LEN.size + len(head)
        while off < end:
            if end - off == trailer_len:
                f.seek(off)
                tail = f.read(trailer_len)
                if tail[_LEN.size:] == head:
                    out["sealed"] = True
                    out["footer_offset"] = _LEN.unpack(tail[:_LEN.size])[0]
                    break
            try:
                rec, pln, nxt = _read_record_at(f, off, version, path=path)
            except CorruptArchiveError as e:
                out["damage"].append({"offset": off, "error": str(e)})
                if version == 1:
                    break
                resync = _find_sync(f, off + 1, end)
                if resync is None:
                    break
                off = resync
                continue
            if isinstance(rec, dict) and "name" in rec and "entry" in rec:
                out["entries"][rec["name"]] = [off, pln]
            elif isinstance(rec, dict) and rec.get("prelude"):
                out["prelude"] = rec.get("meta")
            elif isinstance(rec, dict) and "entries" in rec and "meta" in rec:
                footer_meta = rec["meta"]
            off = nxt
        if footer_meta is not None:
            out["meta"] = footer_meta
        elif out["prelude"] is not None:
            out["meta"] = out["prelude"]
        else:
            out["meta"] = {}
        return out
    finally:
        if own:
            f.close()


class ArchiveReader:
    """Random-access reader of a streaming container (v1 and v2).

    Reads the index footer once; ``read_entry(name)`` then loads exactly one
    field's record (checksum-verified on v2).  ``entry_reads`` lists every
    entry record read, in order (the footer is not an entry).
    ``repair=True`` ignores the footer and rebuilds the index with
    :func:`scan_container`, for footerless or truncated containers;
    ``salvaged`` is True when the container was not sealed.
    """

    def __init__(self, source, *, repair: bool = False):
        self._own = _is_path(source)
        self._path = os.fspath(source) if self._own else None
        self._f = open(source, "rb") if self._own else source
        try:
            self._f.seek(0)
            head = self._f.read(8)
            if head not in _MAGICS:
                raise CorruptArchiveError(
                    "not a NeurLZ streaming archive (bad magic)",
                    path=self._path)
            self.version = 1 if head == STREAM_MAGIC else 2
            self._magic = head
            self.salvaged = False
            self.prelude: dict | None = None
            self.damage: list[dict] = []
            if repair:
                self._load_salvaged()
            else:
                self._load_footer()
        except BaseException:
            self.close()
            raise
        self.entry_reads: list[str] = []

    def _load_footer(self) -> None:
        end = self._f.seek(0, io.SEEK_END)
        trailer_len = _LEN.size + len(self._magic)
        if end < len(self._magic) + trailer_len:
            raise CorruptArchiveError(
                "container too short for a trailer (crashed write? open "
                "with repair=True to salvage)", offset=end, path=self._path)
        self._f.seek(end - trailer_len)
        foff = _LEN.unpack(self._f.read(_LEN.size))[0]
        if self._f.read(len(self._magic)) != self._magic:
            raise CorruptArchiveError(
                "truncated streaming archive (no trailer; open with "
                "repair=True to salvage)", path=self._path)
        if not len(self._magic) <= foff < end - trailer_len:
            raise CorruptArchiveError(
                "footer offset out of range", offset=foff, path=self._path)
        footer = self._read_record(foff)
        if not (isinstance(footer, dict) and "entries" in footer
                and "meta" in footer):
            raise CorruptArchiveError(
                "trailer does not point at an index footer", offset=foff,
                path=self._path)
        self.version = footer.get("version", self.version)
        self.meta = footer["meta"]
        self.entries = footer["entries"]

    def _load_salvaged(self) -> None:
        scan = scan_container(self._f, path=self._path)
        self.meta = scan["meta"]
        self.entries = scan["entries"]
        self.prelude = scan["prelude"]
        self.damage = scan["damage"]
        self.salvaged = not scan["sealed"]

    def read_prelude(self) -> dict | None:
        """The v2 prelude metadata record, or None (v1, or none written)."""
        if self.prelude is not None or self.version != 2:
            return self.prelude
        try:
            rec, _, _ = _read_record_at(self._f, len(self._magic), 2,
                                        path=self._path)
        except CorruptArchiveError:
            return None
        if isinstance(rec, dict) and rec.get("prelude"):
            self.prelude = rec.get("meta")
        return self.prelude

    def _read_record(self, offset: int):
        obj, _, _ = _read_record_at(self._f, offset, self.version,
                                    path=self._path)
        return obj

    def read_entry(self, name: str) -> dict:
        off, _ = self.entries[name]
        rec = self._read_record(off)
        if not (isinstance(rec, dict) and "name" in rec and "entry" in rec):
            raise CorruptArchiveError(
                f"index for {name!r} does not point at an entry record",
                offset=off, path=self._path)
        if rec["name"] != name:
            raise CorruptArchiveError(
                f"index points at {rec['name']!r}, not {name!r}",
                offset=off, path=self._path)
        self.entry_reads.append(name)
        return rec["entry"]

    def close(self) -> None:
        if self._own:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def verify_container(source) -> dict:
    """Entry-by-entry integrity check: ``{"version", "sealed", "ok",
    "entries": {name: {"offset", "ok", "error"}}}``.

    On a sealed container every indexed entry is read again through the
    checksum-verified path (v2) or decoded (v1), so a flipped bit is named
    by entry and offset.  On an unsealed container the salvage index is
    verified instead, and ``sealed`` and ``ok`` are False.
    """
    own = _is_path(source)
    path = os.fspath(source) if own else None
    f = open(source, "rb") if own else source
    try:
        try:
            reader = ArchiveReader(f)
            sealed = True
        except CorruptArchiveError:
            f.seek(0)
            reader = ArchiveReader(f, repair=True)
            sealed = not reader.salvaged
        report = {"version": reader.version, "sealed": sealed,
                  "entries": {}, "ok": False}
        for name, (off, _ln) in reader.entries.items():
            status = {"offset": off, "ok": True, "error": None}
            try:
                rec = reader._read_record(off)
                got = rec.get("name") if isinstance(rec, dict) else None
                if got != name:
                    raise CorruptArchiveError(
                        f"index points at {got!r}, not {name!r}",
                        offset=off, path=path)
            except CorruptArchiveError as e:
                status["ok"] = False
                status["error"] = str(e)
            report["entries"][name] = status
        report["ok"] = sealed and all(
            s["ok"] for s in report["entries"].values())
        return report
    finally:
        if own:
            f.close()


def _flatten(tree) -> list:
    """Leaves of a nested dict in ``jax.tree.flatten`` order (sorted keys),
    so the weight blobs of the two packages hold the same bytes."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flatten(tree[k])]
    return [tree]


def _unflatten(like, leaves):
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    return next(leaves)


def _to_numpy(leaf) -> np.ndarray:
    if hasattr(leaf, "detach"):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _to_archive_dtype(a: np.ndarray, dtype: str) -> np.ndarray:
    """``a`` in the archive's weight dtype.  ``bfloat16`` is held as its raw
    16 bits, rounded to nearest even by torch, as ``ml_dtypes`` rounds: no
    numpy ``bfloat16`` dtype is needed, and the bytes are the same."""
    if dtype == "bfloat16":
        t = torch.from_numpy(np.array(a, dtype=np.float32))
        return t.to(torch.bfloat16).view(torch.int16).numpy()
    return np.asarray(a, dtype=dtype)


def _from_archive_dtype(raw: bytes, dtype: str, shape) -> np.ndarray:
    """Inverse of :func:`_to_archive_dtype`, as float32 (``bfloat16``: its
    16 bits are the high half of a float32's)."""
    if dtype == "bfloat16":
        bits = np.frombuffer(raw, dtype=np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(raw, dtype=dtype).reshape(shape).astype(np.float32)


def _itemsize(dtype: str) -> int:
    return 2 if dtype == "bfloat16" else np.dtype(dtype).itemsize


def pack_weights(params_tree, dtype: str = "float32") -> dict:
    """Flatten an enhancer parameter tree (``{layer: {"b", "w"}}``, ``w`` in
    HWIO) into one compressed blob."""
    arrs = [_to_archive_dtype(_to_numpy(leaf), dtype)
            for leaf in _flatten(params_tree)]
    buf = io.BytesIO()
    for a in arrs:
        buf.write(a.tobytes())
    payload, cname = codec.compress(buf.getvalue(), 9)
    return {
        "dtype": dtype,
        "shapes": [list(a.shape) for a in arrs],
        "payload": payload,
        "codec": cname,
        "nbytes": len(payload),
        "raw_nbytes": sum(a.nbytes for a in arrs),
        "n_params": sum(a.size for a in arrs),
    }


def unpack_weights(blob: dict, params_like) -> dict:
    """Inverse of :func:`pack_weights`: a tree shaped like ``params_like``
    holding float32 numpy arrays."""
    raw = codec.decompress(blob["payload"], blob.get("codec", "zstd"))
    dtype = blob["dtype"]
    size = _itemsize(dtype)
    out, off = [], 0
    for shape in blob["shapes"]:
        n = int(np.prod(shape)) * size
        out.append(_from_archive_dtype(raw[off:off + n], dtype, shape))
        off += n
    return _unflatten(params_like, iter(out))
