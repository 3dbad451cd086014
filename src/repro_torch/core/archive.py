"""NeurLZ whole-dict archive serialization (paper Fig. 2, file format).

One msgpack document per archive: conventional payload, enhancer weights,
outlier coordinates and normalization stats for every field.  The port
carries its own packer and unpacker for the subset of msgpack an archive
uses — nil, bool, int, float64, str, bin, array, map, and numpy arrays as
the ``{b"__nd__": True, ...}`` map — because it must run where no msgpack
wheel is installed.  Its bytes equal
``msgpack.packb(obj, default=_default, use_bin_type=True)`` of the JAX
package, so files written by either package open in the other.
"""
from __future__ import annotations

import io
import struct

import numpy as np

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


def pack_weights(params_tree, dtype: str = "float32") -> dict:
    """Flatten an enhancer parameter tree (``{layer: {"b", "w"}}``, ``w`` in
    HWIO) into one compressed blob."""
    arrs = [np.asarray(_to_numpy(leaf), dtype=dtype)
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
    dt = np.dtype(blob["dtype"])
    out, off = [], 0
    for shape in blob["shapes"]:
        n = int(np.prod(shape)) * dt.itemsize
        out.append(np.frombuffer(raw[off:off + n], dtype=dt)
                   .reshape(shape).astype(np.float32))
        off += n
    return _unflatten(params_like, iter(out))
