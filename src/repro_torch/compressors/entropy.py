"""Host-side entropy stage: the codec over the narrowest integer type that
holds a code stream (the SZ3 Huffman+lossless stage's stand-in).  The device
produces dense int32 codes; byte-granular coding stays on the host."""
from __future__ import annotations

import numpy as np

from . import codec

_LEVEL = 9


def _narrow(codes: np.ndarray) -> tuple[np.ndarray, str]:
    """The narrowest int dtype that holds ``codes`` losslessly."""
    if codes.size == 0:
        return codes.astype(np.int8), "int8"
    lo, hi = int(codes.min()), int(codes.max())
    for dt in ("int8", "int16", "int32", "int64"):
        info = np.iinfo(dt)
        if info.min <= lo and hi <= info.max:
            return codes.astype(dt), dt
    raise ValueError("codes exceed int64 range")


def encode_codes(codes: np.ndarray, level: int = _LEVEL) -> dict:
    """Entropy-encode an integer code stream into a serializable blob."""
    codes = np.ascontiguousarray(np.asarray(codes))
    narrow, dt = _narrow(codes.ravel())
    payload, cname = codec.compress(narrow.tobytes(), level)
    return {"dtype": dt, "shape": list(codes.shape), "payload": payload,
            "codec": cname, "nbytes": len(payload)}


def decode_codes(blob: dict) -> np.ndarray:
    raw = codec.decompress(blob["payload"], blob.get("codec", "zstd"))
    arr = np.frombuffer(raw, dtype=blob["dtype"]).reshape(blob["shape"])
    return arr.astype(np.int32)


def encode_floats(values: np.ndarray, level: int = _LEVEL) -> dict:
    """Lossless float blob (literal escapes)."""
    values = np.ascontiguousarray(np.asarray(values))
    payload, cname = codec.compress(values.tobytes(), level)
    return {"dtype": str(values.dtype), "shape": list(values.shape),
            "payload": payload, "codec": cname, "nbytes": len(payload)}


def decode_floats(blob: dict) -> np.ndarray:
    raw = codec.decompress(blob["payload"], blob.get("codec", "zstd"))
    return np.frombuffer(raw, dtype=blob["dtype"]).reshape(blob["shape"]).copy()


def first_order_entropy_bits(codes: np.ndarray) -> float:
    """Idealized total bits for the code stream under an order-0 model."""
    codes = np.asarray(codes).ravel()
    if codes.size == 0:
        return 0.0
    _, counts = np.unique(codes, return_counts=True)
    p = counts / codes.size
    return float(-(p * np.log2(p)).sum() * codes.size)
