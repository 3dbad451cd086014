"""Bit-packed outlier coordinate codec (paper §3.3.1).

Flat indices of the strict-mode outliers are delta-encoded and packed at
``ceil(log2(Π dim_i))`` bits each — the paper's ``B̄`` — then run through the
codec.  ``packed_bits`` is the paper-formula cost, ``nbytes`` the achieved.
"""
from __future__ import annotations

import math

import numpy as np

from . import codec


def coord_bits(shape: tuple[int, ...]) -> int:
    """``B̄``: bits to address one point of ``shape``."""
    n = 1
    for d in shape:
        n *= int(d)
    return max(1, math.ceil(math.log2(max(n, 2))))


def _pack_bits(values: np.ndarray, width: int) -> bytes:
    """Pack ``values`` (uint64) at ``width`` bits each, little-endian bits."""
    if values.size == 0:
        return b""
    bits = ((values[:, None] >> np.arange(width, dtype=np.uint64)) & 1
            ).astype(np.uint8)
    return np.packbits(bits.ravel(), bitorder="little").tobytes()


def _unpack_bits(data: bytes, width: int, count: int) -> np.ndarray:
    if count == 0:
        return np.zeros((0,), dtype=np.uint64)
    bits = np.unpackbits(np.frombuffer(data, dtype=np.uint8), bitorder="little")
    bits = bits[: count * width].reshape(count, width).astype(np.uint64)
    return (bits << np.arange(width, dtype=np.uint64)).sum(axis=1)


def encode_outliers(mask: np.ndarray) -> dict:
    """Encode the True positions of a boolean mask."""
    shape = tuple(int(s) for s in mask.shape)
    flat = np.flatnonzero(np.asarray(mask).ravel()).astype(np.uint64)
    width = coord_bits(shape)
    deltas = np.diff(flat, prepend=np.uint64(0)) if flat.size else flat
    payload, cname = codec.compress(_pack_bits(deltas, width), 9)
    return {"shape": list(shape), "count": int(flat.size), "width": width,
            "payload": payload, "codec": cname,
            "packed_bits": int(flat.size) * width, "nbytes": len(payload)}


def decode_outliers(blob: dict) -> np.ndarray:
    shape = tuple(blob["shape"])
    packed = codec.decompress(blob["payload"], blob.get("codec", "zstd"))
    flat = np.cumsum(_unpack_bits(packed, blob["width"], blob["count"]),
                     dtype=np.uint64)
    mask = np.zeros(int(np.prod(shape)), dtype=bool)
    mask[flat.astype(np.int64)] = True
    return mask.reshape(shape)
