"""Byte-stream codec layer: zstandard when available, stdlib zlib fallback.

Every compressed blob of an archive (entropy-coded code streams, escape
masks, enhancer weights, outlier coordinates) goes through this module.  The
codec name travels in the blob header (``"codec"``), so either side decodes
whatever the other wrote; a blob without the key is a legacy zstd blob.
Resolution order: explicit argument > :func:`set_default_codec` >
``$REPRO_CODEC`` > zstd if it imports, else zlib — the same order as the JAX
package, so both write the same bytes.
"""
from __future__ import annotations

import os
import zlib

try:
    import zstandard as _zstd
except ImportError:  # the zlib path is the normal one where the wheel is absent
    _zstd = None

HAVE_ZSTD = _zstd is not None

# The process-wide override of set_default_codec (None: none).
_override: str | None = None


def available_codecs() -> tuple[str, ...]:
    return ("zstd", "zlib") if HAVE_ZSTD else ("zlib",)


def set_default_codec(name: str | None) -> None:
    """Force a codec process-wide (``None`` restores auto-selection)."""
    global _override
    if name is not None:
        _check(name)
    _override = name


def default_codec() -> str:
    name = _override or os.environ.get("REPRO_CODEC")
    if name:
        _check(name)
        return name
    return "zstd" if HAVE_ZSTD else "zlib"


def _check(name: str) -> None:
    if name not in ("zstd", "zlib"):
        raise ValueError(f"unknown codec {name!r} (want 'zstd' or 'zlib')")
    if name == "zstd" and not HAVE_ZSTD:
        raise ImportError("codec 'zstd' requested but the zstandard package "
                          "is not installed; use codec='zlib'")


def compress(data: bytes, level: int = 9, codec: str | None = None
             ) -> tuple[bytes, str]:
    """Compress ``data``; returns ``(payload, codec_name)`` for the header."""
    name = codec or default_codec()
    _check(name)
    if name == "zstd":
        return _zstd.ZstdCompressor(level=level).compress(data), "zstd"
    return zlib.compress(data, min(level, 9)), "zlib"


def decompress(payload: bytes, codec: str = "zstd") -> bytes:
    _check(codec)
    if codec == "zstd":
        return _zstd.ZstdDecompressor().decompress(payload)
    return zlib.decompress(payload)


_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"


def decompress_sniffed(payload: bytes) -> bytes:
    """Decode a headerless stream (a checkpoint file) by sniffing the zstd
    frame magic, which a zlib stream never starts with."""
    return decompress(payload, "zstd" if payload[:4] == _ZSTD_MAGIC else "zlib")
