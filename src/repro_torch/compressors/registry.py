"""Pluggable conventional-compressor registry.

A compressor registers its name, capability metadata and entry points once,
and every engine resolves it through the same table.  Entry points take a
``device=`` keyword (``cuda`` unless given):

    from repro_torch.compressors import registry

    registry.register(registry.CompressorEntry(
        name="mylz", kind="mylz",
        compress=my_compress,          # (x, rel_eb, *, abs_eb=None, device=None)
        decompress=my_decompress,      # (arc, device=None) -> np.ndarray
        archive_nbytes=my_nbytes,      # (arc) -> int
    ))

Capability metadata drives the conventional stage
(:mod:`repro_torch.core.conv_stage`): an entry that provides
``compress_batched`` declares that compressing a group of
same-shape/same-dtype fields yields payloads byte-identical to one
``compress`` call per field.  Entries without it always run per field.

Archive *kinds* are registered apart from compressor names because several
compressors may share an archive format (``szlike`` and ``szlike-lorenzo``
both emit ``kind="szlike"``); decode-side dispatch goes by the archive's
``kind`` tag, and an unknown name or kind is an error.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable

import numpy as np


@dataclasses.dataclass(frozen=True)
class CompressorEntry:
    """One registered conventional compressor.

    ``compress(x, rel_eb, *, abs_eb=None, device=None) -> (archive, rec)``
    must return the reconstruction that ``decompress(archive)`` produces,
    bit for bit (NeurLZ trains its enhancer against it).

    ``compress_batched(xs, rel_eb, *, abs_eb=None, device=None)`` (optional)
    takes same-shape/same-dtype fields and returns per-field
    ``(archive, rec)`` byte-identical to one ``compress`` call each.

    ``decompress_batched(arcs, device=None)`` (optional) takes archives
    that agree on ``decode_key(arc)`` and returns reconstructions
    bit-identical to one ``decompress`` call each.
    """

    name: str
    kind: str                                # archive "kind" tag it emits
    compress: Callable
    decompress: Callable
    archive_nbytes: Callable
    compress_batched: Callable | None = None
    decompress_batched: Callable | None = None
    decode_key: Callable | None = None       # (arc) -> hashable group key
    dtypes: tuple = ("float32", "float64")   # dtypes the batched path covers
    description: str = ""

    @property
    def batchable(self) -> bool:
        return self.compress_batched is not None

    @property
    def decode_batchable(self) -> bool:
        return (self.decompress_batched is not None
                and self.decode_key is not None)

    def batch_supports(self, dtype) -> bool:
        return self.batchable and str(np.dtype(dtype)) in self.dtypes

    def decode_batch_supports(self, arc: dict) -> bool:
        return (self.decode_batchable
                and str(np.dtype(arc.get("dtype", "float32"))) in self.dtypes)


_COMPRESSORS: dict[str, CompressorEntry] = {}
_KINDS: dict[str, CompressorEntry] = {}


def register(entry: CompressorEntry) -> CompressorEntry:
    """Register a compressor (and its archive kind, if new).  A name
    registers once.  Entries that share a kind must share its decode entry
    points: the first registration of a kind owns its decode dispatch."""
    if entry.name in _COMPRESSORS:
        raise ValueError(f"compressor {entry.name!r} already registered")
    owner = _KINDS.get(entry.kind)
    if owner is not None and owner.name != entry.name and (
            owner.decompress is not entry.decompress
            or owner.archive_nbytes is not entry.archive_nbytes
            or owner.decompress_batched is not entry.decompress_batched
            or owner.decode_key is not entry.decode_key):
        raise ValueError(
            f"archive kind {entry.kind!r} is owned by {owner.name!r} with "
            "different decode entry points (incl. decompress_batched/"
            "decode_key); kinds must decode unambiguously")
    _COMPRESSORS[entry.name] = entry
    if owner is None or owner.name == entry.name:
        _KINDS[entry.kind] = entry
    return entry


def unregister(name: str) -> None:
    entry = _COMPRESSORS.pop(name, None)
    if entry is not None and _KINDS.get(entry.kind) is entry:
        # Hand the kind to any remaining entry that shares it.
        del _KINDS[entry.kind]
        for other in _COMPRESSORS.values():
            if other.kind == entry.kind:
                _KINDS[entry.kind] = other
                break


def get(name: str) -> CompressorEntry:
    try:
        return _COMPRESSORS[name]
    except KeyError:
        raise ValueError(
            f"unknown compressor {name!r} (registered: {sorted(_COMPRESSORS)})"
        ) from None


def for_archive(arc: dict) -> CompressorEntry:
    """The entry owning an archive dict's ``kind`` tag."""
    kind = arc.get("kind")
    try:
        return _KINDS[kind]
    except KeyError:
        raise ValueError(
            f"unknown archive kind {kind!r} (registered: {sorted(_KINDS)})"
        ) from None


def names() -> list[str]:
    return sorted(_COMPRESSORS)


def entries() -> list[CompressorEntry]:
    return [_COMPRESSORS[n] for n in names()]


def compress(x, rel_eb=None, *, abs_eb=None, compressor="szlike", device=None):
    """``(archive, rec)`` of the registered compressor ``compressor``."""
    return get(compressor).compress(x, rel_eb, abs_eb=abs_eb, device=device)


def decompress(arc: dict, device=None):
    """Decode an archive by its ``kind`` tag."""
    return for_archive(arc).decompress(arc, device=device)


def archive_nbytes(arc: dict) -> int:
    return for_archive(arc).archive_nbytes(arc)


class DecodeStats:
    """Thread-safe count of the conventional decodes :func:`decompress_many`
    issued: stacked ``decompress_batched`` calls (``batched``), one-archive
    calls (``single``), archives decoded and the widest stacked call."""

    __slots__ = ("_lock", "batched", "single", "archives", "max_width")

    def __init__(self):
        self._lock = threading.Lock()
        self.batched = 0
        self.single = 0
        self.archives = 0
        self.max_width = 0

    def note(self, width: int) -> None:
        with self._lock:
            self.archives += width
            if width > 1:
                self.batched += 1
                self.max_width = max(self.max_width, width)
            else:
                self.single += 1

    @property
    def dispatches(self) -> int:
        return self.batched + self.single

    def as_dict(self) -> dict:
        return {"batched": self.batched, "single": self.single,
                "dispatches": self.dispatches, "archives": self.archives,
                "max_width": self.max_width}

    def __repr__(self) -> str:
        return (f"DecodeStats(batched={self.batched}, single={self.single}, "
                f"archives={self.archives}, max_width={self.max_width})")


def decompress_many(arcs, *, stats: DecodeStats | None = None,
                    device=None) -> dict:
    """Decode ``{name: archive}``: archives whose entry declares
    ``decompress_batched`` and that agree on its ``decode_key`` go through
    one stacked call, the rest one at a time.  Outputs are bit-identical to
    one :func:`decompress` per archive either way."""
    out: dict = {}
    groups: dict[tuple, list] = {}
    for name, arc in arcs.items():
        entry = for_archive(arc)
        if entry.decode_batch_supports(arc):
            k = (entry.name, entry.decode_key(arc))
        else:
            k = (entry.name, ("__single__", name))
        groups.setdefault(k, []).append((name, arc, entry))
    for members in groups.values():
        entry = members[0][2]
        if len(members) > 1:
            recs = entry.decompress_batched([arc for _, arc, _ in members],
                                            device=device)
            for (name, _, _), rec in zip(members, recs):
                out[name] = rec
            if stats is not None:
                stats.note(len(members))
        else:
            for name, arc, e in members:
                out[name] = e.decompress(arc, device=device)
                if stats is not None:
                    stats.note(1)
    return {name: out[name] for name in arcs}


def _register_builtins() -> None:
    from . import szlike, zfplike

    lorenzo = szlike.SZLikeConfig(predictor="lorenzo")

    def _lorenzo_compress(x, rel_eb=None, *, abs_eb=None, device=None):
        return szlike.compress(x, rel_eb, abs_eb=abs_eb, config=lorenzo,
                               device=device)

    def _lorenzo_batched(xs, rel_eb=None, *, abs_eb=None, device=None):
        return szlike.compress_batched(xs, rel_eb, abs_eb=abs_eb,
                                       config=lorenzo, device=device)

    register(CompressorEntry(
        name="szlike", kind="szlike",
        compress=szlike.compress, decompress=szlike.decompress,
        archive_nbytes=szlike.archive_nbytes,
        compress_batched=szlike.compress_batched,
        decompress_batched=szlike.decompress_batched,
        decode_key=szlike.decode_key,
        description="SZ3-style multilevel cubic-interpolation predictor"))
    register(CompressorEntry(
        name="szlike-lorenzo", kind="szlike",
        compress=_lorenzo_compress, decompress=szlike.decompress,
        archive_nbytes=szlike.archive_nbytes,
        compress_batched=_lorenzo_batched,
        decompress_batched=szlike.decompress_batched,
        decode_key=szlike.decode_key,
        description="cuSZ-style dual-quantization Lorenzo predictor"))
    register(CompressorEntry(
        name="zfplike", kind="zfplike",
        compress=zfplike.compress, decompress=zfplike.decompress,
        archive_nbytes=zfplike.archive_nbytes,
        compress_batched=zfplike.compress_batched,
        decompress_batched=zfplike.decompress_batched,
        decode_key=zfplike.decode_key,
        description="ZFP-style block-transform with exact correction pass"))
