"""Chunked field sources: lazy, re-loadable snapshot inputs.

A copy of the JAX package's ``repro/streaming/source.py``.

A :class:`ChunkedFieldSource` describes a snapshot whose fields may not fit
in host memory at once.  It exposes *metadata* for every field up front
(``names`` / ``meta`` — enough for the scheduler to plan groups and budget
residency without touching data) and loads field arrays lazily via
``load``.  ``load`` may be called more than once for the same field: the
pipeline evicts originals after their group finalizes and reloads an
aux-producer's original only if its own group runs later, so sources must
be re-loadable (a dict lookup, a memmap'd ``.npy`` read, or a deterministic
generator re-run — all three are provided here).

:class:`BlockedSource` additionally splits huge fields into spatial blocks
along the slice axis, so a single field larger than the residency budget
still streams through the engine block by block; its ``manifest`` rides in
the archive footer and lets the streaming decoder reassemble full fields.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Iterable, Mapping, Protocol, runtime_checkable

import numpy as np


@dataclasses.dataclass(frozen=True)
class FieldMeta:
    shape: tuple
    dtype: np.dtype
    nbytes: int

    @classmethod
    def of(cls, shape, dtype) -> "FieldMeta":
        shape = tuple(int(s) for s in shape)
        dtype = np.dtype(dtype)
        return cls(shape=shape, dtype=dtype,
                   nbytes=int(np.prod(shape)) * dtype.itemsize)


@runtime_checkable
class ChunkedFieldSource(Protocol):
    def names(self) -> list[str]:
        """Field names in snapshot order (the archive's field order)."""

    def meta(self, name: str) -> FieldMeta:
        """Shape/dtype/nbytes without loading the data."""

    def load(self, name: str) -> np.ndarray:
        """Materialize one field.  Must be callable repeatedly."""


class DictSource:
    """In-memory mapping of arrays (the classic ``compress`` input)."""

    def __init__(self, fields: Mapping[str, np.ndarray]):
        self._fields = fields

    def names(self) -> list[str]:
        return list(self._fields)

    def meta(self, name: str) -> FieldMeta:
        x = self._fields[name]
        if not hasattr(x, "dtype"):
            x = np.asarray(x)
        return FieldMeta.of(x.shape, x.dtype)

    def load(self, name: str) -> np.ndarray:
        return np.asarray(self._fields[name])


class FunctionSource:
    """Generator-backed source: fields materialize on demand from a
    callable (e.g. a simulation snapshot reader or a synthetic generator).

    ``metas`` maps name -> (shape, dtype); ``loader(name)`` must be
    deterministic so repeated loads yield the same bytes.
    """

    def __init__(self, metas: Mapping[str, tuple],
                 loader: Callable[[str], np.ndarray]):
        self._metas = {n: FieldMeta.of(shape, dtype)
                       for n, (shape, dtype) in metas.items()}
        self._loader = loader

    def names(self) -> list[str]:
        return list(self._metas)

    def meta(self, name: str) -> FieldMeta:
        return self._metas[name]

    def load(self, name: str) -> np.ndarray:
        return np.asarray(self._loader(name))


class NpyDirSource:
    """A directory of ``<field>.npy`` files, opened as memmaps so ``load``
    itself costs no resident memory until slices are actually read."""

    def __init__(self, path: str, names: Iterable[str] | None = None):
        self._dir = path
        if names is None:
            names = sorted(f[:-4] for f in os.listdir(path)
                           if f.endswith(".npy"))
        self._names = list(names)

    def _path(self, name: str) -> str:
        return os.path.join(self._dir, f"{name}.npy")

    def names(self) -> list[str]:
        return self._names

    def meta(self, name: str) -> FieldMeta:
        m = np.load(self._path(name), mmap_mode="r")
        return FieldMeta.of(m.shape, m.dtype)

    def load(self, name: str) -> np.ndarray:
        return np.load(self._path(name), mmap_mode="r")


class BlockedSource:
    """Split fields bigger than ``max_block_bytes`` into spatial blocks
    along ``slice_axis``.

    Blocks appear as virtual fields named ``{name}#b{i}`` and compress as
    independent entries (each with its own normalization stats and error
    bound, exactly as if the caller had pre-split the snapshot), so a field
    larger than the residency budget still streams through.  ``manifest``
    maps each split field to its ordered ``(block_name, lo, hi)`` spans;
    the streaming decoder uses it to reassemble full fields.
    """

    def __init__(self, base: ChunkedFieldSource, max_block_bytes: int,
                 slice_axis: int = 0):
        self._base = base
        self._axis = slice_axis
        self._metas: dict[str, FieldMeta] = {}
        self._spans: dict[str, tuple[str, int, int]] = {}
        self.manifest: dict[str, list] = {}
        for name in base.names():
            m = base.meta(name)
            axis = slice_axis % len(m.shape)
            n_slices = m.shape[axis]
            slice_bytes = max(1, m.nbytes // n_slices)
            per_block = min(n_slices,
                            max(1, int(max_block_bytes) // slice_bytes))
            if max_block_bytes <= 0 or per_block >= n_slices:
                self._metas[name] = m
                continue
            spans = []
            for bi, lo in enumerate(range(0, n_slices, per_block)):
                hi = min(lo + per_block, n_slices)
                bname = f"{name}#b{bi}"
                shape = tuple(hi - lo if i == axis else s
                              for i, s in enumerate(m.shape))
                self._metas[bname] = FieldMeta.of(shape, m.dtype)
                self._spans[bname] = (name, lo, hi)
                spans.append([bname, lo, hi])
            self.manifest[name] = {"axis": axis, "blocks": spans}

    def names(self) -> list[str]:
        return list(self._metas)

    def meta(self, name: str) -> FieldMeta:
        return self._metas[name]

    def load(self, name: str) -> np.ndarray:
        if name not in self._spans:
            return self._base.load(name)
        base_name, lo, hi = self._spans[name]
        axis = self.manifest[base_name]["axis"]
        x = self._base.load(base_name)
        idx = tuple(slice(lo, hi) if i == axis else slice(None)
                    for i in range(x.ndim))
        return np.ascontiguousarray(x[idx])


def synthetic_snapshot_source(num_fields: int, shape=(16, 32, 32),
                              dataset: str = "nyx", seed0: int = 2
                              ) -> FunctionSource:
    """Lazy synthetic snapshot of :func:`repro_torch.data.fields.snapshot_specs`
    — each field regenerates only its own seed block on ``load``, so
    snapshots far larger than memory can be produced for testing."""
    from ..data import fields as F

    specs = F.snapshot_specs(num_fields, shape=shape, dataset=dataset,
                             seed0=seed0)
    dtype = F.DATASET_DTYPES[dataset]
    metas = {name: (spec["shape"], dtype) for name, spec in specs.items()}
    return FunctionSource(metas, lambda name: F.load_spec(specs[name]))


def as_source(obj) -> ChunkedFieldSource:
    """Coerce compress inputs: mapping -> DictSource, dir path ->
    NpyDirSource, sources pass through."""
    if isinstance(obj, (DictSource, FunctionSource, NpyDirSource,
                        BlockedSource)):
        return obj
    if isinstance(obj, Mapping):
        return DictSource(obj)
    if isinstance(obj, (str, os.PathLike)) and os.path.isdir(obj):
        return NpyDirSource(os.fspath(obj))
    if isinstance(obj, ChunkedFieldSource):
        return obj
    raise TypeError(f"cannot interpret {type(obj)} as a ChunkedFieldSource")
