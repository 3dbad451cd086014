"""Transcode: re-target a stored archive to new error bounds.

The port of the JAX package's ``repro/serve/transcode.py``.
``transcode(src, dst, bounds=...)`` reads a source archive's entries
lazily (:class:`ArchiveSource` adapts an open :class:`Archive` to the
streaming engine's ``ChunkedFieldSource`` protocol, decoding one field, or
``BlockedSource`` block, at a time on ``load``) and re-compresses them under
new per-field :class:`ErrorBound` specs through the streaming pipeline into
a fresh container.  Because it *is* the streaming pipeline underneath:

* residency stays under the :class:`ResidencyLedger` budget (pass the
  serving tier's ledger to share one process-wide ceiling with the
  hot-field cache);
* every entry equals, byte for byte, that of decoding the whole snapshot
  and compressing it again under the same config and bounds (transcoding
  buys memory, not different bytes);
* ``resume=True`` salvages a partial destination of a killed transcode
  and compresses only the missing fields.

A load decodes on the device (the enhancer's ``conv2d3x3`` and
``fused_enhance``), so :class:`ArchiveSource` declares
``loads_on_device``: the pipeline then loads it on the calling thread,
never on its host-only reader thread.

Block structure carries through: a blocked source field stays blocked with
the same spans in the destination (``ArchiveSource`` re-exposes the
manifest), and ``bounds`` keyed by *original* field names are expanded onto
their block entries.
"""
from __future__ import annotations

import dataclasses
import os
import threading
from typing import Mapping

from .. import device as device_lib
from ..core import neurlz
from ..core.archive_api import Archive
from ..streaming import pipeline
from ..streaming import source as source_lib


class ArchiveSource:
    """A ``ChunkedFieldSource`` view of an archive (handle, dict or path),
    decoding on ``device`` (``cuda`` unless given; an :class:`Archive`
    handle keeps its own device unless ``device`` is given).

    ``names``/``meta`` come from the archive index (entries read
    *transiently* for shape and dtype: nothing stays resident); ``load``
    decodes one entry on demand and may be called repeatedly, the
    re-loadable contract the streaming pipeline expects.  Block entries
    are exposed as they are, and the reassembly ``manifest`` is
    re-exported so a transcode keeps the source's block structure.
    """

    loads_on_device = True      # load decodes: the pipeline calls it on
    #   the calling thread

    def __init__(self, archive, *, device=None):
        if isinstance(archive, (str, bytes, os.PathLike)):
            archive = Archive.open(archive, device=device)
        elif isinstance(archive, Archive):
            if device is not None:
                archive = archive.on_device(device)
        else:
            archive = Archive.from_dict(archive, device=device)
        self.archive = archive
        self.manifest = dict(archive.block_manifest)
        self._metas: dict[str, source_lib.FieldMeta] = {}
        # The reader seeks one shared file handle, so reads are serialized.
        self._lock = threading.Lock()

    @property
    def aux_map(self) -> dict[str, list]:
        """Entry name -> cross-field aux producers (from the container)."""
        if self.archive.streaming:
            return dict(self.archive.reader.meta.get("aux") or {})
        return {n: list(self.archive["fields"][n].get("aux", ()))
                for n in self.archive.field_names}

    def names(self) -> list[str]:
        return list(self.archive.field_names)

    def meta(self, name: str) -> source_lib.FieldMeta:
        with self._lock:
            if name not in self._metas:
                e = self.archive._entry_transient(name)
                conv = e["conv"]
                self._metas[name] = source_lib.FieldMeta.of(
                    conv["shape"], conv.get("dtype", "float32"))
            return self._metas[name]

    def load(self, name: str):
        with self._lock:
            return self.archive.decode(name)


def _expand_block_bounds(bounds, manifest: dict, names: list):
    """Rewrite ``bounds`` keys given as blocked *original* field names onto
    their ``name#bN`` block entries (one spec per block: blocks are
    independent entries with their own bounds)."""
    if not manifest or not isinstance(bounds, Mapping):
        return bounds
    present = set(names)
    out = {}
    for key, spec in bounds.items():
        man = manifest.get(key)
        if man is not None and key not in present:
            for bname, _, _ in man["blocks"]:
                out[bname] = spec
        else:
            out[key] = spec
    return out


def transcode(src, dst, bounds=None, *, rel_eb: float | None = None,
              abs_eb: float | None = None, config=None,
              ledger=None, resume: bool = False,
              collect_stats: bool = True, telemetry=None,
              faults=None, device=None) -> Archive:
    """Re-compress ``src`` (archive handle, dict, or path) into a fresh
    container at ``dst`` under new error bounds, on ``device`` (``cuda``
    unless given); returns a lazy :class:`Archive` over the result with
    the pipeline's report attached.

    ``config`` defaults to a streaming :class:`NeurLZConfig` matching the
    source (compressor, slice axis, cross-field aux map); pass one to
    change those too.  ``ledger`` shares a residency ceiling with other
    subsystems (e.g. an :class:`ArchiveServer` cache).  ``bounds`` takes
    per-field specs keyed by entry *or* blocked original names.
    ``resume=True`` continues an interrupted transcode from ``dst``'s
    salvageable prefix; the finished container's entries equal an
    uninterrupted run's.
    """
    device = device_lib.resolve(device)
    source = ArchiveSource(src, device=device)
    if config is None:
        meta = source.archive.meta
        config = neurlz.NeurLZConfig(
            engine="streaming",
            compressor=meta.get("compressor", "szlike"),
            slice_axis=meta.get("slice_axis", 0),
            cross_field={n: tuple(a) for n, a in source.aux_map.items()
                         if a})
    elif config.engine != "streaming":
        config = dataclasses.replace(config, engine="streaming")
    if telemetry is not None and config.telemetry is None:
        config = dataclasses.replace(config, telemetry=telemetry)
    if faults is not None and config.faults is None:
        config = dataclasses.replace(config, faults=faults)
    bounds = _expand_block_bounds(bounds, source.manifest, source.names())
    if isinstance(dst, os.PathLike):
        dst = os.fspath(dst)
    report = pipeline.compress(source, dst, rel_eb, abs_eb=abs_eb,
                               config=config, bounds=bounds,
                               collect_stats=collect_stats, resume=resume,
                               ledger=ledger, device=device)
    out = Archive.open(dst, device=device)
    out.report = report
    if telemetry is not None:
        out.telemetry = telemetry
    return out
