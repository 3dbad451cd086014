"""`ArchiveServer`: concurrent decode requests over NeurLZ archives.

The port of the JAX package's ``repro/serve/server.py``.  One dispatcher
thread drains the :class:`~repro_torch.serve.coalesce.Coalescer` in
batches and serves each batch through three tiers:

1. **Cache**: hot decoded fields come straight out of the
   :class:`~repro_torch.serve.cache.HotFieldCache` (bytes charged to the
   shared :class:`~repro_torch.streaming.pipeline.ResidencyLedger`).
2. **Coalesced decode**: cache misses for plain whole-field entries are
   folded into *one* ``registry.decompress_many`` call per batch; archives
   that agree on the registry ``decode_key`` (same compressor, shape,
   dtype, layout) decode in one stacked ``decompress_batched`` call: one
   stacked ``lorenzo3d_inv`` launch for Lorenzo archives, one stacked
   interpolation walk for interp ones.  Each field's enhancer inference
   (``conv2d3x3``) and enhancement (``fused_enhance``) then run through
   :func:`repro_torch.core.neurlz.decode_field_entry`.
   :class:`~repro_torch.compressors.registry.DecodeStats` counts the
   dispatches that ran.
3. **Individual decode**: ROI requests and ``BlockedSource`` originals go
   to :meth:`Archive.decode` (which reads only covering blocks for a ROI).

Aux-closure reconstructions decoded along the way are cached under
``("aux", ...)`` keys and **pinned** while a batch whose decodes depend on
them runs: the cache never evicts a closure out from under a decode in
flight.  A failure (an injected fault at site ``"serve.request"``, an
unknown field, a failed kernel) fails the affected requests' futures;
the server keeps serving everything else.

Threads: every CUDA call runs on the dispatcher thread, which first
selects the server's CUDA device (the device current where the server was
built, unless ``device`` names one).  Client threads only queue requests
and wait on futures; a server closed before it started serves what was
queued by starting its dispatcher then.  Archives registered with the
server decode on its ``device`` (``cuda`` unless the caller passes
``device="cpu"``).
"""
from __future__ import annotations

import contextlib
import os
import threading

import torch

from .. import device as device_lib
from ..compressors import registry
from ..core import neurlz
from ..core.archive_api import Archive
from ..faults import DEFAULT as FAULTS_DEFAULT
from ..obs import telemetry as obs_lib
from ..streaming.pipeline import ResidencyLedger
from .cache import HotFieldCache
from .coalesce import Coalescer, Future, Request

_MISS = object()


def _roi_key(roi):
    """Hashable form of a ROI spec (slices are unhashable)."""
    if roi is None:
        return None
    if isinstance(roi, slice):
        roi = (roi,)
    return tuple((s.start, s.stop, s.step) for s in roi)


class ArchiveServer:
    """Multi-tenant decode front end over open archives.

    ``archives`` maps an archive id to an :class:`Archive`, an archive
    dict, or a path (paths open at registration, so a bad path fails
    fast).  A single archive (or path) registers under id ``"default"``.

    ``ledger`` is the shared residency ledger the cache charges; pass the
    one your streaming jobs use for a single process-wide ceiling, or let
    the server build its own from ``max_bytes``.

    The dispatcher thread starts at once unless ``auto_start=False``
    (queue requests first, then :meth:`start`, for a deterministic
    coalescing window).  ``copy_results=True`` (the default) hands each
    caller its own array; ``False`` shares the cached buffer (callers
    must not mutate it).  ``device`` is where every decode runs (``cuda``
    unless given).
    """

    def __init__(self, archives=None, *, ledger: ResidencyLedger | None = None,
                 max_bytes: int = 0, telemetry=None, faults=None,
                 window_s: float = 0.002, max_batch: int = 64,
                 auto_start: bool = True, copy_results: bool = True,
                 device=None):
        self.device = device_lib.resolve(device)
        self._cuda_index = None
        if self.device.type == "cuda":
            self._cuda_index = (self.device.index
                                if self.device.index is not None
                                else torch.cuda.current_device())
        self.telemetry = telemetry if telemetry is not None else obs_lib.NULL
        self.faults = faults if faults is not None else FAULTS_DEFAULT
        self.ledger = ledger if ledger is not None \
            else ResidencyLedger(max_bytes, telemetry=self.telemetry)
        self.cache = HotFieldCache(self.ledger, self.telemetry)
        self.decode_stats = registry.DecodeStats()
        self.copy_results = bool(copy_results)
        self._coalescer = Coalescer(window_s=window_s, max_batch=max_batch)
        self._archives: dict[str, Archive] = {}
        self._lock = threading.Lock()
        self._thread: threading.Thread | None = None
        self._root_span = None
        self._requests = 0
        if archives is not None:
            if isinstance(archives, dict) and not archives.get("kind"):
                for aid, src in archives.items():
                    self.add_archive(src, archive_id=aid)
            else:
                self.add_archive(archives, archive_id="default")
        if auto_start:
            self.start()

    # -- archive registry ---------------------------------------------------

    def add_archive(self, src, archive_id: str | None = None) -> str:
        """Register an archive (handle, dict, or container path) and return
        its id.  A handle on another device is reopened on the server's."""
        if isinstance(src, (str, bytes, os.PathLike)):
            arc = Archive.open(src, device=self.device)
        elif isinstance(src, Archive):
            arc = src.on_device(self.device)
        else:
            arc = Archive.from_dict(src, device=self.device)
        if arc.telemetry is obs_lib.NULL:
            arc.telemetry = self.telemetry
        if archive_id is None:
            archive_id = arc.path or f"archive{len(self._archives)}"
        with self._lock:
            self._archives[archive_id] = arc
        return archive_id

    def remove_archive(self, archive_id: str) -> None:
        with self._lock:
            self._archives.pop(archive_id, None)
        for key in self.cache.keys:
            # main keys are (aid, name, roi); aux keys ("aux", aid, name)
            aid = key[1] if key and key[0] == "aux" else key[0]
            if aid == archive_id:
                self.cache.invalidate(key)

    @property
    def archive_ids(self) -> list[str]:
        with self._lock:
            return list(self._archives)

    def _resolve(self, archive_id: str | None) -> tuple[str, Archive]:
        with self._lock:
            if archive_id is None:
                if len(self._archives) != 1:
                    raise ValueError(
                        f"archive_id required: server holds "
                        f"{len(self._archives)} archives")
                archive_id = next(iter(self._archives))
            return archive_id, self._archives[archive_id]

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "ArchiveServer":
        """Start the dispatcher thread (idempotent)."""
        if self._thread is None or not self._thread.is_alive():
            if self._root_span is None:
                self._root_span = self.telemetry.span("serve", root=True)
                self._root_span.__enter__()
            self._thread = threading.Thread(target=self._dispatch_loop,
                                            name="repro-torch-serve",
                                            daemon=True)
            self._thread.start()
        return self

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def close(self, *, close_archives: bool = False) -> None:
        """Serve the requests still queued, stop the dispatcher, release the
        cache's ledger charges."""
        self._coalescer.close()
        if not self.running and self._coalescer.pending():
            self.start()            # drains the queue up to the stop mark
        if self._thread is not None:
            self._thread.join()
        if self._root_span is not None:
            self._root_span.__exit__(None, None, None)
            self._root_span = None
        self.cache.clear()
        if close_archives:
            for arc in self._archives.values():
                arc.close()

    def __enter__(self) -> "ArchiveServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- request surface ----------------------------------------------------

    def submit(self, name: str, *, archive_id: str | None = None,
               roi=None) -> Future:
        """Queue a decode request; returns a future whose ``result()`` is
        the decoded (optionally ROI-sliced) field array."""
        aid, _ = self._resolve(archive_id)
        req = Request(aid, name, roi)
        self.telemetry.counter("serve.requests").add()
        with self._lock:
            self._requests += 1
        self._coalescer.submit(req)
        return req.future

    def decode(self, name: str, *, archive_id: str | None = None, roi=None,
               timeout: float | None = 30.0):
        """Blocking convenience: ``submit(...).result(timeout)``."""
        if not self.running:
            raise RuntimeError("server not started (auto_start=False?): "
                               "call start() or use submit() + start()")
        return self.submit(name, archive_id=archive_id,
                           roi=roi).result(timeout)

    def stats(self) -> dict:
        """Serving counters: requests, cache hits/misses/evictions, decode
        dispatch accounting (the coalescing evidence), ledger residency."""
        return {
            "requests": self._requests,
            "decode": self.decode_stats.as_dict(),
            "counters": self.telemetry.counters_prefixed("serve."),
            "cache_entries": len(self.cache),
            "resident_bytes": self.ledger.current,
            "max_bytes": self.ledger.max_bytes,
        }

    # -- dispatcher ---------------------------------------------------------

    def _device_context(self):
        if self._cuda_index is None:
            return contextlib.nullcontext()
        return torch.cuda.device(self._cuda_index)

    def _dispatch_loop(self) -> None:
        with self._device_context():
            while True:
                batch, stopping = self._coalescer.drain()
                if batch:
                    self.telemetry.gauge("serve.coalesce_width").set(
                        len(batch))
                    self._serve_batch(batch)
                if stopping:
                    return

    def _out(self, value):
        return value.copy() if self.copy_results else value

    def _serve_batch(self, batch: list[Request]) -> None:
        with self.telemetry.span("serve.batch", requests=len(batch)):
            coalesce: list = []     # (req, arc, cache_key) plain whole-field
            individual: list = []   # (req, arc, cache_key) roi / blocked
            for req in batch:
                with self._lock:
                    arc = self._archives.get(req.archive_id)
                if arc is None:
                    self._fail(req, KeyError(
                        f"unknown archive id {req.archive_id!r}"))
                    continue
                key = (req.archive_id, req.name, _roi_key(req.roi))
                hit = self.cache.get(key, _MISS)
                if hit is not _MISS:
                    req.future.set_result(self._out(hit))
                    continue
                if req.roi is None and req.name not in arc.block_manifest:
                    coalesce.append((req, arc, key))
                else:
                    individual.append((req, arc, key))
            self._serve_coalesced(coalesce)
            for req, arc, key in individual:
                self._serve_one(req, arc, key)

    def _fail(self, req: Request, exc: BaseException) -> None:
        self.telemetry.counter("serve.request_errors").add()
        req.future.set_error(exc)

    def _serve_one(self, req: Request, arc: Archive, key) -> None:
        with self.telemetry.span("serve.request", field=req.name,
                                 archive=req.archive_id, kind="individual"):
            try:
                value = self.faults.run(
                    lambda: arc.decode(req.name, roi=req.roi),
                    site="serve.request", tel=self.telemetry)
            except Exception as exc:  # noqa: BLE001 - request isolation
                self._fail(req, exc)
                return
            self.cache.put(key, value)
            req.future.set_result(self._out(value))

    def _serve_coalesced(self, items: list) -> None:
        """Serve plain whole-field cache misses through one registry call.

        Same-``decode_key`` conventional archives across *all* requests in
        the batch (any tenant) stack into single ``decompress_batched``
        calls inside :func:`registry.decompress_many`.  If that call fails,
        every request of the batch that waited on it fails with its error.
        """
        if not items:
            return
        by_field: dict[tuple, list] = {}    # (aid, name) -> [(req, arc, key)]
        for item in by_order(items):
            by_field.setdefault((item[0].archive_id, item[0].name),
                                []).append(item)
        conv: dict[tuple, dict] = {}        # (aid, entry_name) -> conv arc
        entries: dict[tuple, dict] = {}
        cached_aux: dict[tuple, object] = {}
        pinned: list = []
        failed: dict[tuple, BaseException] = {}
        for (aid, name), reqs in by_field.items():
            arc = reqs[0][1]
            try:
                self.faults.run(lambda: None, site="serve.request",
                                tel=self.telemetry)
                e = arc._entry_transient(name)
                entries[(aid, name)] = e
                conv[(aid, name)] = e["conv"]
                for a in e["aux"]:
                    akey = ("aux", aid, a)
                    if (aid, a) in conv or (aid, a) in cached_aux:
                        continue
                    rec = self.cache.get(akey, _MISS)
                    if rec is not _MISS:
                        self.cache.pin(akey)
                        pinned.append(akey)
                        cached_aux[(aid, a)] = rec
                    else:
                        conv[(aid, a)] = arc._entry_transient(a)["conv"]
            except Exception as exc:  # noqa: BLE001 - request isolation
                failed[(aid, name)] = exc
                conv.pop((aid, name), None)
        try:
            try:
                if conv:
                    with self.telemetry.span("serve.decode",
                                             fields=len(by_field),
                                             archives=len(conv)):
                        recs = registry.decompress_many(
                            conv, stats=self.decode_stats,
                            device=self.device)
                else:
                    recs = {}
            except Exception as exc:  # noqa: BLE001 - request isolation
                for field, reqs in by_field.items():
                    for req, _, _ in reqs:
                        self._fail(req, failed.get(field, exc))
                return
            recs.update(cached_aux)
            for (aid, name), reqs in by_field.items():
                arc, key = reqs[0][1], reqs[0][2]
                exc = failed.get((aid, name))
                if exc is None:
                    try:
                        e = entries[(aid, name)]
                        value = neurlz.decode_field_entry(
                            e, recs[(aid, name)],
                            [recs[(aid, a)] for a in e["aux"]],
                            arc["slice_axis"], self.device)
                    except Exception as err:  # noqa: BLE001
                        exc = err
                if exc is not None:
                    for req, _, _ in reqs:
                        self._fail(req, exc)
                    continue
                self.cache.put(key, value)
                for a in e["aux"]:
                    akey = ("aux", aid, a)
                    if akey not in pinned:
                        self.cache.put(akey, recs[(aid, a)])
                for req, _, _ in reqs:
                    req.future.set_result(self._out(value))
        finally:
            for akey in pinned:
                self.cache.unpin(akey)

    def __repr__(self) -> str:
        state = "running" if self.running else "stopped"
        return (f"<ArchiveServer {state} archives={len(self._archives)} "
                f"cache={len(self.cache)} requests={self._requests} "
                f"device={self.device}>")


def by_order(items):
    """Stable request-order iteration (requests carry a global seq)."""
    return sorted(items, key=lambda it: it[0].seq)
