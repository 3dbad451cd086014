"""Async archive writer: entry packing, codec and incremental append on a
writer thread.

The port of the JAX package's ``repro/streaming/writer.py``.  The scheduler
hands over *unpacked* per-field results (trained weights, normalization
stats, the strict-mode outlier mask, the conventional archive) the moment
a group retires; everything downstream — weight flattening + codec
compression (:func:`repro_torch.core.archive.pack_weights` via
:func:`repro_torch.core.neurlz.pack_entry`), outlier coordinate encoding,
msgpack packing and the append to the streaming container — runs on this
thread, overlapped with the next group's training.  The queue is bounded
so a slow disk back-pressures the pipeline instead of buffering unbounded
entries.

The thread does host work only: a task holds host copies (weights as
numpy arrays, the loss history as a list, the mask as a numpy array), so
no CUDA call is made off the main thread and the device sees the serial
engine's launch order.  Entries come from the serial engine's packing
helpers, so the bytes that land in the container are the in-memory
engines' archive entries.

Failure semantics: a writer-thread error is **sticky** — every later
``put``/``drain``/``close`` re-raises it (chained to the original),
``close`` after a failure *aborts* the container (no footer is ever
written over a bad byte stream) and the thread is always joined.  Appends
go through the fault layer: the injection site ``"writer.add_entry"`` is
probed per attempt, and with a :class:`repro_torch.faults.RetryPolicy` a
failed append rolls the container back to the record boundary
(:meth:`ArchiveAppender.rewind`) before retrying, so a healed transient
error leaves no torn bytes.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time

import numpy as np

from .. import faults as faults_lib
from ..compressors import outliers as outlier_codec
from ..core import archive as arc_io
from ..core import neurlz
from ..obs import telemetry as obs_lib


@dataclasses.dataclass
class EntryTask:
    """One field's finished-but-unpacked compression result."""
    name: str
    conv_arc: dict
    params: object              # trained enhancer tree of numpy arrays
    stats: list
    aux: list[str]
    eb: float
    net_cfg: object
    history: list
    mask: np.ndarray | None     # strict-mode outlier mask (encoded here)
    mode: str | None = None     # per-field regulation-mode override
    #   (None -> the writer config's mode; set by mixed-bound runs so the
    #   packed entry records the mode the field actually honored)
    trace: tuple | None = None  # (vrange, n_points) when telemetry learning
    #   traces are on: the writer records the trajectory after packing, when
    #   the entry's actual base bytes are known
    degraded: str | None = None  # normalized degrade reason: the field's
    #   enhancer failed and the writer packs a conv-only entry instead
    #   (params/stats/mask are ignored)


@dataclasses.dataclass
class _RawEntry:
    """A pre-packed entry appended verbatim (the resume path re-appends
    salvaged entries through this, preserving per-entry bytes)."""
    name: str
    entry: dict


class AsyncArchiveWriter:
    """Bounded-queue writer thread over :class:`ArchiveAppender`.

    ``put`` blocks when ``queue_size`` entries are already pending (disk
    back-pressure).  ``close`` drains the queue, writes the index footer
    and returns writer statistics; a failure on the writer thread
    re-raises from every subsequent ``put``/``close`` (sticky), and a
    post-failure ``close`` aborts instead of sealing a bogus footer.

    Container knobs: ``version``/``durability``/``checksum``/``prelude``
    forward to :class:`ArchiveAppender` — v2 + a prelude makes a crashed
    run's partial container self-describing for salvage and resume.
    """

    _STOP = object()

    def __init__(self, sink, config, *, collect_stats: bool = True,
                 queue_size: int = 4, telemetry=None, faults=None,
                 version: int = 2, durability: str = "none",
                 checksum: str = "crc32", prelude: dict | None = None):
        self._appender = arc_io.ArchiveAppender(
            sink, version=version, durability=durability, checksum=checksum,
            prelude=prelude if version == 2 else None)
        self._config = config
        self._collect_stats = collect_stats
        self.tel = telemetry if telemetry is not None else obs_lib.NULL
        self.faults = faults if faults is not None else faults_lib.of(config)
        self._q: queue.Queue = queue.Queue(maxsize=max(1, queue_size))
        self._error: BaseException | None = None
        self._closed = False
        self.busy_s = 0.0
        self.put_wait_s = 0.0
        self.entries = 0
        self.degraded: list[str] = []
        self._thread = threading.Thread(target=self._run,
                                        name="neurlz-archive-writer",
                                        daemon=True)
        self._thread.start()

    def _pack(self, task: EntryTask) -> dict:
        cfg = neurlz.field_config(self._config, task.mode)
        if task.degraded is not None:
            self.degraded.append(task.name)
            self.tel.counter("faults.degraded").add()
            return neurlz.pack_degraded_entry(cfg, task.conv_arc, task.eb,
                                              task.degraded)
        entry = neurlz.pack_entry(
            cfg, task.conv_arc, task.params, task.stats, task.aux, task.eb,
            task.net_cfg, task.history, self._collect_stats)
        if task.mask is not None:
            entry["outliers"] = outlier_codec.encode_outliers(task.mask)
        if task.trace is not None:
            obs_lib.learning_trace(
                self.tel, task.name, task.history, eb=task.eb,
                vrange=task.trace[0],
                base_bytes=neurlz.entry_base_bytes(entry),
                n_points=task.trace[1], mode=cfg.mode)
        return entry

    def _write_entry(self, name: str, entry: dict) -> None:
        """Append under the fault layer: probe the injection site, and on a
        retryable failure rewind to the record boundary before the next
        attempt — a retried append never leaves torn bytes behind."""
        boundary = self._appender.bytes_written

        def attempt():
            self.faults.check("writer.add_entry")
            try:
                self._appender.add_entry(name, entry)
            except BaseException:
                self._appender.rewind(boundary)
                raise

        if self.faults.retry is None:
            attempt()
        else:
            faults_lib.retry_with_backoff(attempt, self.faults.retry,
                                          site="writer.add_entry",
                                          tel=self.tel)

    def _run(self) -> None:
        while True:
            task = self._q.get()
            try:
                if task is self._STOP:
                    return
                if self._error is not None:
                    continue        # drain after failure (puts never block)
                t0 = time.time()
                if isinstance(task, _RawEntry):
                    with self.tel.span("write", field=task.name):
                        self._write_entry(task.name, task.entry)
                else:
                    with self.tel.span("write", field=task.name):
                        self._write_entry(task.name, self._pack(task))
                self.tel.counter("writer.entries").add()
                self.tel.gauge("writer.queue_depth").set(self._q.qsize())
                self.busy_s += time.time() - t0
                self.entries += 1
            except BaseException as exc:  # noqa: BLE001 - reported to caller
                self._error = exc
            finally:
                self._q.task_done()

    def _check(self) -> None:
        # Sticky: the same failure re-raises from every later call, so the
        # caller's error path and a subsequent close() agree on the cause.
        if self._error is not None:
            raise RuntimeError("archive writer thread failed") from self._error

    @property
    def failed(self) -> bool:
        return self._error is not None

    def put(self, task: EntryTask) -> None:
        """Enqueue one entry; blocks under back-pressure (full queue).  The
        blocked time is writer work stalling compute, counted as
        non-overlapped in the stats."""
        self._check()
        if self._q.full():
            self.tel.counter("writer.backpressure_stalls").add()
        t0 = time.time()
        self._q.put(task)
        self.tel.gauge("writer.queue_depth").set(self._q.qsize())
        self.put_wait_s += time.time() - t0

    def put_entry(self, name: str, entry: dict) -> None:
        """Enqueue a pre-packed entry, appended verbatim (resume path)."""
        self._check()
        t0 = time.time()
        self._q.put(_RawEntry(name, entry))
        self.put_wait_s += time.time() - t0

    def drain(self) -> None:
        """Block until every queued entry is processed (the thread stays
        up), then surface any writer-thread failure."""
        self._q.join()
        self._check()

    def _shutdown(self) -> None:
        if not self._closed:
            self._closed = True
            self._q.put(self._STOP)
        self._thread.join()

    def close(self, meta: dict) -> dict:
        """Drain, seal the container, join the thread; returns stats.

        ``close_wait_s`` is the time the caller spent blocked here — writer
        work that did *not* overlap compute (the overlap metric in
        benchmarks is derived from it).  If the writer thread failed, the
        container is **aborted** (no footer over a bad byte stream — on v2
        the sealed entries stay salvageable) and the failure re-raises.
        """
        t0 = time.time()
        self._shutdown()
        if self._error is not None:
            self._appender.abort()
            self._check()
        total = self._appender.finalize(meta)
        return {
            "entries": self.entries,
            "bytes_written": total,
            "writer_busy_s": self.busy_s,
            "writer_put_wait_s": self.put_wait_s,
            "writer_close_wait_s": time.time() - t0,
            "degraded": list(self.degraded),
        }

    def abort(self) -> None:
        """Stop the thread without finalizing (error-path cleanup)."""
        if not self._closed:
            self._closed = True
            self._q.put(self._STOP)
        self._thread.join(timeout=10.0)
        self._appender.abort()