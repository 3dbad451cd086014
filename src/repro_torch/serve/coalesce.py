"""Request intake and batching window for the archive server.

A copy of the JAX package's ``repro/serve/coalesce.py``: pure host code.

Decode requests land on a thread-safe queue; the server's dispatcher
drains them in *batches*: the first request blocks until something
arrives, then the window stays open ``window_s`` seconds (or until
``max_batch`` requests) collecting whatever else lands.  Requests in one
batch that agree on the registry's ``decode_key`` signature — same
(compressor, shape, dtype, layout) — later execute as one stacked
``decompress_batched`` dispatch, so the window is what turns N concurrent
readers into one kernel launch (one stacked ``lorenzo3d_inv``, or one
stacked interpolation walk).

The coalescer knows nothing about archives; it moves :class:`Request`
objects.  Each request carries a :class:`Future` the submitter blocks on.
"""
from __future__ import annotations

import itertools
import queue
import threading
import time

_STOP = object()        # sentinel: dispatcher should exit after this batch


class Future:
    """Minimal one-shot future (set once, then wait; the standard
    library's ``concurrent.futures.Future`` brings executor semantics
    the server does not use)."""

    __slots__ = ("_event", "_value", "_error")

    def __init__(self):
        self._event = threading.Event()
        self._value = None
        self._error = None

    def set_result(self, value) -> None:
        self._value = value
        self._event.set()

    def set_error(self, exc: BaseException) -> None:
        self._error = exc
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = None):
        if not self._event.wait(timeout):
            raise TimeoutError("request still pending")
        if self._error is not None:
            raise self._error
        return self._value


class Request:
    """One pending decode: field ``name`` (optionally a ``roi``) against
    an archive registered under ``archive_id``."""

    __slots__ = ("archive_id", "name", "roi", "future", "seq")
    _seq = itertools.count()

    def __init__(self, archive_id: str, name: str, roi=None):
        self.archive_id = archive_id
        self.name = name
        self.roi = roi
        self.future = Future()
        self.seq = next(Request._seq)

    def __repr__(self) -> str:
        roi = f" roi={self.roi}" if self.roi is not None else ""
        return f"<Request #{self.seq} {self.archive_id}:{self.name}{roi}>"


class Coalescer:
    """Bounded request queue with a batching drain.

    ``window_s`` is the coalescing window: after the first request of a
    batch arrives, the drain keeps collecting until the window closes or
    ``max_batch`` requests are in hand.  ``window_s=0`` still coalesces
    whatever is *already* queued (one non-blocking sweep) — tests drive
    determinism by queueing first and draining second.
    """

    def __init__(self, *, window_s: float = 0.002, max_batch: int = 64):
        self.window_s = float(window_s)
        self.max_batch = int(max_batch)
        self._q: queue.Queue = queue.Queue()
        self._closed = False

    def submit(self, req: Request) -> Request:
        if self._closed:
            raise RuntimeError("coalescer is closed")
        self._q.put(req)
        return req

    def close(self) -> None:
        """Refuse new submits and wake the dispatcher for a final drain."""
        if not self._closed:
            self._closed = True
            self._q.put(_STOP)

    @property
    def closed(self) -> bool:
        return self._closed

    def pending(self) -> int:
        return self._q.qsize()

    def drain(self, *, block: bool = True) -> tuple[list[Request], bool]:
        """Collect one batch; returns ``(requests, stopping)``.

        Blocks for the first request (unless ``block=False``), then holds
        the window open for stragglers.  ``stopping=True`` means the stop
        sentinel was seen — serve what was returned, then exit.
        """
        batch: list[Request] = []
        try:
            first = self._q.get(block=block)
        except queue.Empty:
            return [], False
        if first is _STOP:
            return [], True
        batch.append(first)
        deadline = time.monotonic() + self.window_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            try:
                nxt = self._q.get(block=remaining > 0,
                                  timeout=max(remaining, 0) or None)
            except queue.Empty:
                break
            if nxt is _STOP:
                return batch, True
            batch.append(nxt)
        return batch, False
