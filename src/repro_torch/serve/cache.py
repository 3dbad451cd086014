"""Ledger-charged LRU cache of hot decoded fields and aux closures.

The port of the JAX package's ``repro/serve/cache.py``.  The serving tier
keeps recently decoded arrays resident so repeat reads of a hot field skip
disk and decode entirely, but "resident" bytes answer to the **same**
:class:`~repro_torch.streaming.pipeline.ResidencyLedger` the streaming
engine charges, so one process-wide ceiling governs encode, decode and
cache together.  Every cached value is charged under a ``cache:`` key;
insertion evicts least-recently-used *unpinned* values until the ledger
says the newcomer fits, and refuses to cache (rather than evict pinned work
or break the ceiling) when it cannot.

Pinning is the aux-closure refcount: while a decode that depends on a
cached aux closure is in flight, the server holds a pin on that entry and
:meth:`HotFieldCache.put`'s eviction scan skips it, so a closure is never
dropped out from under a dependent decode.
"""
from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np
import torch

from ..obs import telemetry as obs_lib


def _nbytes(value) -> int:
    """Resident bytes of a cached value: a numpy array, a torch tensor, or
    a list/tuple of them (aux closures cache as the list of
    reconstructions).  Anything else is refused rather than counted as 0."""
    if isinstance(value, (list, tuple)):
        return int(sum(_nbytes(v) for v in value))
    if isinstance(value, torch.Tensor):
        return value.numel() * value.element_size()
    if isinstance(value, np.ndarray):
        return int(value.nbytes)
    raise TypeError(f"cannot charge a {type(value).__name__} to the ledger")


class HotFieldCache:
    """LRU over decoded arrays, bytes charged to a shared ledger.

    Keys are arbitrary hashables (the server uses ``(archive, name, roi)``
    and ``("aux", archive, name)`` tuples).  All methods are thread-safe;
    values are returned as they are (callers treat cached arrays as
    immutable: the server hands out copies at its boundary).
    """

    def __init__(self, ledger, telemetry=None, *, prefix: str = "cache"):
        self.ledger = ledger
        self.tel = telemetry if telemetry is not None else obs_lib.NULL
        self._prefix = prefix
        self._lock = threading.RLock()
        self._data: OrderedDict = OrderedDict()   # key -> value (LRU order)
        self._pins: dict = {}                     # key -> refcount

    def _ledger_key(self, key) -> str:
        return f"{self._prefix}:{key!r}"

    # -- lookup -------------------------------------------------------------

    def get(self, key, default=None):
        """Return the cached value (marking it most-recently-used) or
        ``default``; counts a ``serve.cache.hits`` / ``.misses``."""
        with self._lock:
            if key in self._data:
                self._data.move_to_end(key)
                self.tel.counter("serve.cache.hits").add()
                return self._data[key]
        self.tel.counter("serve.cache.misses").add()
        return default

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._data

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    @property
    def keys(self) -> list:
        with self._lock:
            return list(self._data)

    @property
    def resident_bytes(self) -> int:
        """Bytes this cache currently charges to the ledger."""
        with self._lock:
            return sum(_nbytes(v) for v in self._data.values())

    # -- insertion / eviction ----------------------------------------------

    def put(self, key, value) -> bool:
        """Cache ``value`` under ``key``; True when it ends up resident.
        Evicts unpinned LRU entries until the ledger accepts the bytes; a
        value that still does not fit (a ceiling smaller than the value, or
        everything else pinned) is not cached: the ceiling is never
        exceeded and a pinned entry never evicted."""
        nbytes = _nbytes(value)
        with self._lock:
            if key in self._data:       # replace: drop the old charge first
                self._evict(key, count=False)
            while not self.ledger.fits(nbytes):
                victim = next((k for k in self._data
                               if not self._pins.get(k)), None)
                if victim is None:
                    self.tel.counter("serve.cache.rejected").add()
                    return False
                self._evict(victim)
            self._data[key] = value
            self._data.move_to_end(key)
            self.ledger.add(self._ledger_key(key), nbytes)
            return True

    def _evict(self, key, *, count: bool = True) -> None:
        self._data.pop(key, None)
        self.ledger.drop(self._ledger_key(key))
        if count:
            self.tel.counter("serve.cache.evictions").add()

    def invalidate(self, key) -> None:
        """Drop one entry (nothing when absent; a pin does not protect
        against an explicit invalidation, only against LRU eviction)."""
        with self._lock:
            if key in self._data:
                self._evict(key, count=False)
            self._pins.pop(key, None)

    def clear(self) -> None:
        with self._lock:
            for key in list(self._data):
                self._evict(key, count=False)
            self._pins.clear()

    # -- pinning ------------------------------------------------------------

    def pin(self, key) -> None:
        """Protect ``key`` from LRU eviction (refcounted; pairs with
        :meth:`unpin`).  A key that is not cached may be pinned: the pin
        applies if it arrives while the pin is held."""
        with self._lock:
            self._pins[key] = self._pins.get(key, 0) + 1

    def unpin(self, key) -> None:
        with self._lock:
            n = self._pins.get(key, 0) - 1
            if n <= 0:
                self._pins.pop(key, None)
            else:
                self._pins[key] = n

    def pinned(self, key) -> bool:
        with self._lock:
            return bool(self._pins.get(key))

    def __repr__(self) -> str:
        with self._lock:
            return (f"<HotFieldCache entries={len(self._data)} "
                    f"pinned={sum(1 for k in self._data if self._pins.get(k))} "
                    f"bytes={self.resident_bytes}>")
