"""Deterministic fault injection for the compression stack.

A :class:`FaultInjector` is a registry of *sites* — named points in the
pipeline (``"writer.add_entry"``, ``"train.temperature"``,
``"decode.entry"``) that call :meth:`FaultInjector.check` before doing
their work.  The injection *plan* maps a site to the zero-based invocation
indices at which the check raises :class:`InjectedFault`; everything is
counted, nothing is random, so a crash-recovery test replays bit-identically
across runs and engines.  Sites are matched exactly, or by prefix when the
plan key ends with ``"*"`` (``"train.*"`` hits every field's training).
A copy of the JAX package's ``repro.faults.injector``: the same plan fires
at the same invocations.
"""
from __future__ import annotations

import threading

__all__ = ["InjectedFault", "FaultInjector", "NULL_INJECTOR"]


class InjectedFault(RuntimeError):
    """Raised by :meth:`FaultInjector.check` when a site's plan fires."""

    def __init__(self, site: str, invocation: int):
        super().__init__(f"injected fault at site {site!r} "
                         f"(invocation {invocation})")
        self.site = site
        self.invocation = invocation


class FaultInjector:
    """Deterministic, thread-safe site/invocation fault registry.

    ``FaultInjector({"writer.add_entry": [1], "train.*": 0})`` raises on
    the second ``writer.add_entry`` check and the first check of any
    ``train.``-prefixed site.  ``hits`` records every (site, invocation)
    that fired; ``count(site)`` is the number of checks a site has seen —
    the accounting retry tests use to assert a transient fault was retried
    exactly once.
    """

    def __init__(self, plan: dict | None = None):
        self._plan: dict[str, set[int]] = {}
        for site, spec in (plan or {}).items():
            if isinstance(spec, int):
                spec = [spec]
            self._plan[site] = set(spec)
        self._counts: dict[str, int] = {}
        self.hits: list[tuple[str, int]] = []
        self._lock = threading.Lock()

    def _match(self, site: str) -> set[int] | None:
        spec = self._plan.get(site)
        if spec is not None:
            return spec
        for key, spec in self._plan.items():
            if key.endswith("*") and site.startswith(key[:-1]):
                return spec
        return None

    def check(self, site: str) -> None:
        """Count one invocation of ``site``; raise if the plan says so."""
        with self._lock:
            n = self._counts.get(site, 0)
            self._counts[site] = n + 1
            spec = self._match(site)
            fire = spec is not None and n in spec
            if fire:
                self.hits.append((site, n))
        if fire:
            raise InjectedFault(site, n)

    def count(self, site: str) -> int:
        """Checks seen by ``site`` so far (fired or not)."""
        with self._lock:
            return self._counts.get(site, 0)


class _NullInjector:
    """No-fault injector: ``check`` is a no-op (shared singleton)."""

    __slots__ = ()

    def check(self, site: str) -> None:
        return None

    def count(self, site: str) -> int:
        return 0


NULL_INJECTOR = _NullInjector()
