"""Bounded retry with exponential backoff for transient pipeline faults.

The policy is a frozen dataclass so it rides inside configs the same way
``TelemetryConfig`` does; :func:`retry_with_backoff` is the single executor
(``Archive`` runs its container entry reads through it, site
``"decode.entry"``).  Retries are counted on the run's telemetry
(``faults.retries`` and ``faults.retries.<site>``) so a run that healed
transient I/O errors says so in its summary.  A copy of the JAX package's
``repro.faults.retry``.
"""
from __future__ import annotations

import dataclasses
import time

from ..obs import telemetry as obs_lib
from .injector import InjectedFault

__all__ = ["RetryPolicy", "retry_with_backoff"]


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """``attempts`` total tries (1 = fail fast), exponential backoff
    between them.  ``retry_on`` is the exception allowlist — everything
    else propagates on the first raise."""

    attempts: int = 3
    backoff_s: float = 0.05
    multiplier: float = 2.0
    max_backoff_s: float = 2.0
    retry_on: tuple = (OSError, InjectedFault)

    def __post_init__(self):
        if self.attempts < 1:
            raise ValueError("RetryPolicy.attempts must be >= 1")
        if self.backoff_s < 0 or self.max_backoff_s < 0:
            raise ValueError("RetryPolicy backoff must be >= 0")
        if self.multiplier < 1.0:
            raise ValueError("RetryPolicy.multiplier must be >= 1")


def retry_with_backoff(fn, policy: RetryPolicy | None = None, *,
                       site: str = "", tel=obs_lib.NULL, sleep=time.sleep):
    """Run ``fn()`` under ``policy``; re-raise the last failure once the
    attempt budget is spent.  ``sleep`` is injectable so tests assert the
    backoff sequence without waiting it out."""
    policy = policy if policy is not None else RetryPolicy()
    delay = policy.backoff_s
    for attempt in range(policy.attempts):
        try:
            return fn()
        except policy.retry_on:
            if attempt == policy.attempts - 1:
                raise
            tel.counter("faults.retries").add()
            if site:
                tel.counter(f"faults.retries.{site}").add()
            sleep(delay)
            delay = min(delay * policy.multiplier, policy.max_backoff_s)
