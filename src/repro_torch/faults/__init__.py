"""Fault tolerance for the port: injection, retry, degradation.

Three cooperating pieces, carried by ``NeurLZConfig.faults`` /
``NeurLZ(faults=...)`` the way telemetry rides on ``config.telemetry``:

* :class:`FaultInjector` — deterministic site/invocation fault registry
  (``"train.<field>"``, ``"decode.entry"``).  Tests and chaos runs schedule
  exact failures; production leaves it ``None`` and every check is a no-op.
* :class:`RetryPolicy` / :func:`retry_with_backoff` — bounded exponential
  backoff around transient I/O (``Archive``'s container entry reads),
  counted on telemetry as ``faults.retries``.
* **Graceful degradation** — a per-field enhancer failure (non-finite loss,
  injected fault, host or CUDA out-of-memory) downgrades that field to a
  conv-only entry that still honours its exact error bound, recorded in the
  entry (``entry["degraded"]``), counted as ``faults.degraded`` and listed
  in ``timing["degraded_fields"]``, instead of aborting the snapshot.
  Reasons are normalized (:func:`degrade_reason`), so a field degraded by
  injection or by a non-finite loss packs to the same bytes as the JAX
  package's.

The straggler watchdog is :class:`StepWatchdog`
(``repro_torch.checkpoint.fault_tolerance``): give
``FaultConfig.straggler_deadline_s`` a value and the streaming scheduler
counts each field group that runs past it as ``faults.stragglers``; the
serial and batched engines ignore it, as the JAX package's do.  Imports
nothing of the engine and nothing but the standard library and ``torch``.
"""
from __future__ import annotations

import dataclasses

import torch

from ..checkpoint.fault_tolerance import StepWatchdog
from .injector import NULL_INJECTOR, FaultInjector, InjectedFault
from .retry import RetryPolicy, retry_with_backoff

__all__ = [
    "FaultConfig", "FaultInjector", "InjectedFault", "RetryPolicy",
    "StepWatchdog", "retry_with_backoff", "of", "DEFAULT", "is_degradable",
    "degrade_reason", "NULL_INJECTOR",
]

# Failures eligible for conv-only degradation.  Deliberately narrow: a
# genuine bug (shape mismatch, TypeError) must still crash loudly; only the
# failure modes a long-running job meets (injected chaos, host or device
# memory exhaustion, float traps) downgrade a field.
DEGRADABLE_EXCEPTIONS = (InjectedFault, MemoryError, FloatingPointError)


def is_degradable(exc: BaseException) -> bool:
    """True when a per-field enhancer failure should degrade the field to
    conv-only instead of aborting the snapshot.  A CUDA out-of-memory is
    ``torch.OutOfMemoryError``, matched by type."""
    return isinstance(exc, (*DEGRADABLE_EXCEPTIONS, torch.OutOfMemoryError))


def degrade_reason(exc: BaseException | None = None) -> str:
    """Normalized degradation reason recorded in the entry (the JAX
    package's strings; a CUDA out-of-memory gives
    ``"error:OutOfMemoryError"``)."""
    if exc is None:
        return "non-finite-loss"
    if isinstance(exc, InjectedFault):
        return "injected"
    return f"error:{type(exc).__name__}"


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Fault-tolerance knobs carried by ``NeurLZConfig.faults``.

    ``injector=None`` disables injection (production), ``retry=None``
    disables retries (fail fast), ``degrade`` controls conv-only
    degradation, ``straggler_deadline_s`` is the streaming scheduler's
    per-group deadline (the serial and batched engines ignore it).
    """

    injector: FaultInjector | None = None
    retry: RetryPolicy | None = None
    degrade: bool = True
    straggler_deadline_s: float | None = None

    def check(self, site: str) -> None:
        """Injection probe for ``site`` (no-op without an injector)."""
        if self.injector is not None:
            self.injector.check(site)

    def run(self, fn, *, site: str, tel=None):
        """Probe ``site`` then run ``fn``: under the retry policy when one
        is set, else one straight attempt.  The probe sits inside the
        retried closure, so a transiently planned injection heals on retry
        exactly like a real transient I/O error."""
        from ..obs import telemetry as obs_lib

        def attempt():
            self.check(site)
            return fn()

        if self.retry is None:
            return attempt()
        return retry_with_backoff(attempt, self.retry, site=site,
                                  tel=tel if tel is not None else obs_lib.NULL)


#: Shared default: no injection, no retries, degradation on.
DEFAULT = FaultConfig()


def of(config) -> FaultConfig:
    """The :class:`FaultConfig` carried by a config-like object
    (``.faults`` attribute), or :data:`DEFAULT`."""
    fc = getattr(config, "faults", None)
    return fc if fc is not None else DEFAULT
