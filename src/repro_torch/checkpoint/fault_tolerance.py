"""Fault-tolerance utilities: straggler watchdog, failure injection, restart.

A copy of the JAX package's ``repro/checkpoint/fault_tolerance.py``.  A
host dying is handled by checkpoint and restart (the trainer resumes from
``latest_step`` with the same data order through the checkpointable token
stream; :func:`run_with_restarts` drives it, :class:`FailureInjector`
fails a step on purpose); a straggler by :class:`StepWatchdog`, a per-step
deadline that records overruns and can ask for an early checkpoint.  The
streaming scheduler wraps each field group in a watchdog step: a group that
runs past ``FaultConfig.straggler_deadline_s`` is recorded as an overrun
and counted as ``faults.stragglers``.  Pure host logic on a
``threading.Timer``; no device sync.
"""
from __future__ import annotations

import threading
import time


class StepWatchdog:
    """Per-step deadline monitor.

    ``with watchdog.step(i): run_step()`` — if the step exceeds
    ``deadline_s``, the overrun is recorded and ``on_straggler`` fires (on
    the timer's thread).
    """

    def __init__(self, deadline_s: float, on_straggler=None):
        self.deadline_s = deadline_s
        self.on_straggler = on_straggler
        self.overruns: list[tuple[int, float]] = []
        self.durations: list[float] = []

    class _StepCtx:
        def __init__(self, wd, idx):
            self.wd, self.idx = wd, idx

        def __enter__(self):
            self.t0 = time.time()
            self.fired = False
            self.timer = threading.Timer(self.wd.deadline_s, self._fire)
            self.timer.daemon = True
            self.timer.start()
            return self

        def _fire(self):
            self.fired = True
            self.wd.overruns.append((self.idx, time.time() - self.t0))
            if self.wd.on_straggler:
                self.wd.on_straggler(self.idx)

        def __exit__(self, *exc):
            self.timer.cancel()
            self.wd.durations.append(time.time() - self.t0)
            return False

    def step(self, idx: int):
        return self._StepCtx(self, idx)

    def stats(self) -> dict:
        d = self.durations
        return {
            "steps": len(d),
            "mean_s": sum(d) / len(d) if d else 0.0,
            "max_s": max(d) if d else 0.0,
            "overruns": len(self.overruns),
        }


class FailureInjector:
    """Deterministic failure injection for restart drills: raises
    :class:`SimulatedFailure` at the configured step."""

    def __init__(self, fail_at_step: int | None = None):
        self.fail_at_step = fail_at_step

    def maybe_fail(self, step: int):
        if self.fail_at_step is not None and step == self.fail_at_step:
            raise SimulatedFailure(f"injected failure at step {step}")


class SimulatedFailure(RuntimeError):
    pass


def run_with_restarts(make_trainer, max_restarts: int = 3):
    """Supervisor loop: (re)build the trainer from the latest checkpoint and
    run until completion, tolerating ``SimulatedFailure``s."""
    attempts = 0
    while True:
        try:
            return make_trainer()
        except SimulatedFailure:
            attempts += 1
            if attempts > max_restarts:
                raise
