"""Straggler detection: a per-step deadline watchdog.

A copy of the JAX package's ``repro/checkpoint/fault_tolerance.py``
:class:`StepWatchdog`.  The streaming scheduler wraps each field group in a
step: a group that runs past ``FaultConfig.straggler_deadline_s`` is
recorded as an overrun and counted as ``faults.stragglers``.  Pure host
logic on a ``threading.Timer``; no device sync.
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
