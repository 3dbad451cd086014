"""Learning-rate schedules as functions of the step index."""
from __future__ import annotations

import math


def cosine_schedule(base_lr: float, total_steps: int, min_frac: float = 0.0):
    """Cosine annealing from ``base_lr`` to ``base_lr * min_frac`` — the
    paper's enhancer schedule (1e-2, cosine over 100 epochs)."""
    def lr(step: int) -> float:
        t = min(float(step), total_steps) / max(total_steps, 1)
        cos = 0.5 * (1.0 + math.cos(math.pi * t))
        return base_lr * (min_frac + (1.0 - min_frac) * cos)
    return lr
