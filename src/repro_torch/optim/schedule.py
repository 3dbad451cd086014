"""Learning-rate schedules as functions of the step index."""
from __future__ import annotations

import math

import numpy as np


def cosine_schedule(base_lr: float, total_steps: int, min_frac: float = 0.0):
    """Cosine annealing from ``base_lr`` to ``base_lr * min_frac`` — the
    paper's enhancer schedule (1e-2, cosine over 100 epochs)."""
    def lr(step: int) -> float:
        t = min(float(step), total_steps) / max(total_steps, 1)
        cos = 0.5 * (1.0 + math.cos(math.pi * t))
        return base_lr * (min_frac + (1.0 - min_frac) * cos)
    return lr


def warmup_cosine(base_lr: float, warmup_steps: int, total_steps: int,
                  min_frac: float = 0.1):
    """Linear warmup then cosine decay — the LM trainer schedule.

    Evaluated in float32, as the JAX package evaluates it on an int32 step:
    every operation on numpy float32 scalars (the constants rounded to
    float32 where they meet the step), the cosine correctly rounded to
    float32 (XLA's float32 cosine is not always, so the two schedules may
    differ in the last two bits).  Returns that float32 value as a Python
    float."""
    f32 = np.float32

    def lr(step: int) -> float:
        s = f32(step)
        if s < warmup_steps:
            return float(f32(base_lr) * s / f32(max(warmup_steps, 1)))
        t = np.clip((s - f32(warmup_steps)) / f32(max(total_steps - warmup_steps, 1)),
                    f32(0), f32(1))
        c = f32(math.cos(float(f32(math.pi) * t)))
        return float(f32(base_lr) * (f32(min_frac) + f32((1.0 - min_frac) * 0.5)
                                     * (f32(1) + c)))
    return lr
