"""AdamW with the JAX package's update formula (``repro/optim/adamw.py``):
bias-corrected moments, ``eps`` outside the square root, decoupled weight
decay, float32 state.  Parameters are updated in place."""
from __future__ import annotations

import torch


class AdamW:
    def __init__(self, params, *, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0):
        self.params = list(params)
        self.b1, self.b2, self.eps, self.wd = b1, b2, eps, weight_decay
        self.step_count = 0
        self.mu = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
        self.nu = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]

    @torch.no_grad()
    def step(self, grads, lr: float) -> None:
        self.step_count += 1
        c1 = 1.0 - self.b1 ** self.step_count
        c2 = 1.0 - self.b2 ** self.step_count
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            g = g.float()
            m.mul_(self.b1).add_((1.0 - self.b1) * g)
            v.mul_(self.b2).add_((1.0 - self.b2) * torch.square(g))
            delta = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            if self.wd:
                delta = delta + self.wd * p.float()
            p.copy_(p.float() - lr * delta)
