"""AdamW with the JAX package's update formula (``repro/optim/adamw.py``):
bias-corrected moments, ``eps`` outside the square root, decoupled weight
decay, float32 state.  Parameters are updated in place.

Two forms: :class:`AdamW` over a list of tensors (the enhancer's trainer),
and the tree form :class:`AdamWState` / :func:`adamw_init` /
:func:`adamw_update` over nested dicts of tensors (the LM trainer), with
the JAX package's global-norm clipping.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor


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


# ---------------------------------------------------------------------------
# tree form
# ---------------------------------------------------------------------------

class AdamWState(NamedTuple):
    step: int     # updates taken (the JAX package's int32 scalar)
    mu: Any       # first moment, float32, the parameters' tree
    nu: Any       # second moment


# The in-place update runs over pieces of at most this many values (whole
# slices of a stacked leaf's leading axis), so its float32 temporaries stay
# at one piece: qwen3-4b's largest leaf, [36, 2560, 9728], would need 3.6 GB
# for each temporary of the whole leaf.
PIECE = 1 << 26


def tree_items(tree, prefix: tuple = ()):
    """``(path, leaf)`` of a nested dict in the JAX package's order (sorted
    keys), ``path`` the tuple of keys."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_items(tree)]


def tree_unflatten(like, leaves) -> dict:
    """A tree shaped like ``like`` holding ``leaves`` in :func:`tree_leaves`
    order."""
    return _unflatten(like, iter(leaves))


def _unflatten(t, it):
    # Module-level, not a closure: a recursive closure is a reference cycle
    # that would hold ``leaves`` (a whole gradient tree on the card) until
    # the cyclic collector runs.
    if isinstance(t, dict):
        return {k: _unflatten(t[k], it) for k in sorted(t)}
    return next(it)


def tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def pieces(t: torch.Tensor) -> list[torch.Tensor]:
    """Views of ``t`` along its leading axis, each of at most PIECE values
    (one row at least); ``t`` itself when it is that small, or a DTensor
    (a device holds its shard, and a split along a sharded axis would
    gather it)."""
    if t.numel() <= PIECE or t.ndim == 0 or isinstance(t, DTensor):
        return [t]
    rows = max(1, PIECE // max(t[0].numel(), 1))
    return list(torch.split(t, rows, dim=0))


def adamw_init(params) -> AdamWState:
    def zeros(p):
        # zeros_like: a DTensor parameter's moments are placed as it is.
        return torch.zeros_like(p, dtype=torch.float32)
    return AdamWState(step=0, mu=tree_map(zeros, params),
                      nu=tree_map(zeros, params))


@torch.no_grad()
def global_norm(grads) -> torch.Tensor:
    """``sqrt(Σ_leaves Σ g²)`` in float32, the clip's norm, as a 0-d tensor
    on the gradients' device (no host sync)."""
    total = None
    for g in tree_leaves(grads):
        for gp in pieces(g):
            s = torch.sum(torch.square(gp.float()))
            total = s if total is None else total + s
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, *, lr, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0,
                 grad_clip_norm: float | None = None, gnorm=None):
    """One AdamW step, in place: ``params``, ``state.mu`` and ``state.nu``
    are updated where they lie and returned with the new step count.

    The JAX package's arithmetic, piece by piece: the gradient cast to
    float32 *before* the clip's scale multiplies it (a float32 0-d tensor
    does not promote a bfloat16 one in torch, where it does in JAX), float32
    moments, the new value cast back to the parameter's dtype.  ``lr`` is a
    float (a schedule's value); ``gnorm``, where the caller has it, is
    :func:`global_norm` of ``grads``."""
    step = state.step + 1
    scale = None
    if grad_clip_norm is not None:
        if gnorm is None:
            gnorm = global_norm(grads)
        scale = torch.clamp(grad_clip_norm / (gnorm + 1e-12), max=1.0)
    # The bias corrections in float32, as the JAX package reckons them
    # (``1 - b ** step`` of float32 operands): in float64, 1 - 0.999 differs
    # from float32's 1 - 0.999f by 1.3e-5 relative.
    f32 = np.float32
    c1 = float(f32(1) - f32(b1) ** f32(step))
    c2 = float(f32(1) - f32(b2) ** f32(step))
    for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state.mu),
                          tree_leaves(state.nu), tree_leaves(params)):
        for gp, mp, vp, pp in zip(pieces(g), pieces(m), pieces(v), pieces(p)):
            # A float32 copy, squared in place below (never the caller's).
            g32 = (gp.float() * scale if scale is not None
                   else gp.to(torch.float32, copy=True))
            mp.mul_(b1).add_(g32, alpha=1.0 - b1)
            g32.square_()
            vp.mul_(b2).add_(g32, alpha=1.0 - b2)
            delta = torch.sqrt(vp / c2).add_(eps)
            delta = torch.div(mp / c1, delta, out=delta)
            p32 = pp.float()
            if weight_decay:
                delta.add_(p32, alpha=weight_decay)
            pp.copy_(p32.sub_(delta.mul_(lr)))
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu)
