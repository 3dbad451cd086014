"""Shared model primitives: norms, rotary embeddings, initializers.

Parameters are nested dicts of tensors whose names follow the JAX
package's convention (``w_in`` / ``w_out`` for the two halves of a
tensor-parallel pair, ``embed``, ``*_experts_*``, 1-D scales), so a
checkpoint's flat keys are the same in both packages.

Norms, rotary angles, attention scores and the recurrent cells compute in
float32 (the JAX package's precision) whatever the model's dtype, or in
float64 for a float64 model (:func:`compute_dtype`), which the chip run
uses as a well-conditioned card-vs-CPU check.

Initializers draw from an explicit ``torch.Generator`` on the tensor's
device; their values are not the JAX package's (tests carry its weights
across with ``model.params_from_jax``).  With no generator they draw
nothing: the shapes of ``model.abstract_params`` on the meta device, which
has no generator.  Every initializer takes a
``lead`` shape, the stacked layer or unit axes, so a stack of layers is
one draw.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..distributed.sharding import join


def normal(gen, shape, dtype, scale: float, device):
    """``N(0, 1) · scale`` drawn in float32, then cast to ``dtype``; with
    ``gen=None`` an empty tensor of that shape (the meta device's)."""
    if gen is None:
        return torch.empty(tuple(shape), dtype=dtype, device=device)
    x = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=device)
    return x.mul_(scale).to(dtype)


def dense_init(gen, d_in: int, d_out: int, dtype, device, scale: float | None = None,
               lead: tuple = ()):
    s = scale if scale is not None else 1.0 / np.sqrt(d_in)
    return normal(gen, (*lead, d_in, d_out), dtype, s, device)


def embed_init(gen, vocab: int, d: int, dtype, device):
    return normal(gen, (vocab, d), dtype, 0.02, device)


def zeros(shape, dtype, device, lead: tuple = ()):
    return torch.zeros((*lead, *shape), dtype=dtype, device=device)


def compute_dtype(dtype) -> torch.dtype:
    """float32, or float64 for a float64 model."""
    return torch.promote_types(dtype, torch.float32)


def rmsnorm(x, scale, eps: float = 1e-6):
    acc = compute_dtype(x.dtype)
    x32 = x.to(acc)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.to(acc))).to(x.dtype)


def rope_freqs(head_dim: int, theta: float):
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))


def apply_rope(x, positions, theta: float):
    """x: [..., S, H, D]; positions: [..., S] integer.  Rotates the two
    halves of the head dim against each other (not interleaved pairs)."""
    d = x.shape[-1]
    acc = compute_dtype(x.dtype)
    freqs = torch.from_numpy(rope_freqs(d, theta)).to(x.device, acc)  # [D/2]
    ang = positions[..., None].to(acc) * join(freqs, positions)    # [..., S, D/2]
    cos = torch.cos(ang)[..., None, :]                             # [..., S, 1, D/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(acc), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def head_rmsnorm(x, scale, eps: float = 1e-6):
    """QK-norm: RMS norm over the head dim (qwen3/gemma3 style)."""
    return rmsnorm(x, scale, eps)


def _gelu_tanh(v):
    return F.gelu(v, approximate="tanh")


def activation(name: str):
    return {"silu": F.silu, "gelu": _gelu_tanh, "relu": F.relu}[name]
