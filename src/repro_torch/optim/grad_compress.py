"""Error-bounded gradient compression with error feedback.

The port of the JAX package's ``repro/optim/grad_compress.py``, on trees of
tensors (nested dicts):

  * ``quantize_ef`` — per-tensor linear quantization of the gradient to
    int8 with an *error-feedback* residual carried to the next step
    (Seide et al.; Karimireddy et al.);
  * ``dequantize`` / ``init_ef``;
  * ``compressed_psum`` — quantize → all-reduce (int32 sum) → dequantize
    over a ``torch.distributed`` group (the cross-pod gradient all-reduce),
    every rank quantizing with one shared scale; ``bf16_psum``, the
    cheaper baseline;
  * ``neurlz_grad_archive`` — a host-side error-bounded archive of a
    gradient tree through the port's ``szlike`` with the Lorenzo predictor
    (the ``lorenzo3d_fwd`` kernel on the card), for debugging and replay.
"""
from __future__ import annotations

import numpy as np
import torch

from .adamw import tree_items, tree_leaves, tree_map, tree_unflatten


def quantize_ef(grads, ef_state, *, bits: int = 8):
    """Error-feedback quantization.  Returns ``(q int8 tree, scales,
    new_ef)``: q = round((g + ef) / scale), scale = max|g + ef| / qmax per
    tensor (float32, at least 1e-30); the quantization error is the next
    step's ``ef``."""
    if isinstance(grads, dict):
        parts = {k: quantize_ef(grads[k], ef_state[k], bits=bits) for k in grads}
        return tuple({k: p[i] for k, p in parts.items()} for i in range(3))
    qmax = float(2 ** (bits - 1) - 1)
    g32 = grads.float() + ef_state
    scale = torch.clamp(torch.max(torch.abs(g32)) / qmax, min=1e-30)
    q = torch.clamp(torch.round(g32 / scale), -qmax, qmax).to(torch.int8)
    return q, scale, g32 - q.float() * scale


def dequantize(qs, scales):
    return tree_map(lambda q, s: q.float() * s, qs, scales)


def init_ef(grads_like):
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads_like)


def compressed_psum(grads, ef_state, group=None, *, bits: int = 8,
                    stats: dict | None = None):
    """Error-feedback int8 all-reduce of a gradient tree over ``group``
    (the default group unless given).  Returns ``(mean, new_ef)``;
    ``ef_state=None`` is a carry of zeros.

    Leaf by leaf: ``g32 = g + ef``; ``max|g32|`` all-reduced with MAX first
    (one float32 a leaf), so every rank quantizes with the one shared scale
    ``max(gmax / qmax, 1e-30)``; ``q = clip(round(g32 / scale))``, the
    residual ``g32 − q · scale`` the next step's ``ef``; the ``q`` summed
    in int32; ``mean = (Σq · scale) / n``.  Where every rank's ``max|g32|``
    is already equal this is the JAX package's arithmetic bit for bit.
    That package decodes the sum of codes made at per-rank scales with the
    largest scale (``src/repro/optim/grad_compress.py:66-72``), which is
    wrong wherever the ranks' scales differ.

    The sum travels as int32: 4 B a value, as the JAX package's does too
    (its docstring's int8 payload would need an all-gather).  ``stats``,
    where given, gets ``wire_bytes`` (the bytes handed to the all-reduces,
    the shared maxima's included) and ``values``.  One leaf's float32
    temporaries live at a time."""
    import torch.distributed as dist

    leaves_g = tree_leaves(grads)
    leaves_e = (tree_leaves(ef_state) if ef_state is not None
                else [None] * len(leaves_g))
    qmax = float(2 ** (bits - 1) - 1)
    n = dist.get_world_size(group)

    def carry(g, e):
        # A float32 copy (never the caller's gradient: it is written below).
        return g.float() + e if e is not None else g.to(torch.float32, copy=True)

    gmax = torch.stack([torch.max(torch.abs(carry(g, e)))
                        for g, e in zip(leaves_g, leaves_e)])
    dist.all_reduce(gmax, op=dist.ReduceOp.MAX, group=group)
    wire = gmax.numel() * gmax.element_size()
    means, efs = [], []
    for i, (g, e) in enumerate(zip(leaves_g, leaves_e)):
        g32 = carry(g, e)
        scale = torch.clamp(gmax[i] / qmax, min=1e-30)
        q = torch.clamp(torch.round(g32 / scale), -qmax, qmax).to(torch.int8)
        efs.append(g32.sub_(q.float() * scale))
        total = q.to(torch.int32)
        del q, g32
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        wire += total.numel() * total.element_size()
        means.append((total.float() * scale) / n)
        del total
    if stats is not None:
        stats["wire_bytes"] = wire
        stats["values"] = sum(g.numel() for g in leaves_g)
    return tree_unflatten(grads, means), tree_unflatten(grads, efs)


def bf16_psum(grads, group=None, *, stats: dict | None = None):
    """Cheaper baseline: the gradients all-reduced in bfloat16 (2 B a value
    on the wire), returned as float32."""
    import torch.distributed as dist

    out, wire = [], 0
    for g in tree_leaves(grads):
        t = g.to(torch.bfloat16, copy=True)
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        wire += t.numel() * t.element_size()
        out.append(t.float())
        del t
    if stats is not None:
        stats["wire_bytes"] = wire
    return tree_unflatten(grads, out)


def neurlz_grad_archive(grads, rel_eb: float = 1e-3, device=None) -> dict:
    """Error-bounded archive of a gradient tree (the paper's pipeline
    applied to gradients): every leaf of 2 or more dimensions and at least
    1024 values, as float32, through ``szlike`` with the Lorenzo predictor
    on ``device`` (``cuda`` unless given); 4-D and up reshaped to
    ``[shape[0], -1]``.  The archives and byte counts equal the JAX
    package's for the same gradients."""
    from ..compressors import szlike

    total_raw, total_comp = 0, 0
    arcs = {}
    for path, g in tree_items(grads):
        key = "/".join(map(str, path))
        a = (g.detach().float().cpu().numpy() if isinstance(g, torch.Tensor)
             else np.asarray(g, dtype=np.float32))
        if a.ndim < 2 or a.size < 1024:
            continue
        arc, _ = szlike.compress(a if a.ndim in (2, 3) else a.reshape(a.shape[0], -1),
                                 rel_eb=rel_eb,
                                 config=szlike.SZLikeConfig(predictor="lorenzo"),
                                 device=device)
        arcs[key] = arc
        total_raw += a.nbytes
        total_comp += arc["nbytes"]
    return {"arcs": arcs, "raw_bytes": total_raw, "comp_bytes": total_comp,
            "ratio": total_raw / max(total_comp, 1)}
