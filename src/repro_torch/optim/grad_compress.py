"""Error-bounded gradient compression with error feedback.

The port of the JAX package's ``repro/optim/grad_compress.py``, on trees of
tensors (nested dicts):

  * ``quantize_ef`` — per-tensor linear quantization of the gradient to
    int8 with an *error-feedback* residual carried to the next step
    (Seide et al.; Karimireddy et al.);
  * ``dequantize`` / ``init_ef``;
  * ``neurlz_grad_archive`` — a host-side error-bounded archive of a
    gradient tree through the port's ``szlike`` with the Lorenzo predictor
    (the ``lorenzo3d_fwd`` kernel on the card), for debugging and replay.

``compressed_psum`` and ``bf16_psum`` (the cross-pod all-reduce) come with
the distributed slice.
"""
from __future__ import annotations

import numpy as np
import torch

from .adamw import tree_items, tree_map


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
