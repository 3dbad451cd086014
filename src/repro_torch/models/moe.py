"""Mixture-of-Experts with GShard routing: groups, top-k, capacity slots.

Tokens are routed in groups of ``moe_group_size``; each (token, k) choice
takes the next free slot of its expert's queue, counted over the group's
flattened (S·K) order, and is dropped once the expert holds ``cap``
tokens.  The JAX package dispatches and combines with one-hot einsums
([G, S, E, C] tensors, which shard into all-to-alls); the port scatters the
kept tokens into their slots and gathers the expert outputs back, which
keeps the same tokens in the same slots and the same sums of one product
each.  The expert FFNs are batched matmuls over the expert axis.

Supports fine-grained MoE (DeepSeekMoE: small ``d_ff_expert``, many
experts, shared experts always on) and top-k with capacity dropping;
``padded_experts`` extends the expert axis to a multiple of the mesh axis
with never-routed experts (router logits −1e30).
"""
from __future__ import annotations

import numpy as np
import torch

from . import mlp as mlp_mod
from .layers import activation, dense_init, normal


def padded_experts(n_experts: int, model_axis: int) -> int:
    return int(np.ceil(n_experts / model_axis) * model_axis)


def init(gen, cfg, dtype, device, model_axis: int = 16, lead: tuple = ()):
    e_pad = padded_experts(cfg.n_experts, model_axis)
    d, f = cfg.d_model, cfg.d_ff_expert
    s = 1.0 / np.sqrt(d)
    p = {
        "router_in": dense_init(gen, d, e_pad, torch.float32, device, lead=lead),
        "w_experts_gate": normal(gen, (*lead, e_pad, d, f), dtype, s, device),
        "w_experts_up": normal(gen, (*lead, e_pad, d, f), dtype, s, device),
        "w_experts_down": normal(gen, (*lead, e_pad, f, d), dtype,
                                 1.0 / np.sqrt(f), device),
    }
    if cfg.n_shared_experts:
        p["shared"] = mlp_mod.init(gen, d, cfg.n_shared_experts * f, dtype,
                                   device, lead=lead)
    return p


def _one_hot(idx, n: int):
    """int64 one-hot by comparison: no host sync on CUDA."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).long()


def capacity(cfg, g_sz: int) -> int:
    return max(int(g_sz * cfg.top_k * cfg.capacity_factor / cfg.n_experts),
               cfg.top_k)


def route(p, cfg, xt):
    """Router of one call.  xt: [G, S, D].

    Returns ``probs`` [G, S, Epad] (float32), the renormalised top-k
    weights ``topv`` and experts ``topi`` [G, S, K], each choice's slot
    ``pos`` in its expert's queue (int64, not clamped) and ``keep =
    pos < cap``.

    Ties: ``torch.topk`` does not promise the JAX package's low-index-first
    order among equal values.  A padded expert has probability 0 against a
    real expert's exp(logit − max) > 0, which underflows only for a logit
    ~100 nats below the maximum, so padded experts never tie into the top
    k; ties between real experts need equal float32 probabilities.
    """
    g, g_sz, _ = xt.shape
    e_pad = p["router_in"].shape[-1]
    logits = xt.float() @ p["router_in"]                         # [G, S, Epad]
    if e_pad > cfg.n_experts:
        pad = torch.arange(e_pad, device=xt.device) >= cfg.n_experts
        logits = torch.where(pad[None, None], -1e30, logits)
    probs = torch.softmax(logits, dim=-1)
    topv, topi = torch.topk(probs, cfg.top_k, dim=-1)             # [G, S, K]
    topv = topv / (topv.sum(-1, keepdim=True) + 1e-9)            # renormalize
    # Slot of each (token, k) in its expert's queue: a running count over
    # the flattened (S*K) order.  Integer cumsum: exact, and deterministic
    # on CUDA (a floating-point cumsum raises there in deterministic mode).
    flat = topi.reshape(g, g_sz * cfg.top_k)
    onehot = _one_hot(flat, e_pad)                               # [G, S*K, E]
    before = torch.cumsum(onehot, dim=1) - onehot
    pos = before.gather(2, flat[..., None])[..., 0].reshape(topi.shape)
    return probs, topv, topi, pos, pos < capacity(cfg, g_sz)


def forward(p, cfg, x, *, model_axis: int = 16):
    """x: [B, S, D] -> ([B, S, D], aux).  ``aux`` is the Switch
    load-balance loss."""
    b, s, d = x.shape
    e_pad = p["router_in"].shape[-1]
    g_sz = min(cfg.moe_group_size, s)
    if (b * s) % g_sz:
        raise ValueError(f"{b}x{s} tokens do not split into groups of {g_sz}")
    g = (b * s) // g_sz
    k = cfg.top_k
    xt = x.reshape(g, g_sz, d)
    probs, topv, topi, pos, keep = route(p, cfg, xt)
    cap = capacity(cfg, g_sz)

    # Dispatch: each kept (token, k) into slot e·cap + pos of its group's
    # [E·C, D] buffer, where it is the only token; dropped choices go to a
    # spare last slot that is thrown away.  No host sync: the path stays
    # asynchronous on CUDA.
    spare = e_pad * cap
    dest = torch.where(keep, topi * cap + pos, spare)            # [G, S, K]
    gi = torch.arange(g, device=x.device).view(g, 1, 1).expand_as(dest)
    xe = torch.zeros((g, spare + 1, d), dtype=x.dtype, device=x.device)
    xe[gi, dest] = xt[:, :, None, :].expand(g, g_sz, k, d)
    xe = xe[:, :spare].reshape(g, e_pad, cap, d).transpose(0, 1)
    xe = xe.reshape(e_pad, g * cap, d)

    act = activation(cfg.act)
    h = act(torch.bmm(xe, p["w_experts_gate"]))
    h = h * torch.bmm(xe, p["w_experts_up"])
    ye = torch.bmm(h, p["w_experts_down"])                       # [E, G*C, D]
    ye = ye.reshape(e_pad, g, cap, d).transpose(0, 1).reshape(g, e_pad * cap, d)

    # Combine: gather each choice's expert output, weight it (0 if dropped).
    slot = topi * cap + torch.clamp(pos, max=cap - 1)            # [G, S, K]
    w = (topv * keep).to(x.dtype)
    picked = ye.gather(1, slot.reshape(g, g_sz * k, 1).expand(-1, -1, d))
    y = (picked.reshape(g, g_sz, k, d) * w[..., None]).sum(2)
    out = y.reshape(b, s, d)

    if cfg.n_shared_experts:
        out = out + mlp_mod.forward(p["shared"], x, cfg.act)

    # Switch-style load-balance aux loss.
    me = probs.mean(dim=(0, 1))
    fe = _one_hot(topi, e_pad).sum(2).float().mean(dim=(0, 1))
    aux = cfg.n_experts * torch.sum(me * fe)
    return out, aux
