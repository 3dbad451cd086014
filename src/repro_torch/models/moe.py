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
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..distributed.sharding import (ContiguousGrad, gather_fsdp, join, local_of,
                                     pinned, placed_as, whole_rows)
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


def _choose(probs, cfg, g_sz: int):
    """Top-k of the router's probabilities ``[G, S, Epad]``: the
    renormalised weights ``topv`` and experts ``topi`` [G, S, K], each
    choice's slot ``pos`` in its expert's queue (int64, not clamped) and
    ``keep = pos < cap``."""
    g = probs.shape[0]
    e_pad = probs.shape[-1]
    topv, topi = torch.topk(probs, cfg.top_k, dim=-1)             # [G, S, K]
    topv = topv / (topv.sum(-1, keepdim=True) + 1e-9)            # renormalize
    # Slot of each (token, k) in its expert's queue: a running count over
    # the flattened (S*K) order.  Integer cumsum: exact, and deterministic
    # on CUDA (a floating-point cumsum raises there in deterministic mode).
    flat = topi.reshape(g, g_sz * cfg.top_k)
    onehot = _one_hot(flat, e_pad)                               # [G, S*K, E]
    before = torch.cumsum(onehot, dim=1) - onehot
    pos = before.gather(2, flat[..., None])[..., 0].reshape(topi.shape)
    return topv, topi, pos, pos < capacity(cfg, g_sz)


def route(p, cfg, xt):
    """Router of one call.  xt: [G, S, D].

    Returns ``probs`` [G, S, Epad] (float32) and :func:`_choose`'s
    ``topv, topi, pos, keep``.

    Ties: ``torch.topk`` does not promise the JAX package's low-index-first
    order among equal values.  A padded expert has probability 0 against a
    real expert's exp(logit − max) > 0, which underflows only for a logit
    ~100 nats below the maximum, so padded experts never tie into the top
    k; ties between real experts need equal float32 probabilities.
    """
    e_pad = p["router_in"].shape[-1]
    logits = xt.float() @ p["router_in"]                         # [G, S, Epad]
    if e_pad > cfg.n_experts:
        pad = torch.arange(e_pad, device=xt.device) >= cfg.n_experts
        logits = torch.where(pad[None, None], -1e30, logits)
    probs = torch.softmax(logits, dim=-1)
    return (probs, *_choose(probs, cfg, xt.shape[1]))


def _experts(cfg, xt, topv, topi, pos, keep, wg, wu, wd):
    """The routed experts' output ``[G, S, D]`` of tokens ``xt [G, S, D]``
    through experts ``wg``, ``wu`` [E, D, F], ``wd`` [E, F, D]: each choice
    ``topi`` indexes them, and a choice that is not ``keep`` counts 0.

    Dispatch: each kept (token, k) into slot e·cap + pos of its group's
    [E·C, D] buffer, where it is the only token; the other choices go to a
    spare last slot that is thrown away.  No host sync: the path stays
    asynchronous on CUDA."""
    g, g_sz, d = xt.shape
    k = cfg.top_k
    n_exp = wg.shape[0]
    cap = capacity(cfg, g_sz)
    spare = n_exp * cap
    dest = torch.where(keep, topi * cap + pos, spare)            # [G, S, K]
    gi = torch.arange(g, device=xt.device).view(g, 1, 1).expand_as(dest)
    xe = torch.zeros((g, spare + 1, d), dtype=xt.dtype, device=xt.device)
    xe[gi, dest] = xt[:, :, None, :].expand(g, g_sz, k, d)
    xe = xe[:, :spare].reshape(g, n_exp, cap, d).transpose(0, 1)
    xe = xe.reshape(n_exp, g * cap, d)

    act = activation(cfg.act)
    h = act(torch.bmm(xe, wg))
    h = h * torch.bmm(xe, wu)
    ye = torch.bmm(h, wd)                                        # [E, G*C, D]
    ye = ye.reshape(n_exp, g, cap, d).transpose(0, 1).reshape(g, n_exp * cap, d)

    # Combine: gather each choice's expert output, weight it (0 if dropped).
    slot = topi * cap + torch.clamp(pos, max=cap - 1)            # [G, S, K]
    w = (topv * keep).to(xt.dtype)
    picked = ye.gather(1, slot.reshape(g, g_sz * k, 1).expand(-1, -1, d))
    return (picked.reshape(g, g_sz, k, d) * w[..., None]).sum(2)


def forward(p, cfg, x, *, model_axis: int = 16):
    """x: [B, S, D] -> ([B, S, D], aux).  ``aux`` is the Switch
    load-balance loss.  A DTensor ``x`` runs expert-parallel
    (:func:`_forward_sharded`)."""
    if isinstance(x, DTensor):
        return _forward_sharded(p, cfg, x)
    b, s, d = x.shape
    e_pad = p["router_in"].shape[-1]
    g_sz = min(cfg.moe_group_size, s)
    if (b * s) % g_sz:
        raise ValueError(f"{b}x{s} tokens do not split into groups of {g_sz}")
    g = (b * s) // g_sz
    xt = x.reshape(g, g_sz, d)
    probs, topv, topi, pos, keep = route(p, cfg, xt)
    y = _experts(cfg, xt, topv, topi, pos, keep, p["w_experts_gate"],
                 p["w_experts_up"], p["w_experts_down"])
    out = y.reshape(b, s, d)

    if cfg.n_shared_experts:
        out = out + mlp_mod.forward(p["shared"], x, cfg.act)

    # Switch-style load-balance aux loss.
    me = probs.mean(dim=(0, 1))
    fe = _one_hot(topi, e_pad).sum(2).float().mean(dim=(0, 1))
    aux = cfg.n_experts * torch.sum(me * fe)
    return out, aux


def _forward_sharded(p, cfg, x):
    """:func:`forward` on DTensors, expert-parallel.

    The experts are split over ``model`` (``w_experts_*``), the tokens over
    the batch axes and replicated over ``model``.  The router runs on
    DTensors (its weight replicated, [d, Epad] is small), so every device
    has every probability of its rows.  Then each device, on its local
    tensors, routes its groups, keeps the choices that land in its own
    experts, runs those experts' FFNs on FSDP-gathered weights and returns
    its part of the output: partial over ``model``, summed where it joins
    the residual stream.  The aux loss is the Switch loss over all experts
    (each device's means over its rows, reduced).  Every gradient that
    crosses between DTensors and local tensors is placed explicitly
    (``local_of``, ``placed_as``, ``pinned``), so the backward's
    collectives are the same on every torch version.

    The counted products are the capacity slots of the device's experts
    (filled or not) through their FFNs.  The JAX package dispatches and
    combines with dense one-hot einsums over every (token, expert, slot),
    so XLA's count is higher; the port's is not padded to match."""
    mesh = x.device_mesh
    names = list(mesh.mesh_dim_names)
    mi = names.index("model") if "model" in names else None
    x = whole_rows(x)
    rows = x.placements
    s, d = x.shape[1:]
    e_pad = p["router_in"].shape[-1]
    g_sz = min(cfg.moe_group_size, s)

    router = p["router_in"].redistribute(mesh, [Replicate()] * mesh.ndim)
    logits = x.float() @ router                                  # [B, S, Epad]
    if e_pad > cfg.n_experts:
        pad = join(torch.arange(e_pad, device=x.device) >= cfg.n_experts, logits)
        logits = torch.where(pad, -1e30, logits)
    probs = torch.softmax(logits, dim=-1)

    ws = [gather_fsdp(p[k]) for k in ("w_experts_gate", "w_experts_up",
                                      "w_experts_down")]
    ep = mi is not None and ws[0].placements[mi] == Shard(0)
    # Each device's output, and so the gradient of its inputs, is its
    # experts' part: partial over ``model``.
    part = [Partial() if i == mi and ep else pl for i, pl in enumerate(rows)]

    def local_w(w):
        return ContiguousGrad.apply(w.to_local(grad_placements=[
            pl if i == mi else Partial() if rows[i] == Shard(0) else Replicate()
            for i, pl in enumerate(w.placements)]))
    wl = [local_w(w) for w in ws]
    # The shared experts, split over ``model`` as the dense MLP is (column,
    # then row parallel), run on the local shards too: their output is
    # partial over ``model`` like the experts', and ``x``'s gradient is
    # reduced once for both.
    shared = {k: gather_fsdp(w) for k, w in p.get("shared", {}).items()}
    if shared and ep != (mi is not None and all(
            w.placements[mi] != Replicate() for w in shared.values())):
        raise NotImplementedError("shared experts split over model unlike "
                                  "the routed experts")
    # Their gradients are reduced over ``model`` here, each into the rows'
    # placement: one all-reduce each, on every torch version alike.
    xl = local_of(x, part)
    prl = local_of(probs, part)
    bl = xl.shape[0]
    if (bl * s) % g_sz:
        raise ValueError(f"a device's {bl}x{s} tokens do not split into "
                         f"groups of {g_sz}")
    g = (bl * s) // g_sz
    topv, topi, pos, keep = _choose(prl.reshape(g, g_sz, e_pad), cfg, g_sz)
    # This device's experts are first .. first + n_exp: the choices of
    # other experts are not kept here.
    n_exp = wl[0].shape[0]
    first = mesh.get_coordinate()[mi] * n_exp if ep else 0
    local = topi - first
    mine = keep & (local >= 0) & (local < n_exp)
    y = _experts(cfg, xl.reshape(g, g_sz, d), topv,
                 torch.clamp(local, 0, n_exp - 1), pos, mine, *wl)
    y = y.reshape(bl, s, d)
    if shared:
        y = y + mlp_mod.forward({k: local_w(w) for k, w in shared.items()},
                                xl, cfg.act)
    out = placed_as(y, mesh, part, rows)

    # The Switch loss: each device's means over its rows (every device of
    # ``model`` computes the same), partial over the axes that split the
    # rows, reduced here; their gradients come back whole to each device.
    n_tok = x.shape[0] * s
    red = [Partial() if pl == Shard(0) else Replicate() for pl in rows]
    rep = [Replicate()] * mesh.ndim
    me = placed_as(local_of(probs, rows).sum(dim=(0, 1)) / n_tok, mesh, red, rep)
    fe = DTensor.from_local(_one_hot(topi, e_pad).sum(dim=(0, 1, 2)).float() / n_tok,
                            mesh, red, run_check=False)
    aux = cfg.n_experts * torch.sum(pinned(me, rep, rep) * fe.redistribute(mesh, rep))
    return out, aux
