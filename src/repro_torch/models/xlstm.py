"""xLSTM blocks (Beck et al., 2024): chunked mLSTM and recurrent sLSTM, as
the JAX package's ``repro/models/xlstm.py`` computes them.

mLSTM: a matrix-memory cell with exponential input gates and sigmoid
forget gates, evaluated chunkwise like the SSD scan (parallel intra-chunk
scores; a Python loop, the JAX package's ``lax.scan``, carries
``(S [H,K,V], n [H,K], m [H])`` across chunks) with max-stabilised
log-space gating.

sLSTM: a scalar-memory cell with recurrent, block-diagonal (per head) gate
connections; inherently sequential, so a Python loop over time, followed
by a gated FFN with projection factor 4/3.

The cells compute in float32 (float64 in a float64 model).  The
stabilisers start at a float32 ``-1e30``, as the JAX package's do:
``exp(-m)`` and ``exp(f + m - m_new)`` underflow to 0 there, where
``-inf`` would give ``-inf - -inf = NaN``.  Cumulative sums along a chunk
are a product with a lower-triangular matrix of ones (``torch.cumsum`` has
no deterministic CUDA kernel for floating types).  Decode steps write
their caches in place.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .layers import compute_dtype, dense_init, normal, rmsnorm, zeros
from .ssm import _tril_cumsum

M0 = -1e30      # the stabilisers' start (float32)


def _full(shape, value, device, dtype=torch.float32):
    return torch.full(shape, value, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def m_init(gen, cfg, dtype, device, lead: tuple = ()):
    d = cfg.d_model
    du = int(2 * d)                      # up-projection factor 2
    h = cfg.n_heads
    return {
        "w_up_in": dense_init(gen, d, 2 * du, dtype, device, lead=lead),  # [x | z]
        "w_q_in": dense_init(gen, du, du, dtype, device, lead=lead),
        "w_k_in": dense_init(gen, du, du, dtype, device, lead=lead),
        "w_v_in": dense_init(gen, du, du, dtype, device, lead=lead),
        "w_if": dense_init(gen, du, 2 * h, dtype, device, lead=lead),   # i, f gates
        "norm_scale": zeros((du,), dtype, device, lead),
        "w_down_out": dense_init(gen, du, d, dtype, device, lead=lead),
    }


def _m_gates(p, cfg, xu):
    h = cfg.n_heads
    gates = (xu @ p["w_if"]).to(compute_dtype(xu.dtype))
    i_log = gates[..., :h]                                     # pre-activation
    f_log = F.logsigmoid(gates[..., h:])                       # log f ∈ (−∞, 0)
    return i_log, f_log


def _m_qkv(p, xu, shape):
    hd = shape[-1]
    acc = compute_dtype(xu.dtype)
    q = (xu @ p["w_q_in"]).reshape(shape).to(acc) / np.sqrt(hd)
    k = (xu @ p["w_k_in"]).reshape(shape).to(acc)
    v = (xu @ p["w_v_in"]).reshape(shape).to(acc)
    return q, k, v


def m_forward(p, cfg, x, chunk: int = 128):
    """x: [B, L, D] -> [B, L, D]; chunked parallel mLSTM."""
    bsz, L, d = x.shape
    h = cfg.n_heads
    up = x @ p["w_up_in"]
    xu, z = torch.chunk(up, 2, dim=-1)
    du = xu.shape[-1]
    hd = du // h
    chunk = min(chunk, L)
    if L % chunk:
        raise ValueError(f"sequence {L} does not split into chunks of {chunk}")
    nc = L // chunk

    q, k, v = _m_qkv(p, xu, (bsz, L, h, hd))
    i_log, f_log = _m_gates(p, cfg, xu)                        # [B,L,H]

    qc = q.reshape(bsz, nc, chunk, h, hd)
    kc = k.reshape(bsz, nc, chunk, h, hd)
    vc = v.reshape(bsz, nc, chunk, h, hd)
    ic = i_log.reshape(bsz, nc, chunk, h)
    fcum = _tril_cumsum(f_log.reshape(bsz, nc, chunk, h), 2)   # [B,nc,cl,H]
    ftot = fcum[:, :, -1]

    idx = torch.arange(chunk, device=x.device)
    causal = (idx[:, None] >= idx[None, :])[None, :, :, None]
    acc = q.dtype
    S = torch.zeros((bsz, h, hd, hd), dtype=acc, device=x.device)
    nvec = torch.zeros((bsz, h, hd), dtype=acc, device=x.device)
    m = _full((bsz, h), M0, x.device, acc)
    ys = []
    for c in range(nc):
        qk, kk, vk, ik, fck, ftk = (qc[:, c], kc[:, c], vc[:, c], ic[:, c],
                                    fcum[:, c], ftot[:, c])
        # log-weights: inter uses m + fcum_i; intra uses fcum_i − fcum_j + i_j
        inter_log = fck + m[:, None]                           # [B,cl,H]
        intra_log = (fck[:, :, None, :] - fck[:, None, :, :]
                     + ik[:, None, :, :])                      # [B,i,j,H]
        intra_log = torch.where(causal, intra_log, -torch.inf)
        row_max = torch.amax(intra_log, 2)                     # [B,cl,H]
        m_new = torch.maximum(ftk + m, torch.amax(row_max, 1))  # [B,H]
        m_i = torch.maximum(inter_log, row_max)                # per-row stabiliser
        w_inter = torch.exp(inter_log - m_i)                   # [B,cl,H]
        w_intra = torch.exp(intra_log - m_i[:, :, None, :])    # [B,i,j,H]
        y_inter = torch.einsum("blhk,bhkv,blh->blhv", qk, S, w_inter)
        scores = torch.einsum("bihk,bjhk->bijh", qk, kk) * w_intra
        y_intra = torch.einsum("bijh,bjhv->bihv", scores, vk)
        n_inter = torch.einsum("blhk,bhk,blh->blh", qk, nvec, w_inter)
        n_intra = scores.sum(2)
        denom = torch.maximum(torch.abs(n_inter + n_intra), torch.exp(-m_i))
        ys.append((y_inter + y_intra) / denom[..., None])
        # carry update in the new stabiliser frame
        wS = torch.exp(ftk + m - m_new)                        # [B,H]
        wk = torch.exp(ftk[:, None] - fck + ik - m_new[:, None])  # [B,cl,H]
        S = wS[:, :, None, None] * S + torch.einsum("bjhk,bjhv,bjh->bhkv",
                                                    kk, vk, wk)
        nvec = wS[:, :, None] * nvec + torch.einsum("bjhk,bjh->bhk", kk, wk)
        m = m_new
    y = torch.stack(ys, 1).reshape(bsz, L, du).to(x.dtype)
    y = rmsnorm(y, p["norm_scale"], cfg.norm_eps) * F.silu(z)
    return y @ p["w_down_out"]


def m_init_cache(cfg, batch: int, device, lead: tuple = ()):
    h = cfg.n_heads
    hd = int(2 * cfg.d_model) // h
    return {"S": zeros((batch, h, hd, hd), torch.float32, device, lead),
            "n": zeros((batch, h, hd), torch.float32, device, lead),
            "m": _full((*lead, batch, h), M0, device)}


def m_decode_step(p, cfg, x, cache):
    bsz = x.shape[0]
    h = cfg.n_heads
    up = x @ p["w_up_in"]
    xu, z = torch.chunk(up, 2, dim=-1)
    du = xu.shape[-1]
    hd = du // h
    q, k, v = _m_qkv(p, xu[:, 0], (bsz, h, hd))
    i_log, f_log = _m_gates(p, cfg, xu[:, 0:1])
    i_log, f_log = i_log[:, 0], f_log[:, 0]                    # [B,H]
    m_new = torch.maximum(f_log + cache["m"], i_log)
    wS = torch.exp(f_log + cache["m"] - m_new)
    wi = torch.exp(i_log - m_new)
    S = wS[:, :, None, None] * cache["S"] + torch.einsum("bhk,bhv,bh->bhkv",
                                                         k, v, wi)
    nvec = wS[:, :, None] * cache["n"] + k * wi[:, :, None]
    num = torch.einsum("bhk,bhkv->bhv", q, S)
    den = torch.maximum(torch.abs(torch.einsum("bhk,bhk->bh", q, nvec)),
                        torch.exp(-m_new))
    y = (num / den[..., None]).reshape(bsz, 1, du).to(x.dtype)
    y = rmsnorm(y, p["norm_scale"], cfg.norm_eps) * F.silu(z)
    cache["S"].copy_(S)
    cache["n"].copy_(nvec)
    cache["m"].copy_(m_new)
    return y @ p["w_down_out"], cache


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def s_init(gen, cfg, dtype, device, lead: tuple = ()):
    d = cfg.d_model
    h = cfg.n_heads
    hd = d // h
    dff = int(cfg.xlstm_proj_factor * d)
    return {
        "w_gates_in": dense_init(gen, d, 4 * d, dtype, device, lead=lead),  # i,f,z,o
        "r_gates": normal(gen, (*lead, h, hd, 4 * hd), dtype,
                          1.0 / np.sqrt(hd), device),          # recurrent, per head
        "norm_scale": zeros((d,), dtype, device, lead),
        "w_ff_gate_in": dense_init(gen, d, dff, dtype, device, lead=lead),
        "w_ff_up_in": dense_init(gen, d, dff, dtype, device, lead=lead),
        "w_ff_down_out": dense_init(gen, dff, d, dtype, device, lead=lead),
    }


def _s_cell(wxt, r, c, n, m, hprev):
    """One sLSTM step from the input pre-activations ``wxt`` [B,H,4·hd] and
    the float32 recurrent weights ``r`` [H,hd,4·hd]."""
    g = wxt.to(r.dtype) + torch.einsum("bhk,hkg->bhg", hprev, r)
    ig, fg, zg, og = torch.chunk(g, 4, dim=-1)                 # [B,H,hd]
    m_new = torch.maximum(fg + m, ig)
    i = torch.exp(ig - m_new)
    f = torch.exp(fg + m - m_new)
    c = f * c + i * torch.tanh(zg)
    n = f * n + i
    # torch.maximum, not clamp: at a tie (n = 1 at the first step) its
    # gradient splits in half, as jnp.maximum's does.
    hh = torch.sigmoid(og) * c / torch.maximum(n, n.new_ones(()))
    return c, n, m_new, hh


def _s_ffn(p, cfg, y):
    y = rmsnorm(y, p["norm_scale"], cfg.norm_eps)
    g = F.gelu(y @ p["w_ff_gate_in"], approximate="tanh")
    return (g * (y @ p["w_ff_up_in"])) @ p["w_ff_down_out"]


def s_forward(p, cfg, x):
    """Sequential sLSTM over time (exact recurrence), then the gated FFN."""
    bsz, L, d = x.shape
    h = cfg.n_heads
    hd = d // h
    wx = (x @ p["w_gates_in"]).reshape(bsz, L, h, 4 * hd)
    acc = compute_dtype(x.dtype)
    r = p["r_gates"].to(acc)
    c = n = hh = torch.zeros((bsz, h, hd), dtype=acc, device=x.device)
    m = _full((bsz, h, hd), M0, x.device, acc)
    hs = []
    for t in range(L):
        c, n, m, hh = _s_cell(wx[:, t], r, c, n, m, hh)
        hs.append(hh)
    y = torch.stack(hs, 1).reshape(bsz, L, d).to(x.dtype)
    return _s_ffn(p, cfg, y)


def s_init_cache(cfg, batch: int, device, lead: tuple = ()):
    h = cfg.n_heads
    hd = cfg.d_model // h
    shape = (batch, h, hd)
    return {"c": zeros(shape, torch.float32, device, lead),
            "n": zeros(shape, torch.float32, device, lead),
            "m": _full((*lead, *shape), M0, device),
            "h": zeros(shape, torch.float32, device, lead)}


def s_decode_step(p, cfg, x, cache):
    bsz = x.shape[0]
    h = cfg.n_heads
    hd = cfg.d_model // h
    wx = (x[:, 0] @ p["w_gates_in"]).reshape(bsz, h, 4 * hd)
    r = p["r_gates"].to(compute_dtype(x.dtype))
    c, n, m, hh = _s_cell(wx, r, cache["c"], cache["n"], cache["m"], cache["h"])
    out = _s_ffn(p, cfg, hh.reshape(bsz, 1, cfg.d_model).to(x.dtype))
    for k, v in (("c", c), ("n", n), ("m", m), ("h", hh)):
        cache[k].copy_(v)
    return out, cache
