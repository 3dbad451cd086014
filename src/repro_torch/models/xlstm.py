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

The cells compute in float32 (float64 in a float64 model), and their
decode caches hold the same type.  The stabilisers start at a float32
``-1e30``, as the JAX package's do: ``exp(-m)`` and ``exp(f + m - m_new)``
underflow to 0 there, where ``-inf`` would give ``-inf - -inf = NaN``.
Cumulative sums along a chunk are a product with a lower-triangular matrix
of ones (``torch.cumsum`` has no deterministic CUDA kernel for floating
types).  Decode steps write their caches in place.

On DTensors the projections run as they come and the cells on each
device's rows (``distributed.sharding.on_rows``): whole heads on every
device of ``model`` (xlstm-350m's 4 heads do not split 16 ways), and the
sLSTM's step a token on local tensors, not through DTensor's dispatch.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..distributed.sharding import (assign, column_products, gather_fsdp,
                                     grad_like, on_rows, whole_rows)
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


def _m_gates(cfg, gates):
    """Input and forget log-gates [..., H] from the pre-activations
    [..., 2H], in the cell's float type."""
    h = cfg.n_heads
    gates = gates.to(compute_dtype(gates.dtype))
    i_log = gates[..., :h]                                     # pre-activation
    f_log = F.logsigmoid(gates[..., h:])                       # log f ∈ (−∞, 0)
    return i_log, f_log


def _m_heads(t, shape):
    """A projection ``[..., H·hd]`` as float32 (float64) heads ``shape``."""
    return t.reshape(shape).to(compute_dtype(t.dtype))


def m_forward(p, cfg, x, chunk: int = 128):
    """x: [B, L, D] -> [B, L, D]; chunked parallel mLSTM.  The projections
    run on DTensors as they come; the cell runs on each device's rows
    (:func:`sharding.on_rows`), whole heads on every device of ``model``:
    xlstm-350m's 4 heads do not split 16 ways."""
    bsz, L = x.shape[:2]
    up = whole_rows(x) @ gather_fsdp(p["w_up_in"])
    xu, z = torch.chunk(up, 2, dim=-1)
    chunk = min(chunk, L)
    if L % chunk:
        raise ValueError(f"sequence {L} does not split into chunks of {chunk}")
    # On DTensors the gradient of ``xu`` (the four products' partial sums,
    # added first) and of ``z`` come back placed as the rows.
    projs = column_products(xu.reshape(bsz * L, -1), [
        gather_fsdp(p[k]) for k in ("w_q_in", "w_k_in", "w_v_in", "w_if")])
    y = on_rows(lambda *a: _m_cell(cfg, chunk, *a),
                tuple(t.reshape(bsz, L, -1) for t in projs))
    z = grad_like(z)
    y = y.to(x.dtype)
    y = rmsnorm(y, p["norm_scale"], cfg.norm_eps) * F.silu(z)
    return y @ gather_fsdp(p["w_down_out"])


def _m_cell(cfg, chunk, q, k, v, gates):
    """The chunked mLSTM of one device's rows: projections ``q, k, v``
    [B, L, du] and gate pre-activations [B, L, 2H] -> [B, L, du] in the
    cell's float type."""
    bsz, L, du = q.shape
    h = cfg.n_heads
    hd = du // h
    nc = L // chunk
    q = _m_heads(q, (bsz, L, h, hd)) / np.sqrt(hd)
    k = _m_heads(k, (bsz, L, h, hd))
    v = _m_heads(v, (bsz, L, h, hd))
    i_log, f_log = _m_gates(cfg, gates)                        # [B,L,H]

    qc = q.reshape(bsz, nc, chunk, h, hd)
    kc = k.reshape(bsz, nc, chunk, h, hd)
    vc = v.reshape(bsz, nc, chunk, h, hd)
    ic = i_log.reshape(bsz, nc, chunk, h)
    fcum = _tril_cumsum(f_log.reshape(bsz, nc, chunk, h), 2)   # [B,nc,cl,H]
    ftot = fcum[:, :, -1]

    idx = torch.arange(chunk, device=q.device)
    causal = (idx[:, None] >= idx[None, :])[None, :, :, None]
    acc = q.dtype
    S = torch.zeros((bsz, h, hd, hd), dtype=acc, device=q.device)
    nvec = torch.zeros((bsz, h, hd), dtype=acc, device=q.device)
    m = _full((bsz, h), M0, q.device, acc)
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
    return torch.stack(ys, 1).reshape(bsz, L, du)


def m_init_cache(cfg, batch: int, device, lead: tuple = ()):
    h = cfg.n_heads
    hd = int(2 * cfg.d_model) // h
    acc = compute_dtype(cfg.params_dtype)
    return {"S": zeros((batch, h, hd, hd), acc, device, lead),
            "n": zeros((batch, h, hd), acc, device, lead),
            "m": _full((*lead, batch, h), M0, device, acc)}


def m_decode_step(p, cfg, x, cache):
    up = x @ gather_fsdp(p["w_up_in"])
    xu, z = torch.chunk(up, 2, dim=-1)
    du = xu.shape[-1]
    xu0 = xu[:, 0]
    y, S, nvec, m_new = on_rows(
        lambda *a: _m_step(cfg, *a),
        (*(xu0 @ gather_fsdp(p[k]) for k in ("w_q_in", "w_k_in", "w_v_in")),
         xu[:, 0:1] @ gather_fsdp(p["w_if"]), cache["S"], cache["n"], cache["m"]))
    y = y.reshape(x.shape[0], 1, du).to(x.dtype)
    y = rmsnorm(y, p["norm_scale"], cfg.norm_eps) * F.silu(z)
    assign(cache["S"], S)
    assign(cache["n"], nvec)
    assign(cache["m"], m_new)
    return y @ gather_fsdp(p["w_down_out"]), cache


def _m_step(cfg, q, k, v, gates, S, nvec, m):
    """One mLSTM step of one device's rows: projections [B, du], gate
    pre-activations [B, 1, 2H] and the carried ``S, n, m`` -> ``(y [B, H,
    hd], S, n, m)``."""
    bsz, du = q.shape
    h = cfg.n_heads
    hd = du // h
    q = _m_heads(q, (bsz, h, hd)) / np.sqrt(hd)
    k = _m_heads(k, (bsz, h, hd))
    v = _m_heads(v, (bsz, h, hd))
    i_log, f_log = _m_gates(cfg, gates)
    i_log, f_log = i_log[:, 0], f_log[:, 0]                    # [B,H]
    m_new = torch.maximum(f_log + m, i_log)
    wS = torch.exp(f_log + m - m_new)
    wi = torch.exp(i_log - m_new)
    S = wS[:, :, None, None] * S + torch.einsum("bhk,bhv,bh->bhkv", k, v, wi)
    nvec = wS[:, :, None] * nvec + k * wi[:, :, None]
    num = torch.einsum("bhk,bhkv->bhv", q, S)
    den = torch.maximum(torch.abs(torch.einsum("bhk,bhk->bh", q, nvec)),
                        torch.exp(-m_new))
    return num / den[..., None], S, nvec, m_new


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


_FFN_WEIGHTS = ("norm_scale", "w_ff_gate_in", "w_ff_up_in", "w_ff_down_out")


def _s_ffn(cfg, y, norm_scale, w_gate, w_up, w_down):
    y = rmsnorm(y, norm_scale, cfg.norm_eps)
    g = F.gelu(y @ w_gate, approximate="tanh")
    return (g * (y @ w_up)) @ w_down


def s_forward(p, cfg, x):
    """Sequential sLSTM over time (exact recurrence), then the gated FFN,
    both on each device's rows (:func:`sharding.on_rows`): the recurrence
    is one step a token, which on DTensors runs on local tensors, not
    through DTensor's dispatch at every step, and the FFN's width (4/3 of
    d_model) splits over no ``model`` axis, so its weights are replicated
    there anyway."""
    def run(wx, r, *w):
        return _s_ffn(cfg, _s_scan(cfg, wx, r).to(wx.dtype), *w)

    return on_rows(run, (whole_rows(x) @ gather_fsdp(p["w_gates_in"]),),
                   (p["r_gates"], *(p[k] for k in _FFN_WEIGHTS)))


def _s_scan(cfg, wx, r):
    """The sLSTM recurrence of one device's rows: input pre-activations
    ``wx`` [B, L, 4d] and recurrent weights ``r`` -> ``h`` [B, L, d] in the
    cell's float type."""
    bsz, L, d4 = wx.shape
    h = cfg.n_heads
    hd = d4 // (4 * h)
    wx = wx.reshape(bsz, L, h, 4 * hd)
    acc = compute_dtype(wx.dtype)
    r = r.to(acc)
    c = n = hh = torch.zeros((bsz, h, hd), dtype=acc, device=wx.device)
    m = _full((bsz, h, hd), M0, wx.device, acc)
    hs = []
    for t in range(L):
        c, n, m, hh = _s_cell(wx[:, t], r, c, n, m, hh)
        hs.append(hh)
    return torch.stack(hs, 1).reshape(bsz, L, h * hd)


def s_init_cache(cfg, batch: int, device, lead: tuple = ()):
    h = cfg.n_heads
    hd = cfg.d_model // h
    shape = (batch, h, hd)
    acc = compute_dtype(cfg.params_dtype)
    return {"c": zeros(shape, acc, device, lead),
            "n": zeros(shape, acc, device, lead),
            "m": _full((*lead, *shape), M0, device, acc),
            "h": zeros(shape, acc, device, lead)}


def s_decode_step(p, cfg, x, cache):
    h = cfg.n_heads
    hd = cfg.d_model // h

    def step(wx, c, n, m, hh, r, *w):
        bsz = wx.shape[0]
        c, n, m, hh = _s_cell(wx.reshape(bsz, h, 4 * hd),
                              r.to(compute_dtype(wx.dtype)), c, n, m, hh)
        out = _s_ffn(cfg, hh.reshape(bsz, 1, cfg.d_model).to(wx.dtype), *w)
        return out, c, n, m, hh

    out, c, n, m, hh = on_rows(
        step, (x[:, 0] @ gather_fsdp(p["w_gates_in"]), cache["c"], cache["n"],
               cache["m"], cache["h"]),
        (p["r_gates"], *(p[k] for k in _FFN_WEIGHTS)))
    for k, v in (("c", c), ("n", n), ("m", m), ("h", hh)):
        assign(cache[k], v)
    return out, cache
