"""Mamba2 (SSD) block: the chunked parallel scan of the selective
state-space recurrence

    h_t = exp(Δ_t A) h_{t-1} + Δ_t B_t x_t,      y_t = C_t h_t + D x_t

evaluated chunkwise (Dao & Gu, 2024), as the JAX package's
``repro/models/ssm.py`` does: within a chunk the output is a masked,
attention-like score matrix; across chunks a Python loop carries the
``[B, H, N, P]`` float32 state (the JAX package's ``lax.scan``).  Decode is
the O(1)-state recurrence, its cache written in place.

Two departures, each equal to the reference wherever the reference is
finite:

* the intra-chunk decay ``exp(cum_i − cum_j)`` is masked *before* the
  exponential.  The reference takes ``exp`` of the whole square and masks
  after (``ssm.py:106-109``); above the diagonal the gap is ≥ 0, and once a
  chunk's summed ``softplus(dt)·exp(A_log)`` passes ~88.7 it overflows in
  float32.  Its forward is unharmed, but its gradient through the mask is
  ``0 · inf = NaN``.
* the cumulative sums along a chunk are a product with a lower-triangular
  matrix of ones, not ``torch.cumsum``, which has no deterministic CUDA
  kernel for floating types.

``A_log``, ``D`` and ``dt_bias`` are float32 leaves whatever the model's
dtype; the scan computes in float32 (float64 in a float64 model).

On DTensors the in- and out-projections run as DTensor products; the
mixer between them runs on each device's rows
(``distributed.sharding.on_rows``), the projection gathered over
``model`` first, since ``w_in``'s output splits into z, x, B, C and dt at
points that are not shard boundaries.  So every device of ``model``
computes the whole mixer of its rows; the caches keep the rules'
placements, each device writing its shard.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..distributed.sharding import assign, gather_fsdp, on_rows, whole_rows
from .layers import compute_dtype, dense_init, normal, rmsnorm, zeros


def d_inner(cfg) -> int:
    return cfg.ssm_expand * cfg.d_model


def n_ssm_heads(cfg) -> int:
    return d_inner(cfg) // cfg.ssm_headdim


def init(gen, cfg, dtype, device, lead: tuple = ()):
    d = cfg.d_model
    di = d_inner(cfg)
    n = cfg.ssm_state
    h = n_ssm_heads(cfg)
    k = cfg.ssm_conv
    conv_ch = di + 2 * n
    f32 = torch.float32
    return {
        # order: [z (gate) | x | B | C | dt]
        "w_in": dense_init(gen, d, 2 * di + 2 * n + h, dtype, device, lead=lead),
        "conv_w": normal(gen, (*lead, k, conv_ch), dtype, 1.0 / np.sqrt(k), device),
        "conv_b": zeros((conv_ch,), dtype, device, lead),
        "A_log": zeros((h,), f32, device, lead),        # A = -exp(A_log) < 0
        "D": torch.ones((*lead, h), dtype=f32, device=device),
        "dt_bias": zeros((h,), f32, device, lead),
        "norm_scale": zeros((di,), dtype, device, lead),
        "w_out": dense_init(gen, di, d, dtype, device, lead=lead),
    }


def _split_proj(cfg, zxbcdt):
    di = d_inner(cfg)
    n = cfg.ssm_state
    return torch.split(zxbcdt, [di, di, n, n, n_ssm_heads(cfg)], dim=-1)


def _causal_conv(u, w, b):
    """u: [B, L, C]; w: [K, C] depthwise causal conv."""
    k = w.shape[0]
    pad = F.pad(u, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + u.shape[1]] * w[i][None, None] for i in range(k))
    return F.silu(out + b[None, None])


def _tril_cumsum(x, dim: int):
    """Inclusive cumulative sum of ``x`` along ``dim`` as a product with a
    lower-triangular matrix of ones (deterministic on CUDA)."""
    n = x.shape[dim]
    tri = torch.tril(torch.ones((n, n), dtype=x.dtype, device=x.device))
    return torch.movedim(torch.matmul(tri, torch.movedim(x, dim, -2)), -2, dim)


_MIXER_WEIGHTS = ("conv_w", "conv_b", "A_log", "D", "dt_bias", "norm_scale")


def forward(p, cfg, x, chunk: int = 128):
    """x: [B, L, D] -> [B, L, D].  The two projections run on DTensors as
    they come (a sequence split over ``model`` gathered first: the scan
    runs along it); the mixer between them (the split of ``w_in``'s
    output, the causal conv, the scan, the gated norm) runs on each
    device's rows (:func:`sharding.on_rows`), the projection gathered over
    ``model`` first: its split points are not shard boundaries."""
    L = x.shape[1]
    chunk = min(chunk, L)
    if L % chunk:
        raise ValueError(f"sequence {L} does not split into chunks of {chunk}")
    zxbcdt = whole_rows(x) @ gather_fsdp(p["w_in"])
    y = on_rows(lambda zx, *w: _mixer(cfg, chunk, zx, *w), (zxbcdt,),
                tuple(p[k] for k in _MIXER_WEIGHTS))
    return y @ gather_fsdp(p["w_out"])


def _mixer(cfg, chunk, zxbcdt, conv_w, conv_b, a_log, d_skip, dt_bias,
           norm_scale):
    """One device's rows: the projection ``[B, L, 2di + 2n + H]`` -> the
    gated, normed SSD output ``[B, L, di]`` in the projection's dtype."""
    bsz, L, _ = zxbcdt.shape
    di, n, h, pdim = d_inner(cfg), cfg.ssm_state, n_ssm_heads(cfg), cfg.ssm_headdim
    nc = L // chunk

    z, xs, bmat, cmat, dt = _split_proj(cfg, zxbcdt)
    xbc = _causal_conv(torch.cat([xs, bmat, cmat], -1), conv_w, conv_b)
    xs, bmat, cmat = torch.split(xbc, [di, n, n], dim=-1)

    f32 = compute_dtype(zxbcdt.dtype)
    xh = xs.reshape(bsz, L, h, pdim).to(f32)
    dt = F.softplus(dt.to(f32) + dt_bias)                               # [B,L,H]
    a = -torch.exp(a_log)                                               # [H]
    loga = dt * a[None, None]                                           # ≤ 0

    # chunked views
    xc = xh.reshape(bsz, nc, chunk, h, pdim)
    dtc = dt.reshape(bsz, nc, chunk, h)
    bc = bmat.to(f32).reshape(bsz, nc, chunk, n)
    cc = cmat.to(f32).reshape(bsz, nc, chunk, n)
    cum = _tril_cumsum(loga.reshape(bsz, nc, chunk, h), 2)             # [B,nc,cl,H]
    total = cum[:, :, -1]                                               # [B,nc,H]

    idx = torch.arange(chunk, device=zxbcdt.device)
    causal = (idx[:, None] >= idx[None, :])[None, :, :, None]           # [1,i,j,1]
    state = torch.zeros((bsz, h, n, pdim), dtype=f32, device=zxbcdt.device)
    ys = []
    for c in range(nc):
        xck, dtk, cumk, totk = xc[:, c], dtc[:, c], cum[:, c], total[:, c]
        bk, ck = bc[:, c], cc[:, c]
        # inter-chunk: y_i += C_i · (exp(cum_i) * state_in)
        y_inter = torch.einsum("bln,bhnp,blh->blhp", ck, state, torch.exp(cumk))
        # intra-chunk: scores[i,j] = (C_i·B_j) exp(cum_i − cum_j) dt_j, j ≤ i
        cb = torch.einsum("bin,bjn->bij", ck, bk)                       # [B,cl,cl]
        gap = cumk[:, :, None, :] - cumk[:, None, :, :]                 # [B,i,j,H]
        w = torch.exp(torch.where(causal, gap, -torch.inf)) * cb[..., None]
        y_intra = torch.einsum("bijh,bjh,bjhp->bihp", w, dtk, xck)
        # state update: S' = exp(total) S + Σ_j exp(total − cum_j) dt_j B_j ⊗ x_j
        wstate = torch.exp(totk[:, None] - cumk) * dtk                  # [B,cl,H]
        s_new = torch.einsum("bjn,bjh,bjhp->bhnp", bk, wstate, xck)
        state = torch.exp(totk)[:, :, None, None] * state + s_new
        ys.append(y_inter + y_intra)
    y = torch.stack(ys, 1).reshape(bsz, L, h, pdim)
    y = y + d_skip[None, None, :, None] * xh
    y = y.reshape(bsz, L, di).to(zxbcdt.dtype)
    return rmsnorm(y * F.silu(z), norm_scale, cfg.norm_eps)


def init_cache(cfg, batch: int, dtype, device, lead: tuple = ()):
    di, n, h = d_inner(cfg), cfg.ssm_state, n_ssm_heads(cfg)
    return {
        "state": zeros((batch, h, n, cfg.ssm_headdim), torch.float32, device, lead),
        "conv": zeros((batch, cfg.ssm_conv - 1, di + 2 * n), dtype, device, lead),
    }


def decode_step(p, cfg, x, cache):
    """x: [B,1,D] -> ([B,1,D], cache): the O(1)-state step, the cache
    written in place (on DTensors, on each device's rows as
    :func:`forward`'s mixer, each cache shard written from them)."""
    y, state, conv = on_rows(
        lambda zx, st, cv, *w: _mixer_step(cfg, zx, st, cv, *w),
        (x @ gather_fsdp(p["w_in"]), cache["state"], cache["conv"]),
        tuple(p[k] for k in _MIXER_WEIGHTS))
    assign(cache["state"], state)
    assign(cache["conv"], conv)
    return y @ gather_fsdp(p["w_out"]), cache


def _mixer_step(cfg, zxbcdt, state, conv, conv_w, conv_b, a_log, d_skip,
                dt_bias, norm_scale):
    """One token of one device's rows: ``(y [B, 1, di], state, conv)``."""
    bsz = zxbcdt.shape[0]
    di, n, h, pdim = d_inner(cfg), cfg.ssm_state, n_ssm_heads(cfg), cfg.ssm_headdim
    f32 = compute_dtype(zxbcdt.dtype)
    z, xs, bmat, cmat, dt = _split_proj(cfg, zxbcdt)
    xbc = torch.cat([xs, bmat, cmat], -1)                               # [B,1,C]
    hist = torch.cat([conv, xbc], dim=1)                                # [B,K,C]
    conv_out = F.silu((hist * conv_w[None]).sum(1) + conv_b)
    xs, bmat, cmat = torch.split(conv_out, [di, n, n], dim=-1)

    xh = xs.reshape(bsz, h, pdim).to(f32)
    dt1 = F.softplus(dt[:, 0].to(f32) + dt_bias)                        # [B,H]
    a = -torch.exp(a_log)
    decay = torch.exp(dt1 * a[None])                                    # [B,H]
    s = state * decay[:, :, None, None]
    s = s + torch.einsum("bn,bh,bhp->bhnp", bmat.to(f32), dt1, xh)
    y = torch.einsum("bn,bhnp->bhp", cmat.to(f32), s)
    y = y + d_skip[None, :, None] * xh
    y = y.reshape(bsz, 1, di).to(zxbcdt.dtype)
    y = rmsnorm(y * F.silu(z), norm_scale, cfg.norm_eps)
    return y, s, hist[:, 1:]
