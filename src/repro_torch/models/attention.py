"""GQA/MQA attention with qk-norm, RoPE, sliding windows, and a KV cache.

Train/prefill path computes full (optionally windowed) causal attention;
decode path attends one new token against a fixed-capacity cache.  Head
projections keep the JAX package's tensor-parallel names (``w_in`` /
``w_out``).  q, k, v and the output pass through
``distributed.sharding.constrain`` where the JAX package pins their
sharding: a DTensor under an active mesh is redistributed there, any other
tensor passes through as itself.

On DTensors the attention core runs on each device's shards
(:func:`_on_shards`, the counterpart of the JAX package's SPMD partitioning
of the same einsums): the grouped-query reshape of a head axis sharded
over ``model`` has no DTensor sharding rule, and the chunk loops would pay
DTensor's dispatch on every small product.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..distributed.sharding import (ContiguousGrad, constrain, gather_fsdp,
                                    rows_like)
from .layers import apply_rope, compute_dtype, dense_init, head_rmsnorm, zeros

NEG = -1e30


def init(gen, cfg, dtype, device, lead: tuple = ()):
    d, hd = cfg.d_model, cfg.hd
    p = {
        "w_q_in": dense_init(gen, d, cfg.n_heads * hd, dtype, device, lead=lead),
        "w_k_in": dense_init(gen, d, cfg.n_kv_heads * hd, dtype, device, lead=lead),
        "w_v_in": dense_init(gen, d, cfg.n_kv_heads * hd, dtype, device, lead=lead),
        "w_o_out": dense_init(gen, cfg.n_heads * hd, d, dtype, device,
                              scale=1.0 / np.sqrt(cfg.n_heads * hd), lead=lead),
    }
    if cfg.qk_norm:
        p["q_norm"] = zeros((hd,), dtype, device, lead)
        p["k_norm"] = zeros((hd,), dtype, device, lead)
    return p


def _whole_heads(t, n_heads: int):
    """A DTensor projection ``t [B, S, H*hd]`` split over ``model`` into
    pieces that cut heads (qwen3-4b's 8 kv heads over 16) is gathered over
    ``model``, so the heads reshape splits no head; any other ``t`` as it
    is."""
    if not isinstance(t, DTensor):
        return t
    mesh = t.device_mesh
    names = list(mesh.mesh_dim_names)
    if "model" not in names:
        return t
    mi = names.index("model")
    if t.placements[mi] != Shard(t.ndim - 1) or n_heads % mesh.size(mi) == 0:
        return t
    want = list(t.placements)
    want[mi] = Replicate()
    return t.redistribute(mesh, want)


def _project_qkv(p, cfg, x, positions, theta):
    b, s, _ = x.shape
    hd = cfg.hd
    def heads(name, n):
        return _whole_heads(x @ gather_fsdp(p[name]), n).reshape(b, s, n, hd)

    q = heads("w_q_in", cfg.n_heads)
    k = heads("w_k_in", cfg.n_kv_heads)
    v = heads("w_v_in", cfg.n_kv_heads)
    if cfg.qk_norm:
        q = head_rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = head_rmsnorm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, theta)
    k = apply_rope(k, positions, theta)
    # Batch over (pod, data), heads over model (falls back to head_dim for
    # small-KV archs via the divisibility guard).
    q = constrain(q, ("batch", None, "model", None))
    k = constrain(k, ("batch", None, "model", None))
    v = constrain(v, ("batch", None, "model", None))
    return q, k, v


def _sdpa(q, k, v, mask, cfg=None, *, head_dim: int | None = None,
          reduce_scores=None, seq_slice=None, seq_reduce=None):
    """q: [B,S,H,D]; k,v: [B,T,KV,D]; mask: [B or 1, 1, S, T] additive.

    Dense path — used for decode (S=1) and small shapes; longer sequences go
    through :func:`_sdpa_chunked`.  Scores in float32, probabilities cast to
    ``v.dtype`` before the PV product, as the JAX package does.  On a
    device's shard of the head dim, ``head_dim`` is the whole one (the
    scale) and ``reduce_scores`` sums the partial scores over the shards.
    On a device's shard of the keys (``k, v`` positions ``seq_slice =
    (start, n)`` of the mask's), ``seq_reduce(t, op)`` all-reduces over the
    shards: the softmax is combined by log-sum-exp (the max, then the
    rescaled numerators and denominators summed)."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    groups = h // kv
    q = q.reshape(b, s, kv, groups, hd)
    acc = compute_dtype(q.dtype)
    scores = torch.einsum("bskgd,btkd->bkgst", q.to(acc), k.to(acc))
    if reduce_scores is not None:
        scores = reduce_scores(scores)
    scores = scores / np.sqrt(head_dim or hd)
    if seq_slice is not None:
        mask = mask[..., seq_slice[0]:seq_slice[0] + seq_slice[1]]
    scores = scores + mask[:, :, None, :, :]     # broadcast over groups
    if seq_reduce is None:
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bkgst,btkd->bskgd", probs.to(v.dtype), v)
        return out.reshape(b, s, h, hd)
    m = seq_reduce(scores.amax(-1, keepdim=True), "max")
    e = torch.exp(scores - m)
    den = seq_reduce(e.sum(-1), "sum")                           # [b,k,g,s]
    num = seq_reduce(torch.einsum("bkgst,btkd->bskgd", e.to(v.dtype), v)
                     .to(acc), "sum")
    out = num / den.permute(0, 3, 1, 2)[..., None]
    return out.to(v.dtype).reshape(b, s, h, hd)


def _sdpa_chunked(q, k, v, cfg=None, *, causal: bool, window: int | None,
                  cq: int = 512, ck: int = 1024, skip_uncausal: bool = False):
    """Flash-style online-softmax attention over chunks: O(S·chunk) memory,
    never materialising the [S, T] score matrix.  Plain PyTorch loops over
    the q chunks and, inside, the kv chunks, with the JAX package's additive
    masks and update order.

    ``skip_uncausal=True`` enumerates only the lower-triangular (and
    in-window) chunk pairs; otherwise every pair is visited with masking.
    """
    b, s, h, hd = q.shape
    kv = k.shape[2]
    g = h // kv
    cq = min(cq, s)
    ck = min(ck, s)
    if s % cq or s % ck:
        raise ValueError(f"sequence {s} must divide by the chunks {cq}, {ck}")
    nq, nk = s // cq, s // ck
    dev = q.device
    qc = q.reshape(b, nq, cq, kv, g, hd).float() / np.sqrt(hd)
    kc = k.reshape(b, nk, ck, kv, hd).float()
    vc = v.reshape(b, nk, ck, kv, hd).float()
    qc = constrain(qc, ("batch", None, None, "model", None, None))
    kc = constrain(kc, ("batch", None, None, "model", None))
    vc = constrain(vc, ("batch", None, None, "model", None))

    def bias_for(i, j):
        """Additive float32 mask bias [cq, ck]."""
        qpos = i * cq + torch.arange(cq, device=dev)
        kpos = j * ck + torch.arange(ck, device=dev)
        bias = torch.zeros((cq, ck), dtype=torch.float32, device=dev)
        if causal:
            bias = bias + torch.where(kpos[None, :] <= qpos[:, None], 0.0, NEG)
        if window is not None:
            bias = bias + torch.where((qpos[:, None] - kpos[None, :]) < window,
                                      0.0, NEG)
        return bias

    def row_for(i, js):
        """One q-chunk against the kv chunks listed in ``js``."""
        qblk = qc[:, i]                                          # [b,cq,kv,g,d]
        m = torch.full((b, cq, kv, g), NEG, dtype=torch.float32, device=dev)
        l = torch.zeros((b, cq, kv, g), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, cq, kv, g, hd), dtype=torch.float32, device=dev)
        for j in js:
            sij = torch.einsum("bqkgd,btkd->bqkgt", qblk, kc[:, j])
            sij = sij + bias_for(i, j)[None, :, None, None, :]
            m_new = torch.maximum(m, sij.amax(-1))
            p = torch.exp(sij - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum("bqkgt,btkd->bqkgd",
                                                        p, vc[:, j])
            m = m_new
        return acc / torch.clamp(l, min=1e-30)[..., None]

    rows = []
    for i in range(nq):
        if skip_uncausal and causal:
            js = [j for j in range(nk)
                  if (j * ck <= i * cq + cq - 1)
                  and (window is None or (i * cq - (j * ck + ck - 1)) < window)]
        else:
            js = range(nk)
        rows.append(row_for(i, js))
    out = torch.stack(rows, dim=1)                               # [b,nq,cq,kv,g,d]
    return out.reshape(b, s, h, hd).to(v.dtype)


def _on_shards(core, q, k, v):
    """``core(q, k, v, **kw) -> out [B,S,H,D]`` on each device's shards of
    DTensors ``q [B,S,H,D]``, ``k, v [B,T,KV,D]`` (batch over the same
    axes), ``out`` placed as ``q``.  Plain tensors go to ``core`` as they
    are.

    Heads over ``model``: q's local heads take the kv heads of their
    groups, k's own shard, or their slice of a replicated k (qwen3-4b's 8
    kv heads do not split 16 ways).  A head dim over ``model`` (a decode
    cache whose kv heads do not split) takes q to the same layout, sums the
    partial scores over ``model`` and brings the output back to q's.
    Keys over an axis (a decode cache split over its sequence, q
    replicated there) give ``core`` its slice of the positions and an
    all-reduce over that axis, as :func:`_sdpa` takes them."""
    if not isinstance(q, DTensor):
        return core(q, k, v)
    mesh = q.device_mesh
    names = list(mesh.mesh_dim_names)
    mi = names.index("model") if "model" in names else None
    q_pl = list(q.placements)
    kw = {}
    if mi is not None and k.placements[mi] == Shard(3):
        want = list(q_pl)
        want[mi] = Shard(3)
        q = q.redistribute(mesh, want)
        group = (mesh, mi)
        kw = {"head_dim": q.shape[-1],
              "reduce_scores": lambda t: funcol.all_reduce(t, "sum", group)}
    elif mi is not None and q_pl[mi] == Replicate() != k.placements[mi]:
        rep = list(k.placements)          # k's heads split, q's do not
        rep[mi] = Replicate()
        k, v = k.redistribute(mesh, rep), v.redistribute(mesh, rep)
    # A replicated k, v of which each device takes its heads' slice gets a
    # gradient partial over ``model``.
    slice_kv = (mi is not None and q_pl[mi] == Shard(2)
                and k.placements[mi] == Replicate())
    kv_grad = None
    if slice_kv:
        kv_grad = list(k.placements)
        kv_grad[mi] = Partial()
    # The local gradients go back contiguous: DTensor describes a shard by
    # the global tensor's strides, and a permuted local gradient (an
    # einsum's) would not view as the next operation asks.
    ql = ContiguousGrad.apply(q.to_local())
    kl, vl = (ContiguousGrad.apply(t.to_local(grad_placements=kv_grad))
              for t in (k, v))
    if slice_kv:
        h, kv = q.shape[2], k.shape[2]
        hl, g = ql.shape[2], h // kv
        first = mesh.get_coordinate()[mi] * hl
        lo, hi = first // g, (first + hl - 1) // g + 1
        if hl % (hi - lo):
            raise ValueError(f"{hl} local heads do not group over kv heads "
                             f"{lo}..{hi - 1}")
        kl, vl = kl[:, :, lo:hi], vl[:, :, lo:hi]
    seq = [i for i, pl in enumerate(k.placements) if pl == Shard(1)]
    if seq:
        (si,) = seq
        if q.placements[si] != Replicate():
            raise ValueError(f"keys split over {names[si]}, queries "
                             f"{q.placements[si]} there")
        kw["seq_slice"] = (mesh.get_coordinate()[si] * kl.shape[1], kl.shape[1])
        kw["seq_reduce"] = lambda t, op: funcol.all_reduce(t, op, (mesh, si))
    out = core(ql, kl, vl, **kw).contiguous()
    out = DTensor.from_local(out, mesh, q.placements, run_check=False)
    if tuple(out.placements) != tuple(q_pl):
        out = out.redistribute(mesh, q_pl)
    return out


def causal_mask(s: int, window: int | None, dtype=torch.float32, device=None):
    i = torch.arange(s, device=device)[:, None]
    j = torch.arange(s, device=device)[None, :]
    allow = j <= i
    if window is not None:
        allow &= (i - j) < window
    return torch.where(allow, 0.0, NEG).to(dtype)[None, None]      # [1,1,S,S]


def full_mask(s: int, dtype=torch.float32, device=None):
    return torch.zeros((1, 1, s, s), dtype=dtype, device=device)


DENSE_SDPA_MAX = 1024  # dense path up to this length, chunked beyond


def forward(p, cfg, x, positions, *, window=None, theta=None, mask=None,
            skip_uncausal: bool = False):
    """Train/prefill attention.  Returns (out, (k, v)) for cache capture."""
    theta = cfg.rope_theta if theta is None else theta
    q, k, v = _project_qkv(p, cfg, x, positions, theta)
    s = x.shape[1]
    if s <= DENSE_SDPA_MAX:
        if mask is None:
            mask = (causal_mask(s, window, device=x.device) if cfg.causal
                    else full_mask(s, device=x.device))
        out = _on_shards(lambda q, k, v, **kw: _sdpa(q, k, v, mask, cfg, **kw),
                         q, k, v)
    else:
        out = _on_shards(lambda q, k, v: _sdpa_chunked(
            q, k, v, cfg, causal=cfg.causal, window=window,
            skip_uncausal=skip_uncausal), q, k, v)
    out = constrain(out, ("batch", None, "model", None))
    b = x.shape[0]
    # Heads that do not split over ``model`` (granite's 24 over 16) come
    # out replicated; split their merged width there, so the product's
    # gradient comes back whole to the heads' reshape.
    out = constrain(out.reshape(b, s, cfg.n_heads * cfg.hd), ("batch", None, "model"))
    return out @ gather_fsdp(p["w_o_out"]), (k, v)


def init_cache(cfg, batch: int, max_len: int, dtype, device, lead: tuple = ()):
    shape = (*lead, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _write_slot(c, t: int, new) -> None:
    """``c[:, t] = new`` (``c [B,T,KV,D]``, ``new [B,KV,D]``); a DTensor
    cache is written on each device's shard, ``new`` first placed as the
    cache's slot.  A cache split over its sequence axis is written only on
    the device that holds position ``t``, at its local index."""
    if not isinstance(c, DTensor):
        c[:, t] = new
        return
    mesh = c.device_mesh
    want = [Replicate() if p == Shard(1) else
            Shard(p.dim - 1) if isinstance(p, Shard) and p.dim > 1 else p
            for p in c.placements]
    # A redistribution may be a collective: every device runs it, the
    # owner alone writes.
    val = new.redistribute(mesh, want).to_local()
    loc = c.to_local()
    for i, p in enumerate(c.placements):
        if p == Shard(1):
            t -= mesh.get_coordinate()[i] * loc.shape[1]
    if 0 <= t < loc.shape[1]:
        loc[:, t] = val


def decode_step(p, cfg, x, cache, pos: int, *, window=None, theta=None,
                ring: bool = False):
    """One-token decode.  x: [B,1,D]; pos: int (same for all rows).

    Writes the new key and value into ``cache`` in place and returns
    (out [B,1,D], cache).  ``ring=True`` treats the cache as a circular
    buffer of the last ``cache_len`` tokens (sliding-window layers cache
    only the window): writes wrap, and a slot can be attended iff it has
    been written (``j <= pos`` before the first wrap, every slot after).
    RoPE always uses the true absolute position.
    """
    theta = cfg.rope_theta if theta is None else theta
    b = x.shape[0]
    positions = rows_like(lambda n: torch.full((n, 1), pos, dtype=torch.int32,
                                               device=x.device), x)
    q, k_new, v_new = _project_qkv(p, cfg, x, positions, theta)
    t = cache["k"].shape[1]
    write = pos % t if ring else pos
    _write_slot(cache["k"], write, k_new[:, 0])
    _write_slot(cache["v"], write, v_new[:, 0])
    j = torch.arange(t, device=x.device)
    if ring:
        allow = (j <= pos) | (pos >= t)
    else:
        allow = j <= pos
        if window is not None:
            allow &= (pos - j) < window
    mask = torch.where(allow, 0.0, NEG)[None, None, None, :]       # [1,1,1,T]
    out = _on_shards(lambda q, k, v, **kw: _sdpa(q, k, v, mask, cfg, **kw),
                     q, cache["k"], cache["v"])
    out = out.reshape(b, 1, cfg.n_heads * cfg.hd) @ gather_fsdp(p["w_o_out"])
    return out, cache
