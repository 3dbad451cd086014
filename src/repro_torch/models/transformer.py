"""Model stacks of the ten configs' families: dense, vlm, moe, audio, and
the recurrent hybrid (zamba2: Mamba2 units and one shared attention block)
and ssm (xLSTM: mLSTM units with an sLSTM each).

The parameters are a nested dict of tensors with the JAX package's tree:
the same keys, the same nesting and the same stacked leading axes (a
``layers`` stack of ``[L, ...]`` leaves; gemma3's ``units`` of
``[n_units, pattern_local + pattern_global, ...]`` and its windowed
``rem``; deepseek's ``dense_layers`` before its MoE ``layers``; zamba2's
``mamba_units`` of ``[n_units, unit - 1, ...]``, its unstacked
``shared_attn`` and its ``mamba_rem``; xLSTM's ``units/mlstm`` of
``[n_units, unit - 1, ...]`` and ``units/slstm`` of ``[n_units, ...]``).
:class:`Model` registers that tree as its parameters, so
``model.named_parameters()`` with ``.`` read as ``/`` gives the JAX
package's checkpoint keys (``layers/attn/w_q_in``), and checkpoints are
interchangeable between the two packages.

The JAX package scans each stack (``lax.scan``) under ``jax.checkpoint``;
the port runs a Python loop over the stacked axis, over views of each
layer's slice, each step under ``torch.utils.checkpoint`` when a
``remat_policy`` is given (``"nothing"``: full recomputation; ``"dots"``:
the matmul outputs saved).  Decode writes the KV caches in place.  The
cross-entropy loss is computed in sequence chunks whose logits are
recomputed in backward, so the full [B, S, V] logits never exist.
zamba2's one shared attention block runs after every unit, so its gradient
is the sum over its uses; the recurrent layers' states are float32 (float64
in a float64 model).
"""
from __future__ import annotations

import functools
from typing import Any

import numpy as np
import torch
import torch.distributed._functional_collectives as funcol
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils import checkpoint as torch_checkpoint

from ..distributed.sharding import constrain, gather_fsdp, join, rows_like
from . import attention, mlp, moe, ssm, xlstm
from .layers import activation, compute_dtype, dense_init, embed_init, rmsnorm, zeros


REMAT_POLICIES = ("none", "nothing", "dots")
# Ops whose outputs the "dots" policy keeps (the JAX package's
# dots_with_no_batch_dims_saveable; bmm as well, the MoE experts' matmuls).
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
               torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (torch_checkpoint.CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else torch_checkpoint.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, policy: str):
    """``fn`` under activation recomputation: ``"nothing"`` saves only its
    inputs (``jax.checkpoint``), ``"dots"`` also the matmul outputs;
    ``"none"``, or no gradient to take, runs it as it is."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {policy!r}")
    if policy == "none":
        return fn

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        kw = {}
        if policy == "dots":
            kw["context_fn"] = functools.partial(
                torch_checkpoint.create_selective_checkpoint_contexts, _dots_policy)
        return torch_checkpoint.checkpoint(fn, *args, use_reentrant=False, **kw)
    return run


def pad_vocab(v: int, mult: int = 16) -> int:
    return int(np.ceil(v / mult) * mult)


def unstack(tree: dict) -> list[dict]:
    """Views of each index of a tree stacked on its leading axis."""
    parts = {k: unstack(v) if isinstance(v, dict) else v.unbind(0)
             for k, v in tree.items()}
    n = len(next(iter(parts.values())))
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


# ---------------------------------------------------------------------------
# block initializers: one draw for a whole stack (``lead`` = stacked axes)
# ---------------------------------------------------------------------------

def _attn_mlp_init(gen, cfg, dtype, device, lead, d_ff=None):
    return {
        "ln1": zeros((cfg.d_model,), dtype, device, lead),
        "attn": attention.init(gen, cfg, dtype, device, lead),
        "ln2": zeros((cfg.d_model,), dtype, device, lead),
        "mlp": mlp.init(gen, cfg.d_model, d_ff or cfg.d_ff, dtype, device, lead),
    }


def _mamba_init(gen, cfg, dtype, device, lead):
    return {"ln": zeros((cfg.d_model,), dtype, device, lead),
            "mamba": ssm.init(gen, cfg, dtype, device, lead)}


def _xlstm_unit_init(gen, cfg, dtype, device, n_units):
    lead = (n_units, cfg.xlstm_slstm_every - 1)
    return {
        "mlstm": {"ln": zeros((cfg.d_model,), dtype, device, lead),
                  "cell": xlstm.m_init(gen, cfg, dtype, device, lead)},
        "slstm": {"ln": zeros((cfg.d_model,), dtype, device, (n_units,)),
                  "cell": xlstm.s_init(gen, cfg, dtype, device, (n_units,))},
    }


def _attn_moe_init(gen, cfg, dtype, device, lead, model_axis):
    return {
        "ln1": zeros((cfg.d_model,), dtype, device, lead),
        "attn": attention.init(gen, cfg, dtype, device, lead),
        "ln2": zeros((cfg.d_model,), dtype, device, lead),
        "moe": moe.init(gen, cfg, dtype, device, model_axis, lead),
    }


# ---------------------------------------------------------------------------
# block steps
# ---------------------------------------------------------------------------

def _sp(cfg, x):
    """The residual stream's sharding: batch over (pod, data), and the
    sequence over ``model`` under ``sp_residual``.  A row-parallel
    product's partial sums (attention's and the MLP's outputs) are reduced
    here before they join the stream."""
    if cfg.sp_residual:
        return constrain(x, ("batch", "model", None))
    return constrain(x, ("batch", None, None))


def _attn_mlp_fwd(p, cfg, x, positions, window, theta):
    x = _sp(cfg, x)
    h, _ = attention.forward(p["attn"], cfg, rmsnorm(x, p["ln1"], cfg.norm_eps),
                             positions, window=window, theta=theta,
                             skip_uncausal=cfg.attn_skip_uncausal)
    x = x + _sp(cfg, h)
    x = x + _sp(cfg, mlp.forward(p["mlp"], rmsnorm(x, p["ln2"], cfg.norm_eps),
                                 cfg.act))
    return x


def _attn_moe_fwd(p, cfg, x, positions, model_axis):
    x = _sp(cfg, x)
    h, _ = attention.forward(p["attn"], cfg, rmsnorm(x, p["ln1"], cfg.norm_eps),
                             positions, skip_uncausal=cfg.attn_skip_uncausal)
    x = x + _sp(cfg, h)
    y, aux = moe.forward(p["moe"], cfg, rmsnorm(x, p["ln2"], cfg.norm_eps),
                         model_axis=model_axis)
    return x + _sp(cfg, y), aux


def _mamba_fwd(p, cfg, x):
    x = _sp(cfg, x)
    return x + _sp(cfg, ssm.forward(p["mamba"], cfg,
                                    rmsnorm(x, p["ln"], cfg.norm_eps)))


def _mamba_decode(p, cfg, x, c):
    o, _ = ssm.decode_step(p["mamba"], cfg, rmsnorm(x, p["ln"], cfg.norm_eps), c)
    return x + _sp(cfg, o)


def _xlstm_unit_fwd(unit_p, cfg, x):
    for p in unstack(unit_p["mlstm"]):
        x = _sp(cfg, x)
        x = x + _sp(cfg, xlstm.m_forward(p["cell"], cfg,
                                         rmsnorm(x, p["ln"], cfg.norm_eps)))
    p = unit_p["slstm"]
    return x + _sp(cfg, xlstm.s_forward(p["cell"], cfg,
                                        rmsnorm(x, p["ln"], cfg.norm_eps)))


def _attn_decode(p, cfg, x, c, pos, window=None, theta=None, ring=False):
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    o, _ = attention.decode_step(p["attn"], cfg, h, c, pos, window=window,
                                 theta=theta, ring=ring)
    return x + _sp(cfg, o)


def _attn_mlp_decode(p, cfg, x, c, pos, window=None, theta=None, ring=False):
    x = _attn_decode(p, cfg, x, c, pos, window, theta, ring)
    return x + _sp(cfg, mlp.forward(p["mlp"], rmsnorm(x, p["ln2"], cfg.norm_eps),
                                    cfg.act))


# ---------------------------------------------------------------------------
# cross-entropy, and its vocab-parallel form on DTensors
# ---------------------------------------------------------------------------

def _cross_entropy(logits, t):
    """``logsumexp - gold`` of each position, in the logits' float type; no
    nll_loss (it has no deterministic CUDA kernel).  DTensor logits with the
    vocabulary over ``model`` take :class:`_VocabParallelCE` on each
    device's shard (DTensor's own logsumexp would gather the vocabulary)."""
    if not isinstance(logits, DTensor):
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, t.long()[..., None])[..., 0]
        return lse - gold
    mesh = logits.device_mesh
    names = list(mesh.mesh_dim_names)
    vdim = logits.ndim - 1
    mi = names.index("model") if "model" in names else None
    if mi is None or logits.placements[mi] != Shard(vdim):
        logits = logits.redistribute(mesh, t.placements)      # rows as t's
        return DTensor.from_local(
            _cross_entropy(logits.to_local(), t.to_local()), mesh,
            t.placements, run_check=False)
    want = list(logits.placements)
    if [p for i, p in enumerate(want) if i != mi] != [
            p for i, p in enumerate(t.placements) if i != mi]:
        raise ValueError(f"logits {logits.placements} and targets "
                         f"{t.placements} split their rows differently")
    loc = logits.to_local()
    offset = mesh.get_coordinate()[mi] * loc.shape[-1]
    ce = _VocabParallelCE.apply(loc, t.to_local(), offset, (mesh, mi))
    return DTensor.from_local(ce, mesh, t.placements, run_check=False)


def _embedding(tokens, table):
    """Rows of ``table`` at ``tokens``.  A DTensor table with the vocabulary
    over ``model`` is gathered over the other axes, each device looks up
    the tokens of its vocabulary slice (zeros elsewhere) and the partial
    rows are summed over ``model``: the JAX package's one-hot product
    (each shard its vocab slice, then a psum)."""
    if not isinstance(table, DTensor):
        return F.embedding(tokens.long(), table)
    mesh = table.device_mesh
    names = list(mesh.mesh_dim_names)
    mi = names.index("model") if "model" in names else None
    if mi is None or table.placements[mi] != Shard(0):
        table = table.redistribute(mesh, [Replicate()] * mesh.ndim)
        return DTensor.from_local(F.embedding(tokens.to_local().long(),
                                              table.to_local()),
                                  mesh, tokens.placements, run_check=False)
    want = [Replicate()] * mesh.ndim
    want[mi] = Shard(0)
    # Each device's gradient holds its own rows' lookups: partial over the
    # axes that split the tokens, summed (reduce-scattered) on the way back.
    grad_pl = [Shard(0) if i == mi else
               Partial() if isinstance(p, Shard) else Replicate()
               for i, p in enumerate(tokens.placements)]
    loc = table.redistribute(mesh, want).to_local(grad_placements=grad_pl)
    idx = tokens.to_local().long() - mesh.get_coordinate()[mi] * loc.shape[0]
    inside = (idx >= 0) & (idx < loc.shape[0])
    rows = F.embedding(idx.clamp(0, loc.shape[0] - 1), loc)
    rows = rows * inside[..., None].to(rows.dtype)
    out_pl = list(tokens.placements)
    out_pl[mi] = Partial()
    return DTensor.from_local(rows, mesh, out_pl, run_check=False)


class _VocabParallelCE(torch.autograd.Function):
    """Cross-entropy of logits whose vocabulary is split over a mesh axis:
    each device holds ``l [..., V/m]`` from ``offset``; the max, the sum of
    exponentials and the gold logit are all-reduced over the axis (three
    collectives of one value a position), the gradient is local."""

    @staticmethod
    def forward(ctx, l, t, offset: int, group):
        m = funcol.all_reduce(l.detach().amax(-1), "max", group)
        e = torch.exp(l - m[..., None])
        sumexp = funcol.all_reduce(e.sum(-1), "sum", group)
        idx = t.long() - offset
        inside = (idx >= 0) & (idx < l.shape[-1])
        idx = idx.clamp(0, l.shape[-1] - 1)
        g = torch.gather(l, -1, idx[..., None])[..., 0]
        gold = funcol.all_reduce(torch.where(inside, g, torch.zeros_like(g)),
                                 "sum", group)
        ctx.save_for_backward(e, sumexp, idx, inside)
        return m + torch.log(sumexp) - gold

    @staticmethod
    def backward(ctx, g):
        e, sumexp, idx, inside = ctx.saved_tensors
        grad = e / sumexp[..., None]
        grad.scatter_add_(-1, idx[..., None], -inside.to(grad.dtype)[..., None])
        return grad * g[..., None], None, None, None


# ---------------------------------------------------------------------------
# parameters as a module
# ---------------------------------------------------------------------------

class _Tree(nn.Module):
    """One level of a parameter tree: leaves as parameters, dicts as
    submodules."""

    def __init__(self, tree: dict):
        super().__init__()
        _register(self, tree)


def _register(module: nn.Module, tree: dict) -> None:
    for k, v in tree.items():
        if isinstance(v, dict):
            module.add_module(k, _Tree(v))
        else:
            if not isinstance(v, nn.Parameter):
                v = nn.Parameter(v)
            module.register_parameter(k, v)


def _tree_of(module: nn.Module) -> dict:
    out: dict[str, Any] = dict(module._parameters)
    out.update({k: _tree_of(m) for k, m in module._modules.items()})
    return out


# ---------------------------------------------------------------------------
# model families
# ---------------------------------------------------------------------------

class Model(nn.Module):
    """init / forward / decode of one config, holding its parameter tree.

    The methods take the tree explicitly, as the JAX package's do
    (``forward(params, batch)``, ``decode_step(params, cache, tokens,
    pos)``); ``load_params`` registers a tree as the module's parameters
    and ``params`` gives it back."""

    FAMILIES = ("dense", "vlm", "moe", "audio", "hybrid", "ssm")

    def __init__(self, cfg, model_axis: int = 16):
        super().__init__()
        if cfg.family not in self.FAMILIES:
            raise ValueError(cfg.family)
        self.cfg = cfg
        self.model_axis = model_axis
        self._last_aux = None

    # ---- parameters ---------------------------------------------------------
    def load_params(self, tree: dict) -> dict:
        """Register ``tree`` as this module's parameters (replacing any
        earlier tree) and return it as parameters."""
        for k in list(self._parameters):
            del self._parameters[k]
        for k in list(self._modules):
            del self._modules[k]
        _register(self, tree)
        return self.params

    @property
    def params(self) -> dict:
        return _tree_of(self)

    # ---- init -------------------------------------------------------------
    def init(self, gen: torch.Generator | None, device=None) -> dict:
        """A fresh parameter tree, drawn from ``gen`` on its device; with
        ``gen=None``, the shapes alone on ``device="meta"``."""
        cfg = self.cfg
        dtype = cfg.params_dtype
        dev = gen.device if gen is not None else torch.device(device)
        if gen is None and dev.type != "meta":
            raise ValueError("parameters off the meta device are drawn from "
                             "a generator")
        vpad = pad_vocab(cfg.vocab_size)
        params: dict[str, Any] = {
            "embed": embed_init(gen, vpad, cfg.d_model, dtype, dev),
            "ln_f": zeros((cfg.d_model,), dtype, dev),
        }
        if not cfg.tie_embeddings:
            params["w_unembed_in"] = dense_init(gen, cfg.d_model, vpad, dtype, dev)

        fam = cfg.family
        if fam in ("dense", "vlm"):
            if cfg.pattern_local:  # gemma3 local:global units
                unit = cfg.pattern_local + cfg.pattern_global
                n_units = cfg.n_layers // unit
                rem = cfg.n_layers - n_units * unit
                params["units"] = _attn_mlp_init(gen, cfg, dtype, dev,
                                                 (n_units, unit))
                if rem:
                    params["rem"] = _attn_mlp_init(gen, cfg, dtype, dev, (rem,))
            else:
                params["layers"] = _attn_mlp_init(gen, cfg, dtype, dev,
                                                  (cfg.n_layers,))
            if fam == "vlm":
                params["proj"] = {  # 2-layer multimodal projector (llava)
                    "w1_in": dense_init(gen, cfg.d_model, cfg.d_model, dtype, dev),
                    "w2_in": dense_init(gen, cfg.d_model, cfg.d_model, dtype, dev),
                }
        elif fam == "moe":
            nd = cfg.first_dense_layers
            if nd:
                params["dense_layers"] = _attn_mlp_init(
                    gen, cfg, dtype, dev, (nd,), d_ff=cfg.d_ff_dense)
            params["layers"] = _attn_moe_init(gen, cfg, dtype, dev,
                                              (cfg.n_layers - nd,),
                                              self.model_axis)
        elif fam == "hybrid":
            unit = cfg.hybrid_attn_every
            n_units = cfg.n_layers // unit
            rem = cfg.n_layers - n_units * unit
            params["mamba_units"] = _mamba_init(gen, cfg, dtype, dev,
                                                (n_units, unit - 1))
            params["shared_attn"] = _attn_mlp_init(gen, cfg, dtype, dev, ())  # ONE copy
            if rem:
                params["mamba_rem"] = _mamba_init(gen, cfg, dtype, dev, (rem,))
        elif fam == "ssm":  # xlstm
            params["units"] = _xlstm_unit_init(
                gen, cfg, dtype, dev, cfg.n_layers // cfg.xlstm_slstm_every)
        else:  # audio
            params["in_proj_in"] = dense_init(gen, cfg.d_model, cfg.d_model,
                                              dtype, dev)
            params["mask_embed"] = zeros((cfg.d_model,), dtype, dev)
            params["layers"] = _attn_mlp_init(gen, cfg, dtype, dev,
                                              (cfg.n_layers,))
        return params

    # ---- embedding / head ---------------------------------------------------
    def _embed(self, params, tokens):
        # The JAX package contracts a one-hot matrix with the table for
        # vocabularies of 8192 or more (it partitions under SPMD).  One
        # nonzero product plus zeros is exact, so a gather gives the same
        # bits.
        cfg = self.cfg
        x = _embedding(tokens, params["embed"])
        if cfg.embed_scale:
            x = x * join(torch.tensor(np.sqrt(cfg.d_model), dtype=x.dtype,
                                      device=x.device), x)
        return constrain(x, ("batch", None, None))

    def _logits(self, params, x):
        if self.cfg.tie_embeddings:
            return x @ gather_fsdp(params["embed"]).T
        return x @ gather_fsdp(params["w_unembed_in"])

    # ---- forward (train/prefill) -------------------------------------------
    def forward(self, params, batch, *, remat_policy: str = "nothing"):
        """Final hidden states (after ``ln_f``) of a batch.  Each layer (a
        gemma3, zamba2 or xLSTM unit) runs under ``remat_policy`` while
        gradients are taken."""
        cfg = self.cfg
        fam = cfg.family
        self._last_aux = None
        if fam == "audio":
            x = batch["features"].to(cfg.params_dtype) @ params["in_proj_in"]
            mask = batch["mask"]
            x = torch.where(mask[..., None], params["mask_embed"][None, None], x)
        elif fam == "vlm":
            tok = self._embed(params, batch["tokens"])
            img = batch["image_embeds"].to(cfg.params_dtype)
            img = (activation("gelu")(img @ params["proj"]["w1_in"])
                   @ params["proj"]["w2_in"])
            x = torch.cat([img, tok], dim=1)
        else:
            x = self._embed(params, batch["tokens"])
        b, s = x.shape[:2]
        positions = rows_like(lambda n: torch.arange(
            s, dtype=torch.int32, device=x.device)[None].expand(n, s), x)
        x = self._run_stack(params, x, positions, remat_policy)
        return rmsnorm(x, params["ln_f"], cfg.norm_eps)

    def _run_stack(self, params, x, positions, remat_policy: str):
        cfg = self.cfg

        def dense_step(window, theta):
            return _remat(lambda x, p: _attn_mlp_fwd(p, cfg, x, positions,
                                                     window, theta), remat_policy)

        if cfg.family == "moe":
            step = dense_step(None, cfg.rope_theta)
            for p in unstack(params["dense_layers"]) if "dense_layers" in params else ():
                x = step(x, p)
            mstep = _remat(lambda x, p: _attn_moe_fwd(p, cfg, x, positions,
                                                      self.model_axis), remat_policy)
            auxs = []
            for p in unstack(params["layers"]):
                x, aux = mstep(x, p)
                auxs.append(aux)
            self._last_aux = torch.stack(auxs).mean()
            return x
        if cfg.family == "hybrid":
            def unit(x, unit_p, shared):
                for p in unstack(unit_p):
                    x = _mamba_fwd(p, cfg, x)
                return _attn_mlp_fwd(shared, cfg, x, positions, None, cfg.rope_theta)
            ustep = _remat(unit, remat_policy)
            for unit_p in unstack(params["mamba_units"]):
                x = ustep(x, unit_p, params["shared_attn"])
            rstep = _remat(lambda x, p: _mamba_fwd(p, cfg, x), remat_policy)
            for p in unstack(params["mamba_rem"]) if "mamba_rem" in params else ():
                x = rstep(x, p)
            return x
        if cfg.family == "ssm":
            ustep = _remat(lambda x, p: _xlstm_unit_fwd(p, cfg, x), remat_policy)
            for unit_p in unstack(params["units"]):
                x = ustep(x, unit_p)
            return x
        if cfg.pattern_local:
            def unit(x, unit_p):
                layers = unstack(unit_p)
                for p in layers[:cfg.pattern_local]:
                    x = _attn_mlp_fwd(p, cfg, x, positions, cfg.window_size,
                                      cfg.rope_theta)
                for p in layers[cfg.pattern_local:]:
                    x = _attn_mlp_fwd(p, cfg, x, positions, None,
                                      cfg.rope_theta * 100.0)
                return x
            ustep = _remat(unit, remat_policy)
            for unit_p in unstack(params["units"]):
                x = ustep(x, unit_p)
            rstep = dense_step(cfg.window_size, cfg.rope_theta)
            for p in unstack(params["rem"]) if "rem" in params else ():
                x = rstep(x, p)
            return x
        step = dense_step(cfg.window_size, cfg.rope_theta)
        for p in unstack(params["layers"]):
            x = step(x, p)
        return x

    # ---- chunked loss -------------------------------------------------------
    def loss(self, params, batch, *, remat_policy: str = "nothing",
             seq_chunk: int = 512):
        """Mean cross-entropy of the next token (dense, moe, hybrid, ssm,
        vlm: after the
        image prefix) or of the masked frames (audio), in float32, plus
        ``0.01 · aux`` for MoE.  The logits are made ``seq_chunk``
        positions at a time and recomputed in backward.

        The JAX package's loss drops the last ``s mod seq_chunk`` targets
        when ``s = seq - 1`` exceeds ``seq_chunk`` and does not divide by it
        (``src/repro/models/transformer.py:351-353``); the port takes them
        as a last, shorter chunk.  Where ``s`` divides, the two agree."""
        cfg = self.cfg
        hidden = self.forward(params, batch, remat_policy=remat_policy)
        if cfg.family == "audio":
            targets = batch["targets"]
            weights = batch["mask"].float()       # masked prediction
            hidden_t = hidden
        elif cfg.family == "vlm":
            s_img = batch["image_embeds"].shape[1]
            hidden_t = hidden[:, s_img:][:, :-1]
            targets = batch["tokens"][:, 1:]
            weights = None
        else:
            hidden_t = hidden[:, :-1]
            targets = batch["tokens"][:, 1:]
            weights = None

        def chunk_ce(h, t, w):
            # logsumexp - gold, in float32; no nll_loss (it has no
            # deterministic CUDA kernel).
            logits = self._logits(params, h).to(compute_dtype(h.dtype))
            ce = _cross_entropy(logits, t)
            return torch.sum(ce if w is None else ce * w)

        body = _remat(chunk_ce, "nothing")
        s = hidden_t.shape[1]
        seq_chunk = min(seq_chunk, s)
        tot = None
        for i in range(0, s, seq_chunk):
            sl = slice(i, min(i + seq_chunk, s))
            part = body(hidden_t[:, sl], targets[:, sl],
                        None if weights is None else weights[:, sl])
            tot = part if tot is None else tot + part
        count = (torch.sum(weights) if weights is not None
                 else torch.tensor(float(targets.numel()), device=hidden.device))
        loss = tot / torch.clamp(join(count, tot), min=1.0)
        if self._last_aux is not None:
            loss = loss + 0.01 * self._last_aux
        return loss

    # ---- decode -------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, device=None):
        """Zeroed KV caches and recurrent states, stacked like the layers,
        on ``device`` (the registered parameters' unless given)."""
        cfg = self.cfg
        dtype = cfg.params_dtype
        dev = torch.device(device) if device is not None else self.embed.device

        def stack(lead, length):
            return attention.init_cache(cfg, batch, length, dtype, dev, lead)

        if cfg.family in ("dense", "vlm"):
            if cfg.pattern_local:
                unit = cfg.pattern_local + cfg.pattern_global
                n_units = cfg.n_layers // unit
                rem = cfg.n_layers - n_units * unit
                # Sliding-window layers only cache the window (the gemma3
                # memory win); global layers cache the full context.
                local_len = min(max_len, (cfg.window_size or max_len))
                cache = {
                    "units_local": stack((n_units, cfg.pattern_local), local_len),
                    "units_global": stack((n_units, cfg.pattern_global), max_len),
                }
                if rem:
                    cache["rem"] = stack((rem,), local_len)
                return cache
            return {"layers": stack((cfg.n_layers,), max_len)}
        if cfg.family == "moe":
            nd = cfg.first_dense_layers
            cache = {}
            if nd:
                cache["dense_layers"] = stack((nd,), max_len)
            cache["layers"] = stack((cfg.n_layers - nd,), max_len)
            return cache
        if cfg.family == "hybrid":
            unit = cfg.hybrid_attn_every
            n_units = cfg.n_layers // unit
            rem = cfg.n_layers - n_units * unit
            cache = {"mamba_units": ssm.init_cache(cfg, batch, dtype, dev,
                                                   (n_units, unit - 1)),
                     "attn": stack((n_units,), max_len)}
            if rem:
                cache["mamba_rem"] = ssm.init_cache(cfg, batch, dtype, dev, (rem,))
            return cache
        if cfg.family == "ssm":
            unit = cfg.xlstm_slstm_every
            n_units = cfg.n_layers // unit
            return {"units": {
                "mlstm": xlstm.m_init_cache(cfg, batch, dev, (n_units, unit - 1)),
                "slstm": xlstm.s_init_cache(cfg, batch, dev, (n_units,))}}
        raise ValueError(cfg.family)  # audio: encoder-only, no decode

    def decode_step(self, params, cache, tokens, pos):
        """One token for every sequence.  tokens: [B,1]; pos: int.  Returns
        float32 logits [B,1,Vpad] and the cache, written in place."""
        cfg = self.cfg
        pos = int(pos)
        x = self._embed(params, tokens)

        if cfg.family in ("dense", "vlm"):
            if cfg.pattern_local:
                for unit_p, cl, cg in zip(unstack(params["units"]),
                                          unstack(cache["units_local"]),
                                          unstack(cache["units_global"])):
                    layers = unstack(unit_p)
                    # Windowed layers cache only the window -> ring buffer.
                    for p, c in zip(layers[:cfg.pattern_local], unstack(cl)):
                        x = _attn_mlp_decode(p, cfg, x, c, pos, cfg.window_size,
                                             cfg.rope_theta, ring=True)
                    for p, c in zip(layers[cfg.pattern_local:], unstack(cg)):
                        x = _attn_mlp_decode(p, cfg, x, c, pos, None,
                                             cfg.rope_theta * 100.0)
                if "rem" in params:
                    for p, c in zip(unstack(params["rem"]), unstack(cache["rem"])):
                        x = _attn_mlp_decode(p, cfg, x, c, pos, cfg.window_size,
                                             ring=True)
            else:
                for p, c in zip(unstack(params["layers"]),
                                unstack(cache["layers"])):
                    x = _attn_mlp_decode(p, cfg, x, c, pos, cfg.window_size)
        elif cfg.family == "moe":
            if "dense_layers" in params:
                for p, c in zip(unstack(params["dense_layers"]),
                                unstack(cache["dense_layers"])):
                    x = _attn_mlp_decode(p, cfg, x, c, pos)
            for p, c in zip(unstack(params["layers"]), unstack(cache["layers"])):
                x = _attn_decode(p, cfg, x, c, pos)
                # One token a row: routing groups of one (g_sz = 1), so the
                # capacities differ from the forward's groups of S.
                y, _ = moe.forward(p["moe"], cfg,
                                   rmsnorm(x, p["ln2"], cfg.norm_eps),
                                   model_axis=self.model_axis)
                x = x + _sp(cfg, y)
        elif cfg.family == "hybrid":
            shared = params["shared_attn"]
            for unit_p, unit_c, attn_c in zip(unstack(params["mamba_units"]),
                                              unstack(cache["mamba_units"]),
                                              unstack(cache["attn"])):
                for p, c in zip(unstack(unit_p), unstack(unit_c)):
                    x = _mamba_decode(p, cfg, x, c)
                x = _attn_mlp_decode(shared, cfg, x, attn_c, pos)
            if "mamba_rem" in params:
                for p, c in zip(unstack(params["mamba_rem"]),
                                unstack(cache["mamba_rem"])):
                    x = _mamba_decode(p, cfg, x, c)
        elif cfg.family == "ssm":
            for unit_p, unit_c in zip(unstack(params["units"]),
                                      unstack(cache["units"])):
                for p, c in zip(unstack(unit_p["mlstm"]), unstack(unit_c["mlstm"])):
                    o, _ = xlstm.m_decode_step(
                        p["cell"], cfg, rmsnorm(x, p["ln"], cfg.norm_eps), c)
                    x = x + _sp(cfg, o)
                p, c = unit_p["slstm"], unit_c["slstm"]
                o, _ = xlstm.s_decode_step(p["cell"], cfg,
                                           rmsnorm(x, p["ln"], cfg.norm_eps), c)
                x = x + _sp(cfg, o)
        else:
            raise ValueError(cfg.family)

        x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
        return self._logits(params, x).float(), cache
