"""Model registry, demo inputs, step functions and parameters.

``make_train_step`` fuses loss, gradients and AdamW (parameters and
moments updated in place); ``make_prefill_step`` / ``make_encode_step`` /
``make_decode_step`` are the serving functions (the decode step is the
inner loop: one new token against the KV caches).  ``init_params`` draws a
model's parameters on a device, ``init_train_state`` adds the optimizer
state; ``params_from_jax`` carries the JAX package's parameters across, and
``flatten_params`` gives a model's parameters under the JAX package's
checkpoint keys.  ``input_specs``, ``abstract_params``,
``abstract_opt_state`` and ``abstract_cache`` give shape and dtype trees at
any width on the meta device, allocating nothing (the sharding rules read
them).
"""
from __future__ import annotations

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from .. import device as device_lib
from ..configs.base import ModelConfig, ShapeConfig
from ..optim import AdamWState, adamw_init, adamw_update, global_norm
from ..optim.adamw import tree_items, tree_leaves, tree_unflatten
from .transformer import Model


def build_model(cfg: ModelConfig, model_axis: int = 16) -> Model:
    # model_axis sizes the padded expert axis (moe.padded_experts): keep the
    # JAX package's default; the serving driver passes 1.
    return Model(cfg, model_axis=model_axis)


# ---------------------------------------------------------------------------
# input specs and abstract trees (meta tensors: shapes and dtypes, no data)
# ---------------------------------------------------------------------------

META = torch.device("meta")


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Meta tensors for every model input of ``shape`` (the JAX package's
    ``ShapeDtypeStruct`` stand-ins)."""
    b, s = shape.global_batch, shape.seq_len
    dt = cfg.params_dtype
    if shape.kind == "decode":
        # decode inputs: one token per sequence (cache specs built separately)
        if cfg.family == "audio":
            raise ValueError("encoder-only arch has no decode step")
        return {"tokens": _spec((b, 1), torch.int32)}
    if cfg.family == "audio":
        return {"features": _spec((b, s, cfg.d_model), dt),
                "mask": _spec((b, s), torch.bool),
                "targets": _spec((b, s), torch.int32)}
    if cfg.family == "vlm":
        s_img = cfg.frontend_tokens
        return {"tokens": _spec((b, s - s_img), torch.int32),
                "image_embeds": _spec((b, s_img, cfg.d_model), dt)}
    return {"tokens": _spec((b, s), torch.int32)}


def abstract_params(model: Model) -> dict:
    """The parameter tree as meta tensors, drawn from nothing and not
    registered on the model."""
    return model.init(None, device=META)


def abstract_opt_state(abstract_p) -> AdamWState:
    """AdamW's state for ``abstract_p``: float32 moments and the int32
    step, as meta tensors."""
    st = adamw_init(abstract_p)
    return AdamWState(step=_spec((), torch.int32), mu=st.mu, nu=st.nu)


def abstract_cache(model: Model, batch: int, max_len: int) -> dict:
    return model.init_cache(batch, max_len, device=META)


def demo_batch(cfg: ModelConfig, batch: int, seq: int, seed: int = 0,
               device=None):
    """A random batch of the model's inputs, the JAX package's values for
    the same seed (smoke tests / examples)."""
    dev = device_lib.resolve(device)
    dt = cfg.params_dtype
    rng = np.random.default_rng(seed)

    def tensor(a, dtype):
        return torch.as_tensor(a).to(dtype).to(dev)

    if cfg.family == "audio":
        return {
            "features": tensor(rng.standard_normal((batch, seq, cfg.d_model)), dt),
            "mask": tensor(rng.random((batch, seq)) < max(cfg.mask_ratio, 0.08),
                           torch.bool),
            "targets": tensor(rng.integers(0, cfg.vocab_size, (batch, seq)),
                              torch.int32),
        }
    if cfg.family == "vlm":
        s_img = cfg.frontend_tokens
        return {
            "tokens": tensor(rng.integers(0, cfg.vocab_size, (batch, seq - s_img)),
                             torch.int32),
            "image_embeds": tensor(
                rng.standard_normal((batch, s_img, cfg.d_model)) * 0.02, dt),
        }
    return {"tokens": tensor(rng.integers(0, cfg.vocab_size, (batch, seq)),
                             torch.int32)}


# ---------------------------------------------------------------------------
# step functions
# ---------------------------------------------------------------------------

def _grads(loss, leaves) -> list:
    # A leaf the loss does not reach (hubert's embedding table) gets zeros,
    # as under jax.grad.
    return list(torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True))


def _microbatch(v: torch.Tensor, i: int, n: int) -> torch.Tensor:
    """Rows of microbatch ``i`` of ``n``: the i-th consecutive slice of a
    plain batch; of a DTensor batch sharded over its rows, the i-th slice
    of each device's own rows (no collective; every row still falls in
    exactly one microbatch, so the mean gradient is the same)."""
    if isinstance(v, DTensor):
        loc = v.to_local()
        if loc.shape[0] % n:
            raise ValueError(f"a device's {loc.shape[0]} rows do not split "
                             f"into {n} microbatches")
        size = loc.shape[0] // n
        return DTensor.from_local(loc[i * size:(i + 1) * size], v.device_mesh,
                                  v.placements, run_check=False)
    size = v.shape[0] // n
    return v[i * size:(i + 1) * size]


def make_train_step(model: Model, *, lr: float = 3e-4, grad_clip: float = 1.0,
                    weight_decay: float = 0.1, remat_policy: str = "nothing",
                    lr_fn=None, microbatch: int = 1):
    """``(params, opt_state, batch, step) -> (params, opt_state, metrics)``,
    the parameters and the optimizer's moments updated in place.
    ``params`` are the model's registered parameters (``init_params``,
    ``init_train_state`` or ``model.load_params``), which take gradients.

    ``microbatch > 1`` splits the batch into that many consecutive slices
    (the JAX package's reshape; of a DTensor batch, each device's rows
    split locally: :func:`_microbatch`), takes each slice's gradients in turn,
    accumulates them in float32 and divides, then casts to the parameters'
    dtypes.  ``metrics`` holds ``loss`` (a float32 0-d tensor on the
    device), ``lr`` (the step's rate) and ``grad_norm`` (the clip's global
    norm before clipping, a 0-d tensor)."""

    def train_step(params, opt_state, batch, step):
        def loss_fn(b):
            return model.loss(params, b, remat_policy=remat_policy)

        leaves = tree_leaves(params)
        if microbatch > 1:
            n = next(iter(batch.values())).shape[0]
            if n % microbatch:
                raise ValueError(f"batch {n} does not split into {microbatch} "
                                 "microbatches")
            acc = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
            losses = []
            for i in range(microbatch):
                mb = {k: _microbatch(v, i, microbatch) for k, v in batch.items()}
                loss_i = loss_fn(mb)
                for a, g in zip(acc, _grads(loss_i, leaves)):
                    a.add_(g.float())
                losses.append(loss_i.detach())
            grads = [(a / microbatch).to(p.dtype) for a, p in zip(acc, leaves)]
            del acc
            loss = torch.stack(losses).mean()
        else:
            loss = loss_fn(batch)
            grads = _grads(loss, leaves)
            loss = loss.detach()
        grads = tree_unflatten(params, grads)
        cur_lr = lr_fn(step) if lr_fn is not None else lr
        gnorm = global_norm(grads)
        params, opt_state = adamw_update(
            grads, opt_state, params, lr=cur_lr, weight_decay=weight_decay,
            grad_clip_norm=grad_clip, gnorm=gnorm)
        return params, opt_state, {"loss": loss, "lr": cur_lr, "grad_norm": gnorm}

    return train_step


def make_prefill_step(model: Model):
    """Forward only: last-position logits of the full prompt (serving
    prefill)."""

    def prefill_step(params, batch):
        hidden = model.forward(params, batch)
        return model._logits(params, hidden[:, -1:]).float()

    return prefill_step


def make_encode_step(model: Model):
    """Encoder-only forward (hubert): per-frame logits."""

    def encode_step(params, batch):
        hidden = model.forward(params, batch)
        return model._logits(params, hidden).float()

    return encode_step


def make_decode_step(model: Model):
    def decode_step(params, cache, tokens, pos):
        return model.decode_step(params, cache, tokens, pos)

    return decode_step


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def init_params(model: Model, seed: int = 0, device=None) -> dict:
    """Draw the model's parameters on ``device`` (``cuda`` unless given)
    from a generator seeded with ``seed``, register them on the model and
    return the tree.  The values are the port's own, not the JAX
    package's."""
    dev = device_lib.resolve(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return model.load_params(model.init(gen))


def init_train_state(model: Model, seed: int = 0, device=None):
    """``(params, opt_state)``: :func:`init_params` and zeroed AdamW
    moments beside them."""
    params = init_params(model, seed, device)
    return params, adamw_init(params)


def _to_tensor(a, dev) -> torch.Tensor:
    a = np.array(a, copy=True, order="C")   # owned and writable
    if a.dtype.name == "bfloat16":          # ml_dtypes' numpy dtype
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(dev)
    return torch.from_numpy(a).to(dev)


def params_from_jax(tree: dict, device=None) -> dict:
    """The JAX package's parameter tree (a nested dict of numpy arrays, e.g.
    ``jax.tree.map(np.asarray, init_params(model))``) as the port's tree on
    ``device``, dtypes kept.  Register it with ``model.load_params``."""
    dev = device_lib.resolve(device)

    def carry(t):
        return {k: carry(v) if isinstance(v, dict) else _to_tensor(v, dev)
                for k, v in t.items()}
    return carry(tree)


def flatten_params(model: Model) -> dict[str, torch.Tensor]:
    """The model's parameters under the JAX package's checkpoint keys
    (``layers/attn/w_q_in``), in its ``tree_flatten_with_path`` order."""
    return {"/".join(path): p for path, p in tree_items(model.params)}
