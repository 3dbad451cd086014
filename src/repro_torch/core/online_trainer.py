"""Compression-time online learning of the skipping enhancer (§3.2).

A 3-D field is sliced along one axis into single-channel images: the input
is the normalized decompressed slice (plus aux-field channels for
cross-field learning), the target is the residual ``X − X'`` divided by the
error bound, which the conventional stage keeps in ``[−1, 1]``.  Dataset
construction and the normalization stats stay numpy on the host, as in the
JAX package: the stats are part of the archive and the decoder must
rebuild the identical input tensor from them.

Training is a Python loop over epochs and steps on the device: Adam with the
reference's formula, cosine-annealed learning rate, mean squared error.
The batch order comes from a seeded ``torch.Generator`` — or, for parity
runs, from a precomputed ``[epochs, steps, batch]`` index schedule such as
the JAX package's ``online_trainer.epoch_batches``.

:func:`train_stacked` trains the enhancers of a group of fields at once
(the batched engine's stacked strategy, the JAX package's
``batched_engine._epoch_vmapped``): parameters and Adam's state carry a
leading field axis, each step is one stacked forward and backward, and the
loss is a mean per field.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..optim import AdamW, cosine_schedule
from . import skipping_dnn
from .skipping_dnn import SkippingDNN


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    epochs: int = 100          # paper default
    batch: int = 10            # paper default
    lr: float = 1e-2           # paper default, cosine annealed
    seed: int = 0


def normalize_stats(decomp: np.ndarray) -> tuple[float, float]:
    """Decoder-reproducible normalization constants (decompressed data only)."""
    d = np.asarray(decomp, dtype=np.float64)
    mu = float(d.mean())
    sd = float(d.std())
    return mu, sd if sd > 1e-30 else 1.0


def make_dataset(decomp: np.ndarray, orig: np.ndarray | None, eb: float,
                 aux: list[np.ndarray] | None = None, slice_axis: int = 0,
                 stats: list[tuple[float, float]] | None = None):
    """Slices -> ``(inputs [N,H,W,C], targets [N,H,W,1] | None, stats)``.

    ``orig=None`` builds inference inputs only (decoder side); ``stats``
    lets the decoder reuse the encoder's stored constants.
    """
    chans = [np.asarray(decomp)] + [np.asarray(a) for a in (aux or [])]
    if stats is None:
        stats = [normalize_stats(c) for c in chans]
    normed = []
    for c, (mu, sd) in zip(chans, stats):
        c = np.moveaxis(c.astype(np.float32), slice_axis, 0)
        normed.append((c - np.float32(mu)) / np.float32(sd))
    inputs = np.stack(normed, axis=-1)
    targets = None
    if orig is not None:
        o = np.moveaxis(np.asarray(orig, dtype=np.float64), slice_axis, 0)
        d = np.moveaxis(np.asarray(decomp, dtype=np.float64), slice_axis, 0)
        targets = ((o - d) / eb).astype(np.float32)[..., None]
    return inputs, targets, stats


def batch_loss(model: SkippingDNN, xb: torch.Tensor, yb: torch.Tensor
               ) -> torch.Tensor:
    """Mean squared error of the normalized residual prediction."""
    return torch.mean(torch.square(model(xb) - yb))


def train_epochs(model: SkippingDNN, inputs, targets, cfg: TrainConfig, *,
                 schedule=None, on_epoch=None) -> torch.Tensor:
    """Train ``model`` in place for ``cfg.epochs``; returns the per-epoch
    mean losses ``[epochs]``, left on the device.  ``inputs``/``targets``
    are host arrays or tensors; they move to the model's device once.
    ``schedule`` optionally fixes the batch indices, ``[epochs, steps,
    batch]``.  ``on_epoch`` is an optional host callback ``(epoch, model,
    loss)`` after every epoch (the telemetry sample-PSNR hook), which reads
    each epoch's loss on the host."""
    device = next(model.parameters()).device
    xs = torch.as_tensor(inputs, device=device)
    ys = torch.as_tensor(targets, device=device)
    n = xs.shape[0]
    batch = min(cfg.batch, n)
    steps = max(1, n // batch)
    if schedule is not None and tuple(np.shape(schedule)) != (cfg.epochs, steps, batch):
        raise ValueError(f"schedule must be [{cfg.epochs}, {steps}, {batch}], "
                         f"got {tuple(np.shape(schedule))}")
    lr_fn = cosine_schedule(cfg.lr, steps * cfg.epochs)
    params = list(model.parameters())
    opt = AdamW(params)
    gen = torch.Generator().manual_seed(cfg.seed)
    history = torch.empty(cfg.epochs, device=device)
    for e in range(cfg.epochs):
        if schedule is None:
            idx = torch.randperm(n, generator=gen)[:steps * batch]
        else:
            idx = torch.from_numpy(np.array(schedule[e], dtype=np.int64))
        idx = idx.reshape(steps, batch).to(device)
        losses = torch.empty(steps, device=device)
        for s in range(steps):
            loss = batch_loss(model, xs.index_select(0, idx[s]),
                              ys.index_select(0, idx[s]))
            grads = torch.autograd.grad(loss, params)
            opt.step(grads, lr=lr_fn(e * steps + s))
            losses[s] = loss.detach()
        history[e] = losses.mean()
        if on_epoch is not None:
            on_epoch(e, model, float(history[e]))
    return history


def train(model: SkippingDNN, inputs, targets, cfg: TrainConfig, *,
          schedule=None, on_epoch=None) -> list[float]:
    """:func:`train_epochs`, its per-epoch mean losses read on the host."""
    return [float(v) for v in train_epochs(
        model, inputs, targets, cfg, schedule=schedule,
        on_epoch=on_epoch).cpu().tolist()]


def stacked_batch_loss(params, xb: torch.Tensor, yb: torch.Tensor, *,
                       regulated: bool = True, skip: bool = True
                       ) -> torch.Tensor:
    """Mean squared error of each field, ``[F]``, for stacked ``xb [F, B,
    H, W, C]`` and ``yb [F, B, H, W, 1]``.  Each field's mean is
    :func:`batch_loss`'s arithmetic on that field's own tensors, so it
    sums in the single-field order."""
    pred = skipping_dnn.forward_stacked(params, xb, regulated=regulated,
                                        skip=skip)
    return torch.stack([torch.mean(torch.square(pred[f] - yb[f]))
                        for f in range(pred.shape[0])])


def train_stacked(params, inputs, targets, cfg: TrainConfig, *,
                  n_valid=None, regulated: bool = True, skip: bool = True,
                  schedule=None) -> torch.Tensor:
    """Train F enhancers at once for ``cfg.epochs``, in place: ``params`` is
    a stacked tree (:func:`skipping_dnn.stack_params`) of leaf tensors on
    the device, ``inputs [F, N, H, W, C]`` and ``targets [F, N, H, W, 1]``
    padded to the group's largest slice count N.  ``n_valid`` gives each
    field's own count (default N): one permutation a epoch is shared, and
    field f takes ``idx % n_valid[f]``.  The cosine horizon is ``steps *
    epochs`` of the padded count, for the whole group.  The batch order is
    the serial trainer's (a fresh ``Generator(cfg.seed)``), or
    ``schedule [epochs, steps, batch]``.  Returns the per-epoch mean losses
    ``[epochs, F]``, left on the device."""
    leaves = skipping_dnn.tree_leaves(params)
    device = leaves[0].device
    xs = torch.as_tensor(inputs, device=device)
    ys = torch.as_tensor(targets, device=device)
    nf, n = xs.shape[:2]
    batch = min(cfg.batch, n)
    steps = max(1, n // batch)
    if schedule is not None and tuple(np.shape(schedule)) != (cfg.epochs, steps, batch):
        raise ValueError(f"schedule must be [{cfg.epochs}, {steps}, {batch}], "
                         f"got {tuple(np.shape(schedule))}")
    counts = torch.as_tensor(n_valid if n_valid is not None else [n] * nf,
                             dtype=torch.int64, device=device)
    # Row of field f's slice i in the flattened [F*N] batch of slices.
    base = (torch.arange(nf, device=device) * n)[:, None]
    xs_flat = xs.reshape(nf * n, *xs.shape[2:])
    ys_flat = ys.reshape(nf * n, *ys.shape[2:])
    lr_fn = cosine_schedule(cfg.lr, steps * cfg.epochs)
    opt = AdamW(leaves)
    gen = torch.Generator().manual_seed(cfg.seed)
    history = torch.empty((cfg.epochs, nf), device=device)
    for e in range(cfg.epochs):
        if schedule is None:
            idx = torch.randperm(n, generator=gen)[:steps * batch]
        else:
            idx = torch.from_numpy(np.array(schedule[e], dtype=np.int64))
        idx = idx.reshape(steps, batch).to(device)
        losses = torch.empty((nf, steps), device=device)
        for s in range(steps):
            rows = (idx[s][None, :] % counts[:, None] + base).reshape(-1)
            xb = xs_flat.index_select(0, rows).reshape(nf, batch, *xs.shape[2:])
            yb = ys_flat.index_select(0, rows).reshape(nf, batch, *ys.shape[2:])
            loss = stacked_batch_loss(params, xb, yb, regulated=regulated,
                                      skip=skip)
            grads = torch.autograd.grad(loss.sum(), leaves)
            opt.step(grads, lr=lr_fn(e * steps + s))
            losses[:, s] = loss.detach()
        for f in range(nf):
            # Each field's mean over its contiguous row: the serial
            # trainer's reduction of its [steps] losses.
            history[e, f] = losses[f].mean()
    return history


@torch.no_grad()
def predict_residual(model: SkippingDNN, inputs, batch: int = 64) -> torch.Tensor:
    """Predicted normalized residual of every slice, ``[N, H, W]`` on the
    model's device, in chunks of ``batch`` slices as the reference runs it."""
    device = next(model.parameters()).device
    xs = torch.as_tensor(inputs, device=device)
    outs = [model(xs[i:i + batch])[..., 0] for i in range(0, xs.shape[0], batch)]
    return torch.cat(outs, dim=0) if len(outs) > 1 else outs[0]
