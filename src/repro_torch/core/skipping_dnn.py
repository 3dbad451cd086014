"""The paper's lightweight *skipping DNN* enhancer (§3.2.2, Fig. 8).

Ten conv layers — input conv, four stride-2 down-samplings, four stride-2
up-samplings with skip concatenations, output conv — 3,073 parameters at
``c_in=1``.  Layouts are the JAX package's: activations NHWC, weights HWIO
(``w[dy, dx, cin, cout]``), parameters a tree ``{layer: {"b", "w"}}``, so
weights carry across both ways (:func:`params_from_jax`,
``core.archive.pack_weights``).

* ``conv_in``, ``down1..4`` and ``conv_out`` run through the hand-written
  ``conv2d3x3`` kernel (ReLU fused where the layer has one), differentiable
  through its autograd function.
* ``up1..4`` are stride-2 SAME transpose convs computed as their sub-pixel
  decomposition with the *unflipped* kernel, as the reference's ``_deconv``
  — not ``ConvTranspose2d``'s weight convention.  Plain PyTorch; the JAX
  package computes them outside any kernel too.
* The input is edge-padded to a multiple of 16 and the output cropped back.
* The regulated head is ``2σ(z) − 1`` (balanced 2× regulation, Fig. 6B).

:func:`forward_stacked` runs F enhancers at once, one per field, with a
leading field axis on the parameters (:func:`stack_params`) and the input
— the JAX package's ``jax.vmap`` of ``forward`` over fields in its batched
engine.  Its convs are grouped launches (``conv3x3_grouped``, each field's
sums in the single-field order) and its transposed convs run field by
field; the rest is elementwise or a copy.  So it sums every value of every
field in the order of the single-field forward, and so does its gradient.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn

from .. import device as device_lib
from ..kernels.conv2d3x3 import conv3x3, conv3x3_grouped

LAYERS = ("conv_in", "down1", "down2", "down3", "down4",
          "up1", "up2", "up3", "up4", "conv_out")


@dataclasses.dataclass(frozen=True)
class SkippingDNNConfig:
    c_in: int = 1                     # 1 = single field, >1 = cross-field
    widths: tuple = (4, 4, 6, 6, 8)   # conv_in + four encoder stages
    regulated: bool = True
    skip: bool = True


def layer_channels(cfg: SkippingDNNConfig) -> dict[str, tuple[int, int]]:
    c0, c1, c2, c3, c4 = cfg.widths
    if cfg.skip:
        up_in, out_in = (c4, c3 + c3, c2 + c2, c1 + c1), c1 + c0
    else:
        up_in, out_in = (c4, c3, c2, c1), c1
    return {"conv_in": (cfg.c_in, c0), "down1": (c0, c1), "down2": (c1, c2),
            "down3": (c2, c3), "down4": (c3, c4), "up1": (up_in[0], c3),
            "up2": (up_in[1], c2), "up3": (up_in[2], c1),
            "up4": (up_in[3], c1), "conv_out": (out_in, 1)}


def init_params(cfg: SkippingDNNConfig, generator: torch.Generator | None = None
                ) -> dict:
    """He-normal weights, zero biases, drawn on the host from ``generator``
    (the same tree on every device)."""
    out = {}
    for name, (cin, cout) in layer_channels(cfg).items():
        w = torch.randn((3, 3, cin, cout), generator=generator,
                        dtype=torch.float32) * math.sqrt(2.0 / (9 * cin))
        out[name] = {"b": torch.zeros(cout), "w": w}
    return out


def params_from_jax(tree) -> dict:
    """A parameter tree of numpy arrays (e.g. the JAX package's
    ``init_params`` or an archive's unpacked weights) as float32 tensors."""
    missing = set(LAYERS) - set(tree)
    if missing:
        raise KeyError(f"parameter tree lacks layers {sorted(missing)}")
    return {name: {k: torch.from_numpy(np.array(tree[name][k], np.float32))
                   for k in ("b", "w")} for name in LAYERS}


def stack_params(params_list) -> dict:
    """Stack F same-structure parameter trees into one tree with a leading
    field axis: the layout of :func:`forward_stacked`."""
    return {name: {k: torch.stack([p[name][k] for p in params_list])
                   for k in ("b", "w")} for name in LAYERS}


def unstack_params(stacked, num_fields: int) -> list[dict]:
    """Inverse of :func:`stack_params`: per-field trees (views, no copy)."""
    return [{name: {k: stacked[name][k][f] for k in ("b", "w")}
             for name in LAYERS} for f in range(num_fields)]


def tree_leaves(tree) -> list:
    """The tensors of a parameter tree in one fixed order (layer, then
    ``b``, ``w``)."""
    return [tree[name][k] for name in LAYERS for k in ("b", "w")]


def param_count(params) -> int:
    """Number of weights of an enhancer: an :class:`nn.Module` or a
    parameter tree (tensors or numpy arrays)."""
    if isinstance(params, nn.Module):
        return sum(p.numel() for p in params.parameters())
    return sum(int(np.prod(p.shape)) for layer in params.values()
               for p in layer.values())


def _deconv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Stride-2 SAME 3×3 transpose conv via sub-pixel decomposition: output
    row ``2i+py`` only sees kernel taps ``dy ∈ {py, py+2}``, so each parity
    plane is a small tap accumulation on the input grid; the four planes are
    interleaved back."""
    n, h, wd, _ = x.shape
    xp = nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    rows = []
    for py in range(2):
        ytaps = [(py, py - 1)] + ([(py + 2, py)] if py + 2 <= 2 else [])
        cols = []
        for px in range(2):
            xtaps = [(px, px - 1)] + ([(px + 2, px)] if px + 2 <= 2 else [])
            acc = None
            for dy, my in ytaps:
                for dx, mx in xtaps:
                    win = xp[:, my + 1:my + 1 + h, mx + 1:mx + 1 + wd, :]
                    t = torch.matmul(win, w[dy, dx])
                    acc = t if acc is None else acc + t
            cols.append(acc)
        rows.append(torch.stack(cols, dim=3))           # [n, h, w, px, c]
    out = torch.stack(rows, dim=2)                       # [n, h, py, w, px, c]
    return out.reshape(n, 2 * h, 2 * wd, w.shape[-1]) + b


def _edge_pad(x: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """Replicate the last row/column of an NHWC batch ``ph``/``pw`` times."""
    _, h, w, _ = x.shape
    iy = torch.arange(h + ph, device=x.device).clamp_(max=h - 1)
    ix = torch.arange(w + pw, device=x.device).clamp_(max=w - 1)
    return x.index_select(1, iy).index_select(2, ix)


def _net(params, x: torch.Tensor, conv, deconv, *, regulated: bool,
         skip: bool) -> torch.Tensor:
    """The ten layers on a batch ``x [B, H, W, C_in]``: edge pad to a
    multiple of 16, the layers, the head, the crop.  ``conv(t, w, b, *,
    stride, relu)`` and ``deconv(t, w, b)`` compute one layer."""
    _, h, w, _ = x.shape
    ph, pw = (-h) % 16, (-w) % 16
    if ph or pw:
        x = _edge_pad(x, ph, pw)

    def down(t, name, stride=1, relu=True):
        p = params[name]
        return conv(t, p["w"], p["b"], stride=stride, relu=relu)

    def up(t, name, feat):
        u = torch.relu(deconv(t, params[name]["w"], params[name]["b"]))
        return torch.cat([u, feat], dim=-1) if skip else u

    f0 = down(x, "conv_in")                   # H
    f1 = down(f0, "down1", stride=2)          # H/2
    f2 = down(f1, "down2", stride=2)          # H/4
    f3 = down(f2, "down3", stride=2)          # H/8
    f4 = down(f3, "down4", stride=2)          # H/16
    u = up(f4, "up1", f3)                     # H/8
    u = up(u, "up2", f2)                      # H/4
    u = up(u, "up3", f1)                      # H/2
    u = up(u, "up4", f0)                      # H
    z = down(u, "conv_out", relu=False)       # [B, H, W, 1]
    out = 2.0 * torch.sigmoid(z) - 1.0 if regulated else z
    if ph or pw:
        out = out[:, :h, :w, :]
    return out


def forward(params, x: torch.Tensor, *, regulated: bool = True,
            skip: bool = True) -> torch.Tensor:
    """``x [N, H, W, C_in]`` normalized decompressed slices ->
    ``[N, H, W, 1]`` normalized residual prediction."""
    return _net(params, x, conv3x3, _deconv, regulated=regulated, skip=skip)


def apply(params, x: torch.Tensor, cfg: SkippingDNNConfig) -> torch.Tensor:
    """:func:`forward` with ``cfg``'s regulation and skip connections."""
    return forward(params, x, regulated=cfg.regulated, skip=cfg.skip)


def forward_stacked(params, x: torch.Tensor, *, regulated: bool = True,
                    skip: bool = True) -> torch.Tensor:
    """F enhancers at once: ``params`` a stacked tree (:func:`stack_params`),
    ``x [F, N, H, W, C_in]`` each field's normalized slices ->
    ``[F, N, H, W, 1]``."""
    nf, n, h, w, c = x.shape

    def deconv(t, wt, b):
        # Field by field, so each field's GEMMs and bias sum are a
        # single-field step's: a batched matmul over the fields would sum
        # the weight gradient's N·h·w terms in another order, and cuBLAS
        # runs its batched form at these shapes without splitting that sum
        # (245 ms a stacked step of three 512² fields on an H100, against
        # 3 ms for three single-field steps).
        fields = t.reshape(nf, n, *t.shape[1:]).unbind(0)
        return torch.cat([_deconv(tf, wt[f], b[f]) for f, tf in enumerate(fields)])

    out = _net(params, x.reshape(nf * n, h, w, c), conv3x3_grouped, deconv,
               regulated=regulated, skip=skip)
    return out.reshape(nf, n, h, w, 1)


class _Layer(nn.Module):
    def __init__(self, w: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)


class SkippingDNN(nn.Module):
    """The enhancer as a module on ``device`` (``cuda`` unless given);
    ``params`` is a tree of tensors (default: :func:`init_params` from
    ``generator``)."""

    def __init__(self, cfg: SkippingDNNConfig, params: dict | None = None, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        device = device_lib.resolve(device)
        self.cfg = cfg
        params = init_params(cfg, generator) if params is None else params
        for name, (cin, cout) in layer_channels(cfg).items():
            w = torch.as_tensor(params[name]["w"], dtype=torch.float32)
            b = torch.as_tensor(params[name]["b"], dtype=torch.float32)
            if tuple(w.shape) != (3, 3, cin, cout) or tuple(b.shape) != (cout,):
                raise ValueError(f"{name}: want w (3,3,{cin},{cout}) and b "
                                 f"({cout},), got {tuple(w.shape)} and "
                                 f"{tuple(b.shape)}")
            self.add_module(name, _Layer(w.clone().to(device),
                                         b.clone().to(device)))

    def tree(self) -> dict:
        """The parameters as ``{layer: {"b", "w"}}`` (shared, not copied)."""
        return {name: {"b": getattr(self, name).b, "w": getattr(self, name).w}
                for name in LAYERS}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return forward(self.tree(), x, regulated=self.cfg.regulated,
                       skip=self.cfg.skip)
