"""3×3 conv + bias (+ ReLU) over NHWC float32: the ``csrc/conv2d3x3.cu``
kernel, its plain PyTorch version, and the autograd function around both.

Replaces the Pallas TPU kernel ``repro/kernels/conv2d3x3.py::conv2d3x3``.
The device of the tensors decides the route: a CUDA tensor launches the
hand-written kernel (or raises), a CPU tensor takes :func:`conv2d3x3_plain`.
Nothing probes and nothing falls back.

Layouts are the JAX package's: ``x`` is ``(N, H, W, Cin)``, ``w`` is
``(3, 3, Cin, Cout)`` (HWIO), ``b`` is ``(Cout,)``.  SAME padding uses XLA's
arithmetic (``lo = total // 2``): at stride 2 on an even size the padding is
``lo=0, hi=1``, which is not ``torch.nn.functional.conv2d(padding=1)``.

The gradient is plain PyTorch: the nine-tap formulation transposed (dgrad
scatters ``g @ w[dy, dx].T`` back onto the padded input, wgrad contracts each
shifted window with ``g``), with the ReLU mask read from the saved output.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

MAX_CIN = 16
MAX_COUT = 8

# Kernel launches made by :func:`conv2d3x3` (CUDA route only).
launches = 0

_lib = None


def same_pads(size: int, stride: int) -> tuple[int, int, int]:
    """XLA SAME padding for a 3-tap window: ``(out, lo, hi)``."""
    out = (size + stride - 1) // stride
    total = max((out - 1) * stride + 3 - size, 0)
    lo = total // 2
    return out, lo, total - lo


def _taps(x: torch.Tensor, stride: int):
    """Zero-padded input and, in tap order ``(dy, dx)``, the indexer of each
    shifted strided window — the formulation of the reference's
    ``_conv_taps``."""
    _, h, wd, _ = x.shape
    ho, ylo, yhi = same_pads(h, stride)
    wo, xlo, xhi = same_pads(wd, stride)
    xp = F.pad(x, (0, 0, xlo, xhi, ylo, yhi))
    taps = [((dy, dx), (slice(None),
                        slice(dy, dy + (ho - 1) * stride + 1, stride),
                        slice(dx, dx + (wo - 1) * stride + 1, stride)))
            for dy in range(3) for dx in range(3)]
    return xp, taps, (ylo, xlo)


def conv2d3x3_plain(x, w, b, *, stride: int = 1, relu: bool = True):
    """Plain PyTorch version: nine shifted GEMMs accumulated in tap order."""
    xp, taps, _ = _taps(x, stride)
    acc = None
    for (dy, dx), win in taps:
        t = torch.matmul(xp[win], w[dy, dx])
        acc = t if acc is None else acc + t
    y = acc + b
    return torch.relu(y) if relu else y


def _check(x, w, b, stride):
    if x.dim() != 4 or w.shape[:2] != (3, 3) or w.dim() != 4:
        raise ValueError(f"want x (N,H,W,Cin) and w (3,3,Cin,Cout), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    cin, cout = w.shape[2], w.shape[3]
    if x.shape[-1] != cin or tuple(b.shape) != (cout,):
        raise ValueError(f"channel mismatch: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}, b {tuple(b.shape)}")
    if not 1 <= cin <= MAX_CIN or not 1 <= cout <= MAX_COUT:
        raise ValueError(f"kernel takes 1..{MAX_CIN} input and 1..{MAX_COUT} "
                         f"output channels, got {cin} -> {cout}")
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    if {t.dtype for t in (x, w, b)} != {torch.float32}:
        raise TypeError("conv2d3x3 takes float32 tensors")
    if not (x.device == w.device == b.device):
        raise ValueError("x, w and b must share one device")


def _load():
    global _lib
    if _lib is None:
        lib = _build.load("conv2d3x3")
        lib.conv2d3x3_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 12 + [ctypes.c_void_p])
        lib.conv2d3x3_launch.restype = ctypes.c_int
        lib.conv2d3x3_error_string.argtypes = [ctypes.c_int]
        lib.conv2d3x3_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def conv2d3x3(x, w, b, *, stride: int = 1, relu: bool = True) -> torch.Tensor:
    """Forward of the 3×3 conv: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    global launches
    _check(x, w, b, stride)
    if x.device.type == "cpu":
        return conv2d3x3_plain(x, w, b, stride=stride, relu=relu)
    if x.device.type != "cuda":
        raise ValueError(f"conv2d3x3 runs on cuda or cpu, not {x.device}")
    if not (x.is_contiguous() and w.is_contiguous() and b.is_contiguous()):
        raise ValueError("conv2d3x3 takes contiguous tensors")
    n, h, wd, cin = x.shape
    cout = w.shape[-1]
    ho, ylo, _ = same_pads(h, stride)
    wo, xlo, _ = same_pads(wd, stride)
    y = torch.empty((n, ho, wo, cout), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y
    lib = _load()
    err = lib.conv2d3x3_launch(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), n, h, wd, cin,
        cout, ho, wo, stride, ylo, xlo, int(relu), x.device.index or 0,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError("conv2d3x3 launch failed: "
                           + lib.conv2d3x3_error_string(err).decode())
    launches += 1
    return y


class Conv3x3(torch.autograd.Function):
    """Autograd around :func:`conv2d3x3`: the kernel forward, a plain
    PyTorch backward."""

    @staticmethod
    def forward(ctx, x, w, b, stride: int, relu: bool):
        y = conv2d3x3(x, w, b, stride=stride, relu=relu)
        ctx.save_for_backward(x, w, y)
        ctx.stride, ctx.relu = stride, relu
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, y = ctx.saved_tensors
        if ctx.relu:
            g = g * (y > 0)
        cout = w.shape[-1]
        n, h, wd, cin = x.shape
        xp, taps, (ylo, xlo) = _taps(x, ctx.stride)
        gm = g.reshape(-1, cout)
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        dw = torch.empty_like(w) if need_w else None
        dxp = torch.zeros_like(xp) if need_x else None
        for (dy, dx), win in taps:
            if need_w:
                dw[dy, dx] = xp[win].reshape(-1, cin).t() @ gm
            if need_x:
                dxp[win] += g @ w[dy, dx].t()
        dx_ = dxp[:, ylo:ylo + h, xlo:xlo + wd, :] if need_x else None
        db = gm.sum(0) if need_b else None
        return dx_, dw, db, None, None


def conv3x3(x, w, b, *, stride: int = 1, relu: bool = True) -> torch.Tensor:
    """Differentiable 3×3 conv (the skipping DNN's conv layers)."""
    return Conv3x3.apply(x.contiguous(), w.contiguous(), b.contiguous(),
                         stride, relu)
