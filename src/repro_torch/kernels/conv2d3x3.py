"""3×3 conv + bias (+ ReLU) over NHWC float32, forward and backward: the
``csrc/conv2d3x3.cu`` and ``csrc/conv2d3x3_bwd.cu`` kernels, their plain
PyTorch versions, and the autograd function around both.

Replaces the Pallas TPU kernel ``repro/kernels/conv2d3x3.py::conv2d3x3``;
the JAX package takes its gradient by XLA's autodiff of the same nine-tap
sum (``repro/core/skipping_dnn.py::_conv_taps``).  The device of the
tensors decides the route: a CUDA tensor launches the hand-written kernels
(or raises), a CPU tensor takes :func:`conv2d3x3_plain`,
:func:`conv2d3x3_dgrad_plain` and :func:`conv2d3x3_wgrad_plain`.  Nothing
probes and nothing falls back.

Layouts are the JAX package's: ``x`` is ``(N, H, W, Cin)``, ``w`` is
``(3, 3, Cin, Cout)`` (HWIO), ``b`` is ``(Cout,)``.  SAME padding uses XLA's
arithmetic (``lo = total // 2``): at stride 2 on an even size the padding is
``lo=0, hi=1``, which is not ``torch.nn.functional.conv2d(padding=1)``.

The backward reads the forward's saved output ``y`` for the ReLU mask
(``g' = g`` where ``y > 0``, else 0).  On CUDA it is one launch: dgrad
blocks (none when the input needs no gradient) and wgrad blocks in one
grid, the last wgrad block adding the per-block partial sums; at the
stride-2 layers whose wgrad blocks fill an SM, dgrad is a launch of its
own before it (``csrc/conv2d3x3_bwd.cu``).

A ``FakeTensor`` or meta call takes a shape-only branch: empty outputs of
the kernel's shapes, and the kernel's operations and bound bytes told to
an operation counter (``kernels.cost``), as a launch tells them.

Grouped calls (:func:`conv2d3x3_grouped`, :func:`conv2d3x3_bwd_grouped`,
:class:`Conv3x3Grouped`) convolve F fields in one launch, each field with
its own weights: ``x`` is ``(F*N, H, W, Cin)`` field-major, ``w`` is
``(F, 3, 3, Cin, Cout)``, ``b`` is ``(F, Cout)``.  They replace the JAX
package's ``conv2d3x3`` under ``jax.vmap`` over fields (its stacked
training, ``repro/core/batched_engine.py::_epoch_vmapped``).  Field f's
output equals a single-field call on that field's slices byte for byte:
the same blocks sum it in the same order.  Their plain versions are the
single-field plain versions applied field by field.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build, cost

MAX_CIN = 16
MAX_COUT = 8
# Rows of wgrad's per-block partial sums: a call never runs more wgrad
# slots (kWgradRows in csrc/conv2d3x3_bwd.cu).
WGRAD_ROWS = 264

# Calls that launched their kernels (CUDA route only): forward calls, and
# backward calls (one launch each, or two with dgrad apart).
launches = 0
bwd_launches = 0
grouped_launches = 0
grouped_bwd_launches = 0

_lib = None
_bwd_lib = None
# The backward's ticket counters, one a field, per (device, stream): zero
# between calls, because the last block of each field wraps its ticket back
# to zero; grown when a call has more fields.
_group_tickets: dict[tuple[int, int], torch.Tensor] = {}


def same_pads(size: int, stride: int) -> tuple[int, int, int]:
    """XLA SAME padding for a 3-tap window: ``(out, lo, hi)``."""
    out = (size + stride - 1) // stride
    total = max((out - 1) * stride + 3 - size, 0)
    lo = total // 2
    return out, lo, total - lo


def fwd_flops(y_shape, cin: int) -> float:
    """Operations of a forward call: 2 a tap and input channel at every
    output value (``y_shape`` the output's, all fields)."""
    n, ho, wo, cout = y_shape
    return 2.0 * n * ho * wo * cout * 9 * cin


def _report_fwd(name: str, x, w, b, y) -> None:
    if not cost.listening():
        return
    cost.report(name, fwd_flops(y.shape, x.shape[-1]), cost.nbytes(x, w, b, y),
                x.dtype)


def _report_bwd(name: str, g, y, x, w, relu: bool, dx, dw, db) -> None:
    """dgrad (with ``dx``) and wgrad each as many operations as the
    forward; the bound's bytes: x, w, g (and y for the ReLU mask) read
    once, dx, dw, db written once."""
    if not cost.listening():
        return
    flops = fwd_flops(g.shape, x.shape[-1]) * (2 if dx is not None else 1)
    cost.report(name, flops,
                cost.nbytes(x, w, g, y if relu else None, dx, dw, db), x.dtype)


def _windows(ho: int, wo: int, stride: int):
    """In tap order ``(dy, dx)``, the indexer of each shifted strided window
    of the padded input — the formulation of the reference's
    ``_conv_taps``."""
    return [((dy, dx), (slice(None),
                        slice(dy, dy + (ho - 1) * stride + 1, stride),
                        slice(dx, dx + (wo - 1) * stride + 1, stride)))
            for dy in range(3) for dx in range(3)]


def _pad(x: torch.Tensor, stride: int) -> torch.Tensor:
    _, h, wd, _ = x.shape
    _, ylo, yhi = same_pads(h, stride)
    _, xlo, xhi = same_pads(wd, stride)
    return F.pad(x, (0, 0, xlo, xhi, ylo, yhi))


def conv2d3x3_plain(x, w, b, *, stride: int = 1, relu: bool = True):
    """Plain PyTorch version: nine shifted GEMMs accumulated in tap order."""
    xp = _pad(x, stride)
    ho, wo = same_pads(x.shape[1], stride)[0], same_pads(x.shape[2], stride)[0]
    acc = None
    for (dy, dx), win in _windows(ho, wo, stride):
        t = torch.matmul(xp[win], w[dy, dx])
        acc = t if acc is None else acc + t
    y = acc + b
    return torch.relu(y) if relu else y


def relu_mask(g, y, relu: bool):
    """``g'``: the output gradient through the fused ReLU (``g`` where the
    saved output ``y`` is positive, else 0); ``g`` itself without ReLU."""
    if not relu:
        return g
    return torch.where(y > 0, g, torch.zeros((), dtype=g.dtype, device=g.device))


def conv2d3x3_dgrad_plain(g, y, w, x_shape, *, stride: int = 1,
                          relu: bool = True):
    """Plain version of dgrad: the nine taps transposed, each window of the
    padded input taking ``g' @ w[dy, dx].T``, then the padding cropped."""
    g = relu_mask(g, y, relu)
    n, h, wd, cin = x_shape
    ho, ylo, yhi = same_pads(h, stride)
    wo, xlo, xhi = same_pads(wd, stride)
    dxp = g.new_zeros((n, h + ylo + yhi, wd + xlo + xhi, cin))
    for (dy, dx), win in _windows(ho, wo, stride):
        dxp[win] += g @ w[dy, dx].t()
    return dxp[:, ylo:ylo + h, xlo:xlo + wd, :]


def conv2d3x3_wgrad_plain(g, y, x, *, stride: int = 1, relu: bool = True):
    """Plain version of wgrad: ``(dw, db)``, each tap's window of the padded
    input contracted with ``g'`` over every output position."""
    g = relu_mask(g, y, relu)
    cin, cout = x.shape[-1], g.shape[-1]
    xp = _pad(x, stride)
    gm = g.reshape(-1, cout)
    dw = g.new_empty((3, 3, cin, cout))
    for (dy, dx), win in _windows(g.shape[1], g.shape[2], stride):
        dw[dy, dx] = xp[win].reshape(-1, cin).t() @ gm
    return dw, gm.sum(0)


def _check(x, w, b, stride):
    """Shapes, types and devices of a call; ``b`` is None for the backward."""
    if x.dim() != 4 or w.shape[:2] != (3, 3) or w.dim() != 4:
        raise ValueError(f"want x (N,H,W,Cin) and w (3,3,Cin,Cout), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    cin, cout = w.shape[2], w.shape[3]
    ts = (x, w) if b is None else (x, w, b)
    if x.shape[-1] != cin or (b is not None and tuple(b.shape) != (cout,)):
        raise ValueError(f"channel mismatch: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, b {None if b is None else tuple(b.shape)}")
    if not 1 <= cin <= MAX_CIN or not 1 <= cout <= MAX_COUT:
        raise ValueError(f"kernel takes 1..{MAX_CIN} input and 1..{MAX_COUT} "
                         f"output channels, got {cin} -> {cout}")
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    if {t.dtype for t in ts} != {torch.float32}:
        raise TypeError("conv2d3x3 takes float32 tensors")
    if len({t.device for t in ts}) != 1:
        raise ValueError("x, w and b must share one device")


def _cuda_operands(name: str, *ts: torch.Tensor) -> list[torch.Tensor]:
    """The operands of a launch: contiguous, 16-byte aligned (an offset view
    is copied), indexable in 32 bits."""
    dev = ts[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {dev}")
    out = []
    for t in ts:
        if not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous tensors")
        if t.numel() >= 2 ** 31:
            raise ValueError(f"{name} takes tensors of fewer than 2**31 elements")
        out.append(t.clone() if t.data_ptr() % 16 else t)
    return out


def _load():
    global _lib
    if _lib is None:
        lib = _build.load("conv2d3x3")
        lib.conv2d3x3_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 12 + [ctypes.c_void_p])
        lib.conv2d3x3_launch.restype = ctypes.c_int
        lib.conv2d3x3_grouped_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 13 + [ctypes.c_void_p])
        lib.conv2d3x3_grouped_launch.restype = ctypes.c_int
        lib.conv2d3x3_error_string.argtypes = [ctypes.c_int]
        lib.conv2d3x3_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _load_bwd():
    global _bwd_lib
    if _bwd_lib is None:
        lib = _build.load("conv2d3x3_bwd")
        lib.conv2d3x3_bwd_launch.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 14 + [ctypes.c_void_p])
        lib.conv2d3x3_bwd_launch.restype = ctypes.c_int
        lib.conv2d3x3_bwd_grouped_launch.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 15 + [ctypes.c_void_p])
        lib.conv2d3x3_bwd_grouped_launch.restype = ctypes.c_int
        lib.conv2d3x3_bwd_error_string.argtypes = [ctypes.c_int]
        lib.conv2d3x3_bwd_error_string.restype = ctypes.c_char_p
        lib.conv2d3x3_bwd_kernels.argtypes = [ctypes.c_int] * 7
        lib.conv2d3x3_bwd_kernels.restype = ctypes.c_int
        _bwd_lib = lib
    return _bwd_lib


def bwd_kernels_per_call(x_shape, cout: int, *, stride: int = 1,
                         need_dx: bool = True) -> int:
    """CUDA kernels one :func:`conv2d3x3_bwd` call launches for an input of
    ``x_shape`` (N, H, W, Cin): 2 where dgrad is a launch of its own before
    wgrad's, else 1.  Builds the kernel's library."""
    n, h, wd, cin = x_shape
    k = _load_bwd().conv2d3x3_bwd_kernels(n, h, wd, cin, cout, stride,
                                          int(need_dx))
    if k == 0:
        raise ValueError(f"conv2d3x3_bwd takes no Cin={cin}, Cout={cout}, "
                         f"stride={stride}")
    return k


def _fwd_out(x, w, stride: int) -> torch.Tensor:
    n, h, wd, _ = x.shape
    return torch.empty((n, same_pads(h, stride)[0], same_pads(wd, stride)[0],
                        w.shape[-1]), dtype=torch.float32, device=x.device)


def _bwd_out(x, w, cout: int, need_dx: bool, nf: int | None = None):
    """Empty ``(dx, dw, db)`` of a backward call (``nf`` fields, or one)."""
    dx = torch.empty_like(x) if need_dx else None
    dw = torch.empty_like(w)
    db = torch.empty((cout,) if nf is None else (nf, cout),
                     dtype=torch.float32, device=x.device)
    return dx, dw, db


def conv2d3x3(x, w, b, *, stride: int = 1, relu: bool = True) -> torch.Tensor:
    """Forward of the 3×3 conv: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    global launches
    _check(x, w, b, stride)
    if cost.shape_only(x, w, b):
        y = _fwd_out(x, w, stride)
        _report_fwd("conv2d3x3", x, w, b, y)
        return y
    if x.device.type == "cpu":
        return conv2d3x3_plain(x, w, b, stride=stride, relu=relu)
    x, w, b = _cuda_operands("conv2d3x3", x, w, b)
    n, h, wd, _ = x.shape
    y = _fwd_out(x, w, stride)
    if y.numel() == 0:
        return y
    lib = _load()
    err = lib.conv2d3x3_launch(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), n, h, wd,
        x.shape[3], y.shape[3], y.shape[1], y.shape[2], stride,
        same_pads(h, stride)[1], same_pads(wd, stride)[1], int(relu),
        x.device.index or 0, torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError("conv2d3x3 launch failed: "
                           + lib.conv2d3x3_error_string(err).decode())
    with _build.COUNT_LOCK:
        launches += 1
    _report_fwd("conv2d3x3", x, w, b, y)
    return y


def conv2d3x3_bwd(g, y, x, w, *, stride: int = 1, relu: bool = True,
                  need_dx: bool = True):
    """Gradients ``(dx, dw, db)`` of the conv at the output gradient ``g``,
    with ``y`` the forward's output (ReLU mask); ``dx`` is None unless
    ``need_dx``.  The CUDA kernels for CUDA tensors, the plain versions for
    CPU tensors."""
    global bwd_launches
    _check(x, w, None, stride)
    n, h, wd, cin = x.shape
    cout = w.shape[-1]
    want = (n, same_pads(h, stride)[0], same_pads(wd, stride)[0], cout)
    if tuple(g.shape) != want or tuple(y.shape) != want:
        raise ValueError(f"g and y must be {want}, got {tuple(g.shape)} and "
                         f"{tuple(y.shape)}")
    if g.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError("conv2d3x3_bwd takes float32 tensors")
    if not (g.device == y.device == x.device):
        raise ValueError("g, y, x and w must share one device")
    if cost.shape_only(g, y, x, w):
        dx, dw, db = _bwd_out(x, w, cout, need_dx)
        _report_bwd("conv2d3x3_bwd", g, y, x, w, relu, dx, dw, db)
        return dx, dw, db
    if x.device.type == "cpu":
        dx = (conv2d3x3_dgrad_plain(g, y, w, x.shape, stride=stride, relu=relu)
              if need_dx else None)
        return (dx, *conv2d3x3_wgrad_plain(g, y, x, stride=stride, relu=relu))
    x, w, y, g = _cuda_operands("conv2d3x3_bwd", x, w, y, g)
    dx, dw, db = _bwd_out(x, w, cout, need_dx)
    if g.numel() == 0:
        if need_dx:
            dx.zero_()
        return dx, dw.zero_(), db.zero_()
    partial = torch.empty((WGRAD_ROWS, (9 * cin * cout + cout + 3) // 4 * 4),
                          dtype=torch.float32, device=x.device)
    tickets = group_tickets(x.device, 1)
    lib = _load_bwd()
    err = lib.conv2d3x3_bwd_launch(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), g.data_ptr(),
        dx.data_ptr() if need_dx else None, dw.data_ptr(), db.data_ptr(),
        partial.data_ptr(), tickets.data_ptr(), WGRAD_ROWS, n, h, wd,
        cin, cout, want[1], want[2], stride, same_pads(h, stride)[1],
        same_pads(wd, stride)[1], int(relu), int(need_dx),
        x.device.index or 0, torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError("conv2d3x3_bwd launch failed: "
                           + lib.conv2d3x3_bwd_error_string(err).decode())
    with _build.COUNT_LOCK:
        bwd_launches += 1
    _report_bwd("conv2d3x3_bwd", g, y, x, w, relu, dx, dw, db)
    return dx, dw, db


class Conv3x3(torch.autograd.Function):
    """Autograd around :func:`conv2d3x3` and :func:`conv2d3x3_bwd`."""

    @staticmethod
    def forward(ctx, x, w, b, stride: int, relu: bool):
        y = conv2d3x3(x, w, b, stride=stride, relu=relu)
        ctx.save_for_backward(x, w, y)
        ctx.stride, ctx.relu = stride, relu
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, y = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        dx, dw, db = conv2d3x3_bwd(g.contiguous(), y, x, w, stride=ctx.stride,
                                   relu=ctx.relu, need_dx=need_x)
        return dx, dw if need_w else None, db if need_b else None, None, None


def conv3x3(x, w, b, *, stride: int = 1, relu: bool = True) -> torch.Tensor:
    """Differentiable 3×3 conv (the skipping DNN's conv layers)."""
    return Conv3x3.apply(x.contiguous(), w.contiguous(), b.contiguous(),
                         stride, relu)


# ---- grouped calls: F fields, each with its own weights, one launch ----

def _fields(x, w):
    """``(F, N)`` of a grouped call: ``x`` holds F*N images."""
    if w.dim() != 5:
        raise ValueError(f"grouped w must be (F,3,3,Cin,Cout), got {tuple(w.shape)}")
    nf = w.shape[0]
    if nf < 1 or x.dim() != 4 or x.shape[0] % nf:
        raise ValueError(f"grouped x must be (F*N,H,W,Cin) for F={nf}, got "
                         f"{tuple(x.shape)}")
    return nf, x.shape[0] // nf


def _split(t, nf: int) -> list:
    """The field-major batch ``t`` as its ``nf`` fields' slices."""
    return list(t.reshape(nf, -1, *t.shape[1:]).unbind(0))


def conv2d3x3_grouped_plain(x, w, b, *, stride: int = 1, relu: bool = True):
    """Plain version of the grouped forward: :func:`conv2d3x3_plain` field
    by field, stacked field-major."""
    nf, _ = _fields(x, w)
    return torch.cat([conv2d3x3_plain(xf, w[f], b[f], stride=stride, relu=relu)
                      for f, xf in enumerate(_split(x, nf))])


def conv2d3x3_grouped_dgrad_plain(g, y, w, x_shape, *, stride: int = 1,
                                  relu: bool = True):
    """Plain version of the grouped dgrad, field by field."""
    nf = w.shape[0]
    shape = (x_shape[0] // nf, *x_shape[1:])
    return torch.cat([conv2d3x3_dgrad_plain(gf, yf, w[f], shape, stride=stride,
                                            relu=relu)
                      for f, (gf, yf) in enumerate(zip(_split(g, nf),
                                                       _split(y, nf)))])


def conv2d3x3_grouped_wgrad_plain(g, y, x, nf: int, *, stride: int = 1,
                                  relu: bool = True):
    """Plain version of the grouped wgrad: ``(dw [F,3,3,Cin,Cout],
    db [F,Cout])``, field by field."""
    per = [conv2d3x3_wgrad_plain(gf, yf, xf, stride=stride, relu=relu)
           for gf, yf, xf in zip(_split(g, nf), _split(y, nf), _split(x, nf))]
    return torch.stack([p[0] for p in per]), torch.stack([p[1] for p in per])


def _check_grouped(x, w, b, stride):
    nf, _ = _fields(x, w)
    _check(x, w[0], None if b is None else b[0], stride)
    if b is not None and tuple(b.shape) != (nf, w.shape[-1]):
        raise ValueError(f"grouped b must be (F,Cout) = {(nf, w.shape[-1])}, "
                         f"got {tuple(b.shape)}")
    ts = (w,) if b is None else (w, b)
    if any(t.dtype != torch.float32 or t.device != x.device for t in ts):
        raise TypeError("grouped conv2d3x3 takes float32 tensors on one device")
    return nf


def conv2d3x3_grouped(x, w, b, *, stride: int = 1, relu: bool = True
                      ) -> torch.Tensor:
    """Forward of F fields' 3×3 convs in one launch: the CUDA kernel for
    CUDA tensors, :func:`conv2d3x3_grouped_plain` for CPU tensors."""
    global grouped_launches
    nf = _check_grouped(x, w, b, stride)
    if cost.shape_only(x, w, b):
        y = _fwd_out(x, w, stride)
        _report_fwd("conv2d3x3_grouped", x, w, b, y)
        return y
    if x.device.type == "cpu":
        return conv2d3x3_grouped_plain(x, w, b, stride=stride, relu=relu)
    x, w, b = _cuda_operands("conv2d3x3_grouped", x, w, b)
    n, h, wd, _ = x.shape
    y = _fwd_out(x, w, stride)
    if y.numel() == 0:
        return y
    lib = _load()
    err = lib.conv2d3x3_grouped_launch(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), nf, n // nf,
        h, wd, x.shape[3], y.shape[3], y.shape[1], y.shape[2], stride,
        same_pads(h, stride)[1], same_pads(wd, stride)[1], int(relu),
        x.device.index or 0, torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError("conv2d3x3_grouped launch failed: "
                           + lib.conv2d3x3_error_string(err).decode())
    with _build.COUNT_LOCK:
        grouped_launches += 1
    _report_fwd("conv2d3x3_grouped", x, w, b, y)
    return y


def group_tickets(device, nf: int) -> torch.Tensor:
    """The backward's ticket counters of the current stream on ``device``,
    at least ``nf`` of them (one a field), each 0 between calls."""
    stream = torch.cuda.current_stream(device).cuda_stream
    key = (device.index or 0, stream)
    t = _group_tickets.get(key)
    if t is None or t.numel() < nf:
        t = torch.zeros(max(nf, 4), dtype=torch.int32, device=device)
        _group_tickets[key] = t
    return t


def conv2d3x3_bwd_grouped(g, y, x, w, *, stride: int = 1, relu: bool = True,
                          need_dx: bool = True):
    """Gradients ``(dx, dw [F,3,3,Cin,Cout], db [F,Cout])`` of F fields'
    convs in one call (one launch, or two where dgrad runs apart, as for
    one field of this shape); ``dx`` is None unless ``need_dx``.  The CUDA
    kernels for CUDA tensors, the plain versions for CPU tensors."""
    global grouped_bwd_launches
    nf = _check_grouped(x, w, None, stride)
    n, h, wd, cin = x.shape
    cout = w.shape[-1]
    want = (n, same_pads(h, stride)[0], same_pads(wd, stride)[0], cout)
    if tuple(g.shape) != want or tuple(y.shape) != want:
        raise ValueError(f"g and y must be {want}, got {tuple(g.shape)} and "
                         f"{tuple(y.shape)}")
    if g.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError("conv2d3x3_bwd_grouped takes float32 tensors")
    if not (g.device == y.device == x.device):
        raise ValueError("g, y, x and w must share one device")
    if cost.shape_only(g, y, x, w):
        dx, dw, db = _bwd_out(x, w, cout, need_dx, nf)
        _report_bwd("conv2d3x3_grouped_bwd", g, y, x, w, relu, dx, dw, db)
        return dx, dw, db
    if x.device.type == "cpu":
        dx = (conv2d3x3_grouped_dgrad_plain(g, y, w, x.shape, stride=stride,
                                            relu=relu) if need_dx else None)
        return (dx, *conv2d3x3_grouped_wgrad_plain(g, y, x, nf, stride=stride,
                                                   relu=relu))
    x, w, y, g = _cuda_operands("conv2d3x3_bwd_grouped", x, w, y, g)
    dx, dw, db = _bwd_out(x, w, cout, need_dx, nf)
    if g.numel() == 0:
        if need_dx:
            dx.zero_()
        return dx, dw.zero_(), db.zero_()
    partial = torch.empty((nf, WGRAD_ROWS, (9 * cin * cout + cout + 3) // 4 * 4),
                          dtype=torch.float32, device=x.device)
    tickets = group_tickets(x.device, nf)
    lib = _load_bwd()
    err = lib.conv2d3x3_bwd_grouped_launch(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), g.data_ptr(),
        dx.data_ptr() if need_dx else None, dw.data_ptr(), db.data_ptr(),
        partial.data_ptr(), tickets.data_ptr(), WGRAD_ROWS, nf, n // nf, h,
        wd, cin, cout, want[1], want[2], stride, same_pads(h, stride)[1],
        same_pads(wd, stride)[1], int(relu), int(need_dx), x.device.index or 0,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError("conv2d3x3_bwd_grouped launch failed: "
                           + lib.conv2d3x3_bwd_error_string(err).decode())
    with _build.COUNT_LOCK:
        grouped_bwd_launches += 1
    _report_bwd("conv2d3x3_grouped_bwd", g, y, x, w, relu, dx, dw, db)
    return dx, dw, db


class Conv3x3Grouped(torch.autograd.Function):
    """Autograd around :func:`conv2d3x3_grouped` and
    :func:`conv2d3x3_bwd_grouped`."""

    @staticmethod
    def forward(ctx, x, w, b, stride: int, relu: bool):
        y = conv2d3x3_grouped(x, w, b, stride=stride, relu=relu)
        ctx.save_for_backward(x, w, y)
        ctx.stride, ctx.relu = stride, relu
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, y = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        dx, dw, db = conv2d3x3_bwd_grouped(g.contiguous(), y, x, w,
                                           stride=ctx.stride, relu=ctx.relu,
                                           need_dx=need_x)
        return dx, dw if need_w else None, db if need_b else None, None, None


def conv3x3_grouped(x, w, b, *, stride: int = 1, relu: bool = True
                    ) -> torch.Tensor:
    """Differentiable grouped 3×3 conv (the stacked skipping DNN's conv
    layers): ``x (F*N,H,W,Cin)``, ``w (F,3,3,Cin,Cout)``, ``b (F,Cout)``."""
    return Conv3x3Grouped.apply(x.contiguous(), w.contiguous(), b.contiguous(),
                                stride, relu)
