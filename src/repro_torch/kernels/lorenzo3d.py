"""Dual-quantization Lorenzo encode and decode: the ``csrc/lorenzo3d.cu``
kernels and their plain PyTorch versions.

Replaces the Pallas TPU kernels ``repro/kernels/lorenzo3d.py::
lorenzo3d_fwd`` and ``::lorenzo3d_inv``, with the arithmetic of the eager
reference that writes archives (``repro.compressors.szlike.
_lorenzo_encode_core`` and ``lorenzo_undelta`` with ``q * (2 eb)``): float64
in, divide by the step, escapes zeroed before the delta.  Both take a
stacked group ``[F, D, H, W]`` or ``[F, H, W]`` with one bound per field.
CUDA tensors launch the kernels (or raise), CPU tensors take the plain
versions; nothing probes or falls back.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

CODE_CAP = 1 << 15    # compressors.quantize.CODE_CAP (kernels import no compressor)
GRID_YZ_MAX = 65535   # CUDA's limit on a launch grid's y and z
FWD_TILE_ROWS = 8     # rows of the forward's tile (grid.y = ceil(H / 8))

# Calls of :func:`lorenzo3d_fwd` / :func:`lorenzo3d_inv` that launched their
# kernels (CUDA route only).  An inverse call is two launches: the carry
# rows of each band, then the walk over z of each band; five for rows wider
# than a band's shared memory (the striped route: the stripes' left
# prefixes take three more).
fwd_launches = 0
inv_launches = 0

_lib = None


def lorenzo_delta(q: torch.Tensor, axes=None) -> torch.Tensor:
    """N-D first-order Lorenzo delta of an integer lattice, zero boundary:
    first differences along every axis of ``axes`` (default all)."""
    d = q
    for axis in (range(q.ndim) if axes is None else axes):
        n = q.shape[axis]
        if n == 1:
            continue
        shifted = torch.cat([torch.zeros_like(d.narrow(axis, 0, 1)),
                             d.narrow(axis, 0, n - 1)], dim=axis)
        d = d - shifted
    return d


def lorenzo_undelta_plain(d: torch.Tensor, axes=None) -> torch.Tensor:
    """Inverse of :func:`lorenzo_delta`: int32 inclusive prefix sums along
    every axis of ``axes`` (default all)."""
    q = d
    for axis in (range(d.ndim) if axes is None else axes):
        if d.shape[axis] == 1:
            continue
        q = torch.cumsum(q, dim=axis, dtype=q.dtype)
    return q


def _eb_column(eb: torch.Tensor, ndim: int) -> torch.Tensor:
    return eb.reshape((eb.shape[0],) + (1,) * (ndim - 1))


def lorenzo_encode_plain(x: torch.Tensor, eb: torch.Tensor,
                         out_dtype: torch.dtype):
    """Plain version of the forward kernel: the reference's op sequence,
    one tensor op each.  ``x`` is the float64 group ``[F, ...]``, ``eb`` the
    float64 bounds ``[F]``; returns ``(delta int32, unpred bool, rec)``."""
    eb_arr = _eb_column(eb, x.ndim)
    step = 2.0 * eb_arr
    q = torch.round(x / step)
    unpred = (torch.abs(q) >= CODE_CAP) | ~torch.isfinite(x)
    qi = torch.where(unpred, 0, q).to(torch.int32)
    rec = qi.to(x.dtype) * step
    cast_bad = torch.abs(rec.to(out_dtype).to(rec.dtype) - x) > eb_arr
    unpred = unpred | cast_bad
    qi = torch.where(unpred, 0, qi)
    d = lorenzo_delta(qi, axes=range(1, qi.ndim))
    rec = torch.where(unpred, x, qi.to(x.dtype) * step)
    return d, unpred, rec


def lorenzo_decode_plain(delta: torch.Tensor, eb: torch.Tensor) -> torch.Tensor:
    """Plain version of the inverse kernel: ``q`` back from the delta, then
    ``rec = q * (2 eb)`` in float64."""
    q = lorenzo_undelta_plain(delta, axes=range(1, delta.ndim))
    return q.to(torch.float64) * (2.0 * _eb_column(eb, delta.ndim))


def _bounds(eb, x: torch.Tensor) -> torch.Tensor:
    eb = torch.as_tensor(eb, dtype=torch.float64).reshape(-1).to(x.device)
    if eb.shape[0] != x.shape[0]:
        raise ValueError(f"{eb.shape[0]} bounds for a group of {x.shape[0]} fields")
    return eb


def _dims(x: torch.Tensor) -> tuple[int, int, int, int]:
    if x.ndim == 3:
        return x.shape[0], 1, x.shape[1], x.shape[2]
    if x.ndim == 4:
        return tuple(x.shape)
    raise ValueError(f"expected a [F, H, W] or [F, D, H, W] group, got "
                     f"shape {tuple(x.shape)}")


def _cuda_ready(*ts: torch.Tensor, name: str) -> bool:
    """True for CUDA tensors (after the checks), False for CPU ones."""
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError(f"{name}: tensors must share one device")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {dev}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name} takes contiguous tensors")
    return True


def _load():
    global _lib
    if _lib is None:
        lib = _build.load("lorenzo3d")
        lib.lorenzo3d_fwd.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
                                      + [ctypes.c_void_p] * 3 + [ctypes.c_int]
                                      + [ctypes.c_void_p])
        lib.lorenzo3d_inv.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 6
                                      + [ctypes.c_void_p] * 3 + [ctypes.c_int]
                                      + [ctypes.c_void_p])
        lib.lorenzo3d_inv_band_rows.argtypes = [ctypes.c_int]
        lib.lorenzo3d_inv_band_rows.restype = ctypes.c_int
        lib.lorenzo3d_inv_stripe.argtypes = []
        lib.lorenzo3d_inv_stripe.restype = ctypes.c_int
        for fn in (lib.lorenzo3d_fwd, lib.lorenzo3d_inv):
            fn.restype = ctypes.c_int
        lib.lorenzo3d_error_string.argtypes = [ctypes.c_int]
        lib.lorenzo3d_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _raise_on(err: int, lib, name: str) -> None:
    if err:
        raise RuntimeError(f"{name} launch failed: "
                           + lib.lorenzo3d_error_string(err).decode())


def lorenzo3d_fwd(x: torch.Tensor, eb, out_dtype: torch.dtype):
    """Encode the float64 group ``x`` (``[F, H, W]`` or ``[F, D, H, W]``)
    with one bound per field: ``(delta int32, unpred bool, rec float64)``,
    each of ``x``'s shape.  ``out_dtype`` (float32 or float64) is the
    field's own type, against which the cast check is made."""
    global fwd_launches
    if x.dtype != torch.float64:
        raise TypeError(f"x must be float64, got {x.dtype}")
    if out_dtype not in (torch.float32, torch.float64):
        raise TypeError(f"out_dtype must be float32 or float64, got {out_dtype}")
    f, d, h, w = _dims(x)
    eb = _bounds(eb, x)
    if not _cuda_ready(x, eb, name="lorenzo3d_fwd"):
        return lorenzo_encode_plain(x, eb, out_dtype)
    if -(-h // FWD_TILE_ROWS) > GRID_YZ_MAX or f > GRID_YZ_MAX:
        raise ValueError(f"lorenzo3d_fwd: a group of {f} fields of {h} rows "
                         f"exceeds the launch grid (at most {GRID_YZ_MAX} "
                         f"fields and {GRID_YZ_MAX * FWD_TILE_ROWS} rows)")
    delta = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    unpred = torch.empty(x.shape, dtype=torch.bool, device=x.device)
    rec = torch.empty_like(x)
    if x.numel() == 0:
        return delta, unpred, rec
    lib = _load()
    err = lib.lorenzo3d_fwd(x.data_ptr(), eb.data_ptr(), f, d, h, w,
                            int(out_dtype == torch.float32), delta.data_ptr(),
                            unpred.data_ptr(), rec.data_ptr(),
                            x.device.index or 0,
                            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, lib, "lorenzo3d_fwd")
    with _build.COUNT_LOCK:
        fwd_launches += 1
    return delta, unpred, rec


def lorenzo3d_inv(delta: torch.Tensor, eb) -> torch.Tensor:
    """Decode the int32 delta group (``[F, H, W]`` or ``[F, D, H, W]``):
    ``rec = q * (2 eb_f)`` in float64, ``q`` the prefix sums of ``delta``
    over every axis but the first."""
    global inv_launches
    if delta.dtype != torch.int32:
        raise TypeError(f"delta must be int32, got {delta.dtype}")
    f, d, h, w = _dims(delta)
    eb = _bounds(eb, delta)
    if not _cuda_ready(delta, eb, name="lorenzo3d_inv"):
        return lorenzo_decode_plain(delta, eb)
    rec = torch.empty(delta.shape, dtype=torch.float64, device=delta.device)
    if delta.numel() == 0:
        return rec
    lib = _load()
    bh = lib.lorenzo3d_inv_band_rows(w)
    ns = 1
    if bh < 1:
        # Rows wider than a band's shared memory: the striped route.
        stripe = lib.lorenzo3d_inv_stripe()
        bh, ns = lib.lorenzo3d_inv_band_rows(stripe), -(-w // stripe)
        if ns > GRID_YZ_MAX:
            raise ValueError(f"lorenzo3d_inv: rows of {w} points exceed the "
                             f"launch grid ({GRID_YZ_MAX} stripes of {stripe})")
    # The sum of the rows above each band, per (field, plane, band): 1/bh of
    # the group, not a full-size scratch; striped, the left prefix of each
    # stripe, per (field, plane, row): 1/stripe of the group.
    carry = torch.empty((f, d, -(-h // bh), w), dtype=torch.int32,
                        device=delta.device)
    left = torch.empty((f, d, h, ns) if ns > 1 else (0,), dtype=torch.int32,
                       device=delta.device)
    err = lib.lorenzo3d_inv(delta.data_ptr(), eb.data_ptr(), f, d, h, w, bh, ns,
                            carry.data_ptr(), left.data_ptr(), rec.data_ptr(),
                            delta.device.index or 0,
                            torch.cuda.current_stream(delta.device).cuda_stream)
    _raise_on(err, lib, "lorenzo3d_inv")
    with _build.COUNT_LOCK:
        inv_launches += 1
    return rec
