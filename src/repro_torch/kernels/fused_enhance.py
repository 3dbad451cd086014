"""Fused enhance + regulate + outlier mask: the ``csrc/fused_enhance.cu``
kernel and its plain PyTorch version.

Replaces the Pallas TPU kernel ``repro/kernels/fused_enhance.py::
fused_enhance``, with the arithmetic of the eager reference that writes
archives (``repro.core.regulation.fused_enhance``): float64, one cast to the
field's dtype at the end.  CUDA tensors launch the kernel (or raise), CPU
tensors take :func:`fused_enhance_plain`; nothing probes or falls back.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

# Kernel launches made by :func:`fused_enhance` (CUDA route only).
launches = 0

_lib = None


def enhance(decomp, resid_norm, eb: float, out_dtype=None) -> torch.Tensor:
    """X̂ = X' + R̂, with R̂ = resid_norm · eb, in float64, cast once."""
    out_dtype = out_dtype or decomp.dtype
    return (decomp.double() + resid_norm.double() * eb).to(out_dtype)


def outlier_mask(orig, enhanced, eb: float) -> torch.Tensor:
    """Points where the final-dtype enhanced value violates the 1× bound."""
    return torch.abs(enhanced.double() - orig.double()) > eb


def apply_strict(enhanced, decomp, mask) -> torch.Tensor:
    """Outliers take the in-bound decompressed value."""
    return torch.where(mask, decomp, enhanced)


def fused_enhance_plain(z, dec, orig, eb: float, *, regulated: bool = False,
                        strict: bool = True):
    """Plain version: the same float64 ops as the kernel, one per tensor op."""
    zd = z.double()
    if regulated:
        zd = 2.0 * torch.sigmoid(zd) - 1.0
    enh = enhance(dec, zd, eb)
    bad = outlier_mask(orig, enh, eb)
    out = apply_strict(enh, dec, bad) if strict else enh
    return out, bad.to(torch.uint8)


def _check(z, dec, orig):
    if z.dtype != torch.float32:
        raise TypeError(f"z must be float32, got {z.dtype}")
    if dec.dtype not in (torch.float32, torch.float64) or orig.dtype != dec.dtype:
        raise TypeError(f"dec and orig must share float32 or float64, got "
                        f"{dec.dtype} and {orig.dtype}")
    if not (z.shape == dec.shape == orig.shape):
        raise ValueError(f"shape mismatch: z {tuple(z.shape)}, dec "
                         f"{tuple(dec.shape)}, orig {tuple(orig.shape)}")
    if not (z.device == dec.device == orig.device):
        raise ValueError("z, dec and orig must share one device")


def _load():
    global _lib
    if _lib is None:
        lib = _build.load("fused_enhance")
        for fn in (lib.fused_enhance_f32, lib.fused_enhance_f64):
            fn.argtypes = ([ctypes.c_void_p] * 5
                           + [ctypes.c_longlong, ctypes.c_double]
                           + [ctypes.c_int] * 3 + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
        lib.fused_enhance_error_string.argtypes = [ctypes.c_int]
        lib.fused_enhance_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def fused_enhance(z, dec, orig, eb: float, *, regulated: bool = False,
                  strict: bool = True):
    """``(final, mask uint8)`` of the field: ``final`` has ``dec``'s dtype.
    ``z`` is the float32 residual prediction (already regulated by the
    network head unless ``regulated``)."""
    global launches
    _check(z, dec, orig)
    if z.device.type == "cpu":
        return fused_enhance_plain(z, dec, orig, eb, regulated=regulated,
                                   strict=strict)
    if z.device.type != "cuda":
        raise ValueError(f"fused_enhance runs on cuda or cpu, not {z.device}")
    if not (z.is_contiguous() and dec.is_contiguous() and orig.is_contiguous()):
        raise ValueError("fused_enhance takes contiguous tensors")
    out = torch.empty_like(dec)
    mask = torch.empty(dec.shape, dtype=torch.uint8, device=dec.device)
    if dec.numel() == 0:
        return out, mask
    lib = _load()
    fn = lib.fused_enhance_f32 if dec.dtype == torch.float32 else lib.fused_enhance_f64
    err = fn(z.data_ptr(), dec.data_ptr(), orig.data_ptr(), out.data_ptr(),
             mask.data_ptr(), dec.numel(), float(eb), int(regulated),
             int(strict), dec.device.index or 0,
             torch.cuda.current_stream(dec.device).cuda_stream)
    if err:
        raise RuntimeError("fused_enhance launch failed: "
                           + lib.fused_enhance_error_string(err).decode())
    with _build.COUNT_LOCK:
        launches += 1
    return out, mask
