"""Error-bounded linear quantization primitives.

``code = round((value - pred) / (2 eb))`` and ``rec = pred + code * 2 eb``
keep ``|rec - value| <= eb`` while ``|code| < CODE_CAP``; points at or past
the cap (and non-finite values) are *unpredictable*: the caller stores the
literal and reconstructs it exactly.  Tensor ops on the inputs' device, the
JAX package's arithmetic (round half to even).  The bound itself is
computed on the host with numpy, in the same order as the JAX package,
because every code of an archive depends on its last bit.
"""
from __future__ import annotations

import numpy as np
import torch

CODE_CAP = 1 << 15


def quantize(values: torch.Tensor, pred: torch.Tensor, eb: float
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(codes int32, unpredictable bool mask)`` of ``values`` against
    ``pred`` under the absolute bound ``eb``; masked codes are 0."""
    q = torch.round((values - pred) / (2.0 * eb))
    unpred = (torch.abs(q) >= CODE_CAP) | ~torch.isfinite(values)
    codes = torch.where(unpred, torch.zeros_like(q), q).to(torch.int32)
    return codes, unpred


def dequantize(codes: torch.Tensor, pred: torch.Tensor, eb: float) -> torch.Tensor:
    """Inverse of :func:`quantize` (literal positions must be patched after)."""
    step = torch.tensor(2.0 * eb, dtype=pred.dtype, device=pred.device)
    return pred + codes.to(pred.dtype) * step


def quantize_reconstruct(values: torch.Tensor, pred: torch.Tensor, eb: float
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quantize and dequantize: ``(codes, rec, unpred)``, ``rec`` the
    literal value at unpredictable points (the decoder's output)."""
    codes, unpred = quantize(values, pred, eb)
    rec = torch.where(unpred, values, dequantize(codes, pred, eb))
    return codes, rec, unpred


def prequantize(values: torch.Tensor, eb: float) -> tuple[torch.Tensor, torch.Tensor]:
    """cuSZ-style pre-quantization onto the ``2 eb`` lattice: ``(int32
    codes, unpred mask)``."""
    return quantize(values, torch.zeros_like(values), eb)


def abs_bound_from_rel(x, rel_eb: float) -> float:
    """Value-range-relative bound -> absolute bound (SZ3 ``-M REL``)."""
    x = np.asarray(x)
    finite = x[np.isfinite(x)]
    if finite.size == 0:
        return float(rel_eb)
    vrange = float(finite.max() - finite.min())
    if vrange == 0.0:
        vrange = max(abs(float(finite.max())), 1.0)
    return float(rel_eb) * vrange
