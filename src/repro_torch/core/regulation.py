"""Error regulation (§3.3): strict 1× control and relaxed 2× regulation.

* strict      — enhanced points whose error exceeds ``eb`` are outliers;
  their coordinates are stored and they decode to the decompressed value,
  which the conventional stage keeps in bound, so 1× holds everywhere.
* relaxed     — nothing stored; the ``2σ−1`` head caps the added residual
  at ``±eb``, so the worst case is 2×.
* unregulated — linear head, no guarantee (paper ablation).

The arithmetic is the JAX package's eager reference: float64, then one cast
to the field's dtype.  :func:`fused_enhance` runs it as one kernel on CUDA
tensors and as the plain tensor ops on CPU tensors; the tensors' device
decides, nothing probes or falls back.
"""
from __future__ import annotations

import numpy as np

from ..kernels import fused_enhance as _kernel
# The unfused steps (Fig. 5): the pieces of the kernel's plain version.
from ..kernels.fused_enhance import apply_strict, enhance, outlier_mask  # noqa: F401

MODES = ("strict", "relaxed", "unregulated")


def fused_enhance(decomp, resid_norm, orig, eb: float, *, mode: str = "strict"):
    """Enhance + regulate in one pass: ``(field_rec, mask or None)``, equal
    to :func:`enhance` / :func:`outlier_mask` / :func:`apply_strict` in
    sequence.  ``resid_norm`` is the network's float32 output, already
    through its head."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r} (want one of {MODES})")
    out, bad = _kernel.fused_enhance(resid_norm, decomp, orig, eb,
                                     regulated=False, strict=(mode == "strict"))
    return out, (bad.bool() if mode == "strict" else None)


def check_bound(orig: np.ndarray, rec: np.ndarray, eb: float, mode: str) -> dict:
    """Error validation of a decoded field against its mode's bound."""
    err = np.abs(np.asarray(rec, np.float64) - np.asarray(orig, np.float64))
    finite = np.isfinite(np.asarray(orig, dtype=np.float64))
    maxerr = float(err[finite].max()) if finite.any() else 0.0
    limit = {"strict": eb, "relaxed": 2.0 * eb, "unregulated": np.inf}[mode]
    return {"max_abs_err": maxerr, "bound": limit, "ok": bool(maxerr <= limit),
            "olr": float((err[finite] > eb).mean()) if finite.any() else 0.0}
