"""Quality and rate metrics (paper §4.1): value-range PSNR (SDRBench
convention) and the paper's bit rate
``(size(Z) + supplementary) / num_points`` in bits per value."""
from __future__ import annotations

import numpy as np


def psnr(orig: np.ndarray, rec: np.ndarray) -> float:
    o = np.asarray(orig, dtype=np.float64)
    r = np.asarray(rec, dtype=np.float64)
    finite = np.isfinite(o)
    o, r = o[finite], r[finite]
    if o.size == 0:
        return float("nan")
    vrange = o.max() - o.min()
    if vrange == 0:
        vrange = max(abs(o.max()), 1.0)
    mse = np.mean((o - r) ** 2)
    if mse == 0:
        return float("inf")
    return float(20.0 * np.log10(vrange) - 10.0 * np.log10(mse))


def bitrate(total_bytes: float, num_points: int) -> float:
    """Average bits per value."""
    return 8.0 * float(total_bytes) / float(num_points)
