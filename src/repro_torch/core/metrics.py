"""Quality and rate metrics (paper §4.1): value-range PSNR (SDRBench
convention), MAE, NRMSE, DSSIM (structural dissimilarity averaged over
slices), the paper's bit rate ``(size(Z) + supplementary) / num_points``
in bits per value, the compression ratio and the bit-rate reduction of
Table 2.  Plain numpy, as in the JAX package."""
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


def mae(orig: np.ndarray, rec: np.ndarray) -> float:
    o = np.asarray(orig, dtype=np.float64)
    r = np.asarray(rec, dtype=np.float64)
    finite = np.isfinite(o)
    if not finite.any():
        return float("nan")
    return float(np.mean(np.abs(o[finite] - r[finite])))


def nrmse(orig: np.ndarray, rec: np.ndarray) -> float:
    o = np.asarray(orig, dtype=np.float64)
    r = np.asarray(rec, dtype=np.float64)
    finite = np.isfinite(o)
    o, r = o[finite], r[finite]
    if o.size == 0:
        return float("nan")
    vrange = max(o.max() - o.min(), 1e-300)
    return float(np.sqrt(np.mean((o - r) ** 2)) / vrange)


def _ssim_2d(a: np.ndarray, b: np.ndarray, win: int = 7) -> float:
    """SSIM with a uniform window (a box filter by cumulative sums)."""
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    rng = max(a.max() - a.min(), 1e-300)
    c1, c2 = (0.01 * rng) ** 2, (0.03 * rng) ** 2

    def boxmean(x):
        pad = win // 2
        xp = np.pad(x, pad, mode="edge")
        c = np.cumsum(np.cumsum(xp, 0), 1)
        c = np.pad(c, ((1, 0), (1, 0)))
        h, w = x.shape
        s = (c[win:win + h, win:win + w] - c[:h, win:win + w]
             - c[win:win + h, :w] + c[:h, :w])
        return s / (win * win)

    mu_a, mu_b = boxmean(a), boxmean(b)
    va = boxmean(a * a) - mu_a ** 2
    vb = boxmean(b * b) - mu_b ** 2
    cov = boxmean(a * b) - mu_a * mu_b
    ssim = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a ** 2 + mu_b ** 2 + c1) * (va + vb + c2))
    return float(ssim.mean())


def dssim(orig: np.ndarray, rec: np.ndarray, slice_axis: int = 0,
          max_slices: int = 16) -> float:
    """Structural dissimilarity ``(1 - SSIM)/2`` averaged over sampled
    slices."""
    o = np.moveaxis(np.asarray(orig), slice_axis, 0)
    r = np.moveaxis(np.asarray(rec), slice_axis, 0)
    if o.ndim == 2:
        o, r = o[None], r[None]
    n = o.shape[0]
    idx = np.linspace(0, n - 1, min(n, max_slices)).astype(int)
    vals = [_ssim_2d(o[i], r[i]) for i in idx]
    return float((1.0 - np.mean(vals)) / 2.0)


def bitrate(total_bytes: float, num_points: int) -> float:
    """Average bits per value."""
    return 8.0 * float(total_bytes) / float(num_points)


def compression_ratio(orig_nbytes: int, total_bytes: float) -> float:
    return float(orig_nbytes) / float(total_bytes)


def bitrate_reduction(base_bitrate: float, new_bitrate: float) -> float:
    """Relative bit-rate reduction (%) at equal PSNR (paper Table 2)."""
    return 100.0 * (1.0 - new_bitrate / base_bitrate)
