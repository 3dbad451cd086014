"""Synthetic Hurricane-ISABEL-like snapshot (SDRBench originals are not
redistributable offline).

A copy of the JAX package's numpy generator (``repro/data/fields.py``,
dataset ``"hurricane"``): the same seed and shape give the same bytes in
both packages.  Three float32 fields built from a shared latent Gaussian
random field with a stratified (anisotropic) spectrum: sparse, spiky
``cloud`` and ``precip`` and a smooth vertical wind ``w``.
"""
from __future__ import annotations

import numpy as np

from ..roadmap import unported


def _grf(rng: np.random.Generator, shape, slope: float,
         aniso: tuple = None) -> np.ndarray:
    """Gaussian random field with power spectrum ~ k^-slope."""
    kfreqs = [np.fft.fftfreq(n) * n for n in shape]
    grids = np.meshgrid(*kfreqs, indexing="ij")
    if aniso:
        grids = [g * a for g, a in zip(grids, aniso)]
    k2 = sum(g ** 2 for g in grids)
    k2[(0,) * len(shape)] = 1.0
    amp = k2 ** (-slope / 4.0)
    amp[(0,) * len(shape)] = 0.0
    noise = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    f = np.fft.ifftn(np.fft.fftn(noise) * amp).real
    f -= f.mean()
    sd = f.std()
    return f / (sd if sd > 0 else 1.0)


def make_fields(dataset: str = "hurricane", shape=(64, 64, 64), seed: int = 0,
                coupling: float = 0.8) -> dict[str, np.ndarray]:
    """The correlated fields of one synthetic snapshot; ``coupling`` is the
    shared-latent fraction (cross-field correlation)."""
    if dataset != "hurricane":
        raise unported(f"dataset {dataset!r}", "the rest")
    rng = np.random.default_rng(seed)
    c = float(np.clip(coupling, 0.0, 1.0))
    w_shared, w_own = np.sqrt(c), np.sqrt(1.0 - c)
    aniso = (4.0, 1.0, 1.0)   # stratified atmosphere: steep vertical spectrum
    latent = _grf(rng, shape, slope=2.6, aniso=aniso)

    def mix(slope):
        return w_shared * latent + w_own * _grf(rng, shape, slope, aniso=aniso)
    cloud = np.maximum(mix(2.6) - 0.8, 0.0).astype(np.float32) * 1e-3
    precip = np.maximum(mix(2.4) - 1.0, 0.0).astype(np.float32) * 5e-3
    w = (mix(2.9) * 8.0).astype(np.float32)
    return {"cloud": cloud, "precip": precip, "w": w}
