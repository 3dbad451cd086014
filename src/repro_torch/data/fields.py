"""Synthetic scientific-field generators matched to the paper's three
datasets (SDRBench originals are not redistributable offline).

A copy of the JAX package's numpy generator (``repro/data/fields.py``): the
same dataset, seed and shape give the same bytes in both packages.  Each
snapshot is correlated multi-field blocks built from a shared latent
Gaussian random field plus field-specific components, as Nyx's
temperature and densities are coupled through one set of equations
(§3.4), which cross-field learning exploits:

  nyx       — cosmology: log-normal density fields (huge dynamic range),
              power-law spectrum k^-3, float32
  miranda   — large turbulence, float64, smooth k^-5/3 Kolmogorov-like
              spectra
  hurricane — weather: anisotropic (stratified) spectra, float32

:func:`snapshot_specs` / :func:`load_spec` describe a many-field snapshot
lazily, one field generated at a load
(``repro_torch.streaming.synthetic_snapshot_source`` wraps them).
"""
from __future__ import annotations

import numpy as np


def _grf(rng: np.random.Generator, shape, slope: float,
         aniso: tuple = None) -> np.ndarray:
    """Gaussian random field with isotropic power spectrum ~ k^-slope."""
    kfreqs = [np.fft.fftfreq(n) * n for n in shape]
    grids = np.meshgrid(*kfreqs, indexing="ij")
    if aniso:
        grids = [g * a for g, a in zip(grids, aniso)]
    k2 = sum(g ** 2 for g in grids)
    k2[(0,) * len(shape)] = 1.0
    amp = k2 ** (-slope / 4.0)  # power ~ k^-slope  => amplitude ~ k^-slope/2
    amp[(0,) * len(shape)] = 0.0
    noise = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    f = np.fft.ifftn(np.fft.fftn(noise) * amp).real
    f -= f.mean()
    sd = f.std()
    return f / (sd if sd > 0 else 1.0)


def make_fields(dataset: str = "nyx", shape=(64, 64, 64), seed: int = 0,
                coupling: float = 0.8) -> dict[str, np.ndarray]:
    """Correlated multi-field block for one synthetic dataset.

    ``coupling`` sets the shared-latent fraction (cross-field correlation).
    """
    rng = np.random.default_rng(seed)
    c = float(np.clip(coupling, 0.0, 1.0))
    w_shared, w_own = np.sqrt(c), np.sqrt(1.0 - c)

    if dataset == "nyx":
        latent = _grf(rng, shape, slope=3.0)
        def mix(slope):
            return w_shared * latent + w_own * _grf(rng, shape, slope)
        temp = (np.exp(1.2 * mix(3.0)) * 1e4).astype(np.float32)        # K-like
        dmd = (np.exp(2.0 * mix(2.8))).astype(np.float32)               # overdensity
        baryon = (np.exp(2.2 * (c * np.log(np.maximum(dmd, 1e-6)) / 2.0
                                + (1 - c) * mix(2.6)))).astype(np.float32)
        vy = (mix(3.2) * 2.5e7).astype(np.float32)                      # cm/s-like
        return {"temperature": temp, "dark_matter_density": dmd,
                "baryon_density": baryon, "velocity_y": vy}

    if dataset == "miranda":
        latent = _grf(rng, shape, slope=5.0 / 3.0 + 2.0)  # smooth turbulence
        def mix(slope):
            return w_shared * latent + w_own * _grf(rng, shape, slope)
        diff = (1.0 + 0.3 * mix(3.6)).astype(np.float64)
        visc = (1.0 + 0.25 * (c * (diff - 1.0) / 0.3 + (1 - c) * mix(3.5))).astype(np.float64)
        velz = (mix(3.7) * 0.8).astype(np.float64)
        return {"diffusivity": diff, "viscosity": visc, "velocity_z": velz}

    if dataset == "hurricane":
        aniso = (4.0, 1.0, 1.0)  # stratified atmosphere: steep vertical spectrum
        latent = _grf(rng, shape, slope=2.6, aniso=aniso)
        def mix(slope):
            return w_shared * latent + w_own * _grf(rng, shape, slope, aniso=aniso)
        cloud = np.maximum(mix(2.6) - 0.8, 0.0).astype(np.float32) * 1e-3  # sparse/spiky
        precip = np.maximum(mix(2.4) - 1.0, 0.0).astype(np.float32) * 5e-3
        w = (mix(2.9) * 8.0).astype(np.float32)
        return {"cloud": cloud, "precip": precip, "w": w}

    raise ValueError(f"unknown dataset {dataset!r}")


def snapshot_specs(num_fields: int, shape=(16, 32, 32), dataset: str = "nyx",
                   seed0: int = 2) -> dict[str, dict]:
    """Lazy per-field recipes for a ``num_fields``-field snapshot.

    Names are ``{field}_s{seed}`` over successive seed blocks, as the JAX
    package's benchmarks name them, but nothing is
    generated here — :func:`load_spec` materializes one field at a time, so
    the streaming pipeline can ingest snapshots far larger than memory
    (``repro_torch.streaming.synthetic_snapshot_source`` wraps this)."""
    specs: dict[str, dict] = {}
    seed = seed0
    while len(specs) < num_fields:
        for name in DATASET_FIELDS[dataset]:
            if len(specs) < num_fields:
                specs[f"{name}_s{seed}"] = {"dataset": dataset,
                                            "shape": tuple(shape),
                                            "seed": seed, "field": name}
        seed += 1
    return specs


def load_spec(spec: dict) -> np.ndarray:
    """Materialize one snapshot field from its recipe.

    Regenerates only that field's seed block (the shared-latent coupling
    means a block's fields come from one RNG pass), so transient memory is
    one block regardless of snapshot size.  Deterministic: repeated loads
    return identical bytes, as the streaming source contract requires."""
    block = make_fields(spec["dataset"], shape=spec["shape"],
                        seed=spec["seed"])
    return block[spec["field"]]


DATASET_DTYPES = {"nyx": "float32", "miranda": "float64", "hurricane": "float32"}
DATASET_FIELDS = {
    "nyx": ["temperature", "dark_matter_density", "baryon_density", "velocity_y"],
    "miranda": ["diffusivity", "viscosity", "velocity_z"],
    "hurricane": ["cloud", "precip", "w"],
}
# Cross-field partner map used by benchmarks (paper §3.4/§5.2: T predicted
# with DMD help; baryon with DMD; etc.).
DEFAULT_CROSS_FIELD = {
    "nyx": {"temperature": ("dark_matter_density",),
            "baryon_density": ("dark_matter_density",),
            "dark_matter_density": ("temperature",),
            "velocity_y": ("temperature",)},
    "miranda": {"diffusivity": ("viscosity",), "viscosity": ("diffusivity",),
                "velocity_z": ("diffusivity",)},
    "hurricane": {"cloud": ("w",), "precip": ("cloud",), "w": ("precip",)},
}
