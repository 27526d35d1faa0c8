"""Darcy inputs made from the seed with the benchmark's own NumPy code.

The coefficient is the Darcy data's: piecewise constant 12 / 3 from a
thresholded Gaussian random field with covariance (-Laplacian +
tau^2)^(-alpha), drawn through a sine (DST-I) expansion, as
``graph_pde_tpu_torch/data/synthetic.py`` draws it. The smoothed
coefficient and its central differences are the node features the
models read. No PDE is solved: the target is a smoother random field
of the same size, since a step's work does not depend on its values.
"""
from __future__ import annotations

import numpy as np


def grf_2d(rng: np.random.Generator, s: int, alpha: float = 2.0,
           tau: float = 3.0) -> np.ndarray:
    """A Gaussian random field on an s x s grid."""
    from scipy.fft import dstn

    k = np.arange(1, s + 1)
    kx, ky = np.meshgrid(k, k, indexing="ij")
    coef = (np.pi ** 2 * (kx ** 2 + ky ** 2) + tau ** 2) ** (-alpha / 2.0)
    coef = coef * tau ** (alpha - 1.0)
    return dstn(rng.normal(size=(s, s)) * coef, type=1, norm="ortho")


def aux_fields(a: np.ndarray, sigma: float = 1.0):
    """The smoothed coefficient (Gaussian filter) and its central
    differences on the unit grid, for one [s, s] coefficient."""
    from scipy.ndimage import gaussian_filter

    ka = gaussian_filter(a, sigma=sigma)
    kx, ky = np.gradient(ka, 1.0 / (a.shape[0] - 1))
    return ka, kx, ky


def darcy_fields(rng: np.random.Generator, n: int, s: int) -> dict:
    """n samples at s x s: coeff, Kcoeff, Kcoeff_x, Kcoeff_y and the
    target sol, each float32 [n, s, s]."""
    out = {k: [] for k in ("coeff", "Kcoeff", "Kcoeff_x", "Kcoeff_y",
                           "sol")}
    for _ in range(n):
        a = np.where(grf_2d(rng, s) >= 0, 12.0, 3.0)
        ka, kx, ky = aux_fields(a)
        out["coeff"].append(a)
        out["Kcoeff"].append(ka)
        out["Kcoeff_x"].append(kx)
        out["Kcoeff_y"].append(ky)
        out["sol"].append(0.01 * grf_2d(rng, s, alpha=3.0))
    return {k: np.stack(v).astype(np.float32) for k, v in out.items()}


def seeds(seed: int, n: int) -> list:
    """n independent 63-bit seeds derived from the run's seed (any whole
    number, also beyond 32 bits)."""
    ss = np.random.SeedSequence(int(seed))
    return [int(x) for x in ss.generate_state(n, np.uint64) >> np.uint64(1)]
