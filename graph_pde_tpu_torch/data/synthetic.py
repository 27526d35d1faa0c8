"""Synthetic Darcy flow data (counterpart of the Darcy part of
graph_pde_tpu/data/synthetic.py; host numpy/scipy, deterministic given a
seed, same numbers as the JAX package's generator).

a(x) is piecewise constant (12/3) from a thresholded Gaussian random
field with covariance (-Laplacian + tau^2)^(-alpha); u solves
-div(a grad u) = 1 with zero Dirichlet boundary (5-point finite
differences, harmonic-mean coefficients, sparse direct solve). Kcoeff is
the Gaussian-smoothed coefficient and Kcoeff_x/y its central-difference
gradients: the node features GKN consumes.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def grf_2d(rng: np.random.Generator, s: int, alpha: float = 2.0,
           tau: float = 3.0) -> np.ndarray:
    """Gaussian random field on an s x s grid with covariance
    ~ (-Laplacian + tau^2 I)^(-alpha), via the KL/DST expansion."""
    from scipy.fft import dstn

    k = np.arange(1, s + 1)
    kx, ky = np.meshgrid(k, k, indexing="ij")
    coef = (np.pi ** 2 * (kx ** 2 + ky ** 2) + tau ** 2) ** (-alpha / 2.0)
    coef = coef * tau ** (alpha - 1.0)
    xi = rng.normal(size=(s, s))
    field = dstn(xi * coef, type=1, norm="ortho")
    return field.astype(np.float64)


def solve_darcy_2d(a: np.ndarray, f: float = 1.0) -> np.ndarray:
    """Solves -div(a grad u) = f on [0,1]^2, u = 0 on the boundary, on
    the s x s node grid (interior (s-2)^2 unknowns)."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    s = a.shape[0]
    h = 1.0 / (s - 1)
    n_i = s - 2

    def hmean(a1, a2):
        return 2.0 * a1 * a2 / (a1 + a2)

    ai = a[1:-1, 1:-1]
    a_e = hmean(ai, a[2:, 1:-1])     # (i+1, j)
    a_w = hmean(ai, a[:-2, 1:-1])    # (i-1, j)
    a_n = hmean(ai, a[1:-1, 2:])     # (i, j+1)
    a_s = hmean(ai, a[1:-1, :-2])    # (i, j-1)

    diag = (a_e + a_w + a_n + a_s).ravel()
    idx = np.arange(n_i * n_i).reshape(n_i, n_i)
    rows = [np.arange(n_i * n_i)]
    cols = [np.arange(n_i * n_i)]
    vals = [diag]
    # east neighbour (i+1, j) and its transpose
    r = idx[:-1, :].ravel()
    c = idx[1:, :].ravel()
    rows += [r, c]
    cols += [c, r]
    vals += [-a_e[:-1, :].ravel(), -a_w[1:, :].ravel()]
    # north neighbour (i, j+1) and its transpose
    r = idx[:, :-1].ravel()
    c = idx[:, 1:].ravel()
    rows += [r, c]
    cols += [c, r]
    vals += [-a_n[:, :-1].ravel(), -a_s[:, 1:].ravel()]

    A = sp.csr_matrix(
        (np.concatenate(vals),
         (np.concatenate(rows), np.concatenate(cols))),
        shape=(n_i * n_i, n_i * n_i)) / (h * h)
    b = np.full(n_i * n_i, f)
    u_i = spla.spsolve(A, b)
    u = np.zeros((s, s))
    u[1:-1, 1:-1] = u_i.reshape(n_i, n_i)
    return u


def darcy_sample(rng: np.random.Generator, s: int,
                 smooth_sigma: float = 1.0) -> Dict[str, np.ndarray]:
    """One Darcy sample: coefficient, FD solution, smoothed coefficient
    and its gradients."""
    from scipy.ndimage import gaussian_filter

    g = grf_2d(rng, s)
    a = np.where(g >= 0, 12.0, 3.0)
    u = solve_darcy_2d(a)
    ka = gaussian_filter(a, sigma=smooth_sigma)
    h = 1.0 / (s - 1)
    kx, ky = np.gradient(ka, h)
    return {
        "coeff": a.astype(np.float32),
        "Kcoeff": ka.astype(np.float32),
        "Kcoeff_x": kx.astype(np.float32),
        "Kcoeff_y": ky.astype(np.float32),
        "sol": u.astype(np.float32),
    }


def darcy_dataset(n: int, s: int, seed: int = 0) -> Dict[str, np.ndarray]:
    """n Darcy samples, fields stacked [n, s, s]."""
    rng = np.random.default_rng(seed)
    fields = [darcy_sample(rng, s) for _ in range(n)]
    return {k: np.stack([f[k] for f in fields]) for k in fields[0]}


__all__ = ["grf_2d", "solve_darcy_2d", "darcy_sample", "darcy_dataset"]
