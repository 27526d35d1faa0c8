"""Synthetic Darcy flow and viscous Burgers data (counterpart of
graph_pde_tpu/data/synthetic.py; host numpy/scipy, deterministic given a
seed, the same numbers as the JAX package's generator).

- Darcy 2-d: a(x) is piecewise constant (12/3) from a thresholded
  Gaussian random field with covariance (-Laplacian + tau^2)^(-alpha); u
  solves -div(a grad u) = 1 with zero Dirichlet boundary (5-point finite
  differences, harmonic-mean coefficients, sparse direct solve). Kcoeff
  is the Gaussian-smoothed coefficient and Kcoeff_x/y its
  central-difference gradients: the node features GKN consumes.
- Burgers 1-d: u_t + u u_x = nu u_xx on the torus, a periodic GRF
  initial condition, integrated to t = 1 by a Fourier spectral method
  (integrating factor + RK4), nu = 0.01 by default (the JAX package's
  choice: at nu = 0.1 the t=1 solution has decayed to a few percent).
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


def grf_1d(rng: np.random.Generator, s: int, alpha: float = 2.0,
           tau: float = 5.0, sigma: float = 25.0) -> np.ndarray:
    """Periodic 1-d GRF ~ N(0, sigma^2 (-Lap + tau^2 I)^(-alpha))."""
    k = np.fft.fftfreq(s, d=1.0 / s)
    sqrt_eig = sigma * ((2 * np.pi * k) ** 2 + tau ** 2) ** (-alpha / 2.0)
    sqrt_eig[0] = 0.0
    noise = rng.normal(size=s) + 1j * rng.normal(size=s)
    # the ifft's 1/s is cancelled by the factor s
    field = (np.fft.ifft(sqrt_eig * noise) * s).real
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


def solve_burgers_1d(u0: np.ndarray, nu: float = 0.01, t_final: float = 1.0,
                     n_steps: int = 500) -> np.ndarray:
    """Viscous Burgers on the torus [0,1): spectral integrating-factor
    RK4."""
    s = u0.shape[0]
    k = 2 * np.pi * np.fft.fftfreq(s, d=1.0 / s)
    ik = 1j * k
    lin = -nu * k ** 2
    dt = t_final / n_steps
    E = np.exp(lin * dt)
    E2 = np.exp(lin * dt / 2)

    def nonlin(v_hat):
        u = np.fft.ifft(v_hat).real
        return -0.5 * ik * np.fft.fft(u * u)

    v = np.fft.fft(u0)
    for _ in range(n_steps):
        a_ = nonlin(v)
        b_ = nonlin(E2 * (v + dt / 2 * a_))
        c_ = nonlin(E2 * v + dt / 2 * b_)
        d_ = nonlin(E * v + dt * E2 * c_)
        v = E * v + dt / 6 * (E * a_ + 2 * E2 * (b_ + c_) + d_)
    return np.fft.ifft(v).real.astype(np.float64)


def burgers_dataset(n: int, s: int, nu: float = 0.01, seed: int = 0,
                    gen_res: int = 4096) -> Dict[str, np.ndarray]:
    """n Burgers pairs (a = initial condition, u = solution at t=1),
    generated at gen_res (raised to s when s exceeds it) and subsampled
    to s. Fields [n, s] float32."""
    rng = np.random.default_rng(seed)
    gen_res = max(gen_res, s)
    if gen_res % s:
        raise ValueError(f"s={s} does not divide the generation grid "
                         f"{gen_res}")
    r = gen_res // s
    a_out = np.zeros((n, s), np.float32)
    u_out = np.zeros((n, s), np.float32)
    for i in range(n):
        a0 = grf_1d(rng, gen_res)
        u1 = solve_burgers_1d(a0, nu=nu)
        a_out[i] = a0[::r]
        u_out[i] = u1[::r]
    return {"a": a_out, "u": u_out}


__all__ = ["grf_2d", "solve_darcy_2d", "darcy_sample", "darcy_dataset",
           "grf_1d", "solve_burgers_1d", "burgers_dataset"]
