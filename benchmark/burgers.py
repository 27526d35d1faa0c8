"""Burgers inputs made from the seed with the benchmark's own NumPy code.

The initial condition is the FNO and MGKN papers' Burgers input: u0 ~
N(0, 625 (-Laplacian + 25)^(-2)) on the periodic unit interval, drawn
through its Fourier expansion at ``source_res`` points. No PDE is
solved: the target is a smoother random field of the same size (the
same expansion with the covariance's power raised), since a step's work
does not depend on its values.
"""
from __future__ import annotations

import numpy as np


def grf_periodic(rng: np.random.Generator, n: int, n_fields: int,
                 power: float = 2.0, tau: float = 5.0,
                 sigma: float = 25.0) -> np.ndarray:
    """n_fields draws of N(0, sigma^2 (-Laplacian + tau^2)^(-power)) at n
    points of the periodic unit interval: [n_fields, n] float64."""
    k = np.arange(n // 2 + 1)
    sd = sigma * ((2.0 * np.pi * k) ** 2 + tau ** 2) ** (-power / 2.0)
    xi = (rng.normal(size=(n_fields, k.size))
          + 1j * rng.normal(size=(n_fields, k.size))) / np.sqrt(2.0)
    # the mean and the Nyquist mode are real
    xi[:, 0] = rng.normal(size=n_fields)
    if n % 2 == 0:
        xi[:, -1] = rng.normal(size=n_fields)
    return np.fft.irfft(sd * xi, n=n, axis=1) * n


def burgers_fields(rng: np.random.Generator, n: int, s: int) -> dict:
    """n samples at s points: the input ``a`` (u0) and the target ``u``,
    each float32 [n, s], as the port's Burgers data holds them."""
    a = grf_periodic(rng, s, n)
    u = 0.1 * grf_periodic(rng, s, n, power=3.0)
    return {"a": a.astype(np.float32), "u": u.astype(np.float32)}
