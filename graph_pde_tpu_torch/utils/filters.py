"""Separable Gaussian smoothing on regular grids (counterpart of
graph_pde_tpu/utils/filters.py), host numpy.

The reference's assemble paths smooth with ``scipy.ndimage.
gaussian_filter`` (``mode='constant'`` for DownsampleGridSplitter,
``'wrap'`` for the torus). This builds scipy's kernel, a normalised
sampled Gaussian truncated at ``int(truncate * sigma + 0.5)``, and sums
shifted slices of the padded array in float32, as the JAX version does.
"""
from __future__ import annotations

import numpy as np


def _gaussian_kernel1d(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1)
    phi = np.exp(-0.5 / (sigma * sigma) * x * x)
    return (phi / phi.sum()).astype(np.float32)


def gaussian_filter1d(x, sigma: float, axis: int = -1,
                      mode: str = "constant",
                      truncate: float = 4.0) -> np.ndarray:
    x = np.asarray(x, np.float32)
    if mode not in ("constant", "wrap"):
        raise ValueError(f"unsupported mode: {mode}")
    radius = int(truncate * float(sigma) + 0.5)
    if radius == 0:
        return x
    w = _gaussian_kernel1d(sigma, radius)
    axis = axis % x.ndim
    pad = [(0, 0)] * x.ndim
    pad[axis] = (radius, radius)
    xp = np.pad(x, pad, mode=mode)
    n = x.shape[axis]
    out = np.zeros_like(x)
    for k in range(2 * radius + 1):
        out = out + w[k] * np.take(xp, np.arange(k, k + n), axis=axis)
    return out


def gaussian_filter(x, sigma: float, mode: str = "constant",
                    truncate: float = 4.0) -> np.ndarray:
    """N-d separable Gaussian filter over every axis, scipy-compatible."""
    x = np.asarray(x, np.float32)
    for ax in range(x.ndim):
        x = gaussian_filter1d(x, sigma, axis=ax, mode=mode,
                              truncate=truncate)
    return x


__all__ = ["gaussian_filter", "gaussian_filter1d"]
