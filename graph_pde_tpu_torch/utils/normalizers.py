"""Data normalizers (counterpart of graph_pde_tpu/utils/normalizers.py).

- ``UnitGaussianNormalizer``: per-location z-score, stats over axis 0;
  ``decode`` optionally gathers the stats at ``sample_idx``, including
  the T x batch x n case.
- ``GaussianNormalizer``: scalar (global) z-score.
- ``RangeNormalizer``: per-dimension min/max scaling to [low, high].

Standard deviations are unbiased (ddof=1) and the epsilon sits at
``(std + eps)``, as in the JAX package. Statistics are float32 tensors
computed on the device of the fitting data; ``encode``/``decode`` take
numpy arrays or tensors and return tensors on the input's device.
"""
from __future__ import annotations

import numpy as np
import torch


def _f32(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.from_numpy(np.array(x, np.float32))


def _idx(sample_idx) -> torch.Tensor:
    if isinstance(sample_idx, torch.Tensor):
        return sample_idx.long()
    return torch.as_tensor(np.asarray(sample_idx).astype(np.int64))


class UnitGaussianNormalizer:
    """Pointwise Gaussian normalizer: stats per grid location (axis 0)."""

    def __init__(self, x, eps: float = 1e-5):
        x = _f32(x)
        self.mean = x.mean(dim=0)
        self.std = x.std(dim=0)
        self.eps = eps

    def encode(self, x):
        x = _f32(x)
        return (x - self.mean.to(x.device)) / (self.std.to(x.device)
                                               + self.eps)

    def decode(self, x, sample_idx=None):
        x = _f32(x)
        mean, std = self.mean.to(x.device), self.std.to(x.device)
        if sample_idx is None:
            return x * (std + self.eps) + mean
        idx = _idx(sample_idx).to(x.device)
        # as jnp gathers: a negative index wraps once, then every index
        # is clamped into range
        n = mean.shape[-1]
        idx = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)
        if mean.ndim == idx[0].ndim:
            # mean: [n]; sample_idx: [batch, m] -> stats [batch, m]
            return x * (std[idx] + self.eps) + mean[idx]
        # mean: [T, n]; sample_idx: [batch, m] -> stats [T, batch, m]
        return x * (std[:, idx] + self.eps) + mean[:, idx]


class GaussianNormalizer:
    """Global scalar Gaussian normalizer."""

    def __init__(self, x, eps: float = 1e-5):
        x = _f32(x)
        self.mean = x.mean()
        self.std = x.std()
        self.eps = eps

    def encode(self, x):
        x = _f32(x)
        return (x - self.mean.to(x.device)) / (self.std.to(x.device)
                                               + self.eps)

    def decode(self, x, sample_idx=None):
        x = _f32(x)
        return (x * (self.std.to(x.device) + self.eps)
                + self.mean.to(x.device))


class RangeNormalizer:
    """Per-dimension min/max scaling onto [low, high]."""

    def __init__(self, x, low: float = 0.0, high: float = 1.0):
        x = _f32(x)
        flat = x.reshape(x.shape[0], -1)
        mymin = flat.min(dim=0).values
        mymax = flat.max(dim=0).values
        self.a = (high - low) / (mymax - mymin)
        self.b = -self.a * mymax + high

    def encode(self, x):
        x = _f32(x)
        s = x.shape
        out = self.a.to(x.device) * x.reshape(s[0], -1) + self.b.to(x.device)
        return out.reshape(s)

    def decode(self, x):
        x = _f32(x)
        s = x.shape
        out = (x.reshape(s[0], -1) - self.b.to(x.device)) / self.a.to(x.device)
        return out.reshape(s)


__all__ = [
    "UnitGaussianNormalizer",
    "GaussianNormalizer",
    "RangeNormalizer",
]
