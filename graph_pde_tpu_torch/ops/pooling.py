"""1-d inter-level transfers of the orthogonal MGKN (counterpart of
graph_pde_tpu/ops/pooling.py).

Nearest-neighbor upsampling and non-overlapping average pooling along
the node axis, the second-to-last one: [n, c] or batched [B, n, c].
"""
from __future__ import annotations

import torch


def upsample_nearest_1d(x: torch.Tensor, scale: int = 2) -> torch.Tensor:
    """[..., n, c] -> [..., n * scale, c], each node repeated."""
    return x.repeat_interleave(scale, dim=-2)


def avg_pool_1d(x: torch.Tensor, scale: int = 2) -> torch.Tensor:
    """[..., n, c] -> [..., n // scale, c], the mean of each run of
    ``scale`` nodes."""
    *lead, n, c = x.shape
    return x.reshape(*lead, n // scale, scale, c).mean(dim=-2)


__all__ = ["upsample_nearest_1d", "avg_pool_1d"]
