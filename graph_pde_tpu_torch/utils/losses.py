"""Lp losses for operator learning (counterpart of
graph_pde_tpu/utils/losses.py).

Semantics of the reference ``LpLoss``:

- ``abs(x, y)``: grid-spacing-scaled absolute Lp norm of the difference,
  ``h**(d/p) * ||x - y||_p`` per sample, with ``h = 1/(n-1)``.
- ``rel(x, y)``: relative Lp error ``||x - y||_p / ||y||_p`` per sample.
- ``rel_masked(x, y, mask)``: ``rel`` over the valid entries of padded
  node arrays only.
- reduction: mean (``size_average=True``) or sum; ``__call__`` is
  ``rel``.
"""
from __future__ import annotations

import torch


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


def _lp_norm(x: torch.Tensor, p) -> torch.Tensor:
    if p == 2:
        return torch.sqrt(torch.sum(x * x, dim=1))
    return torch.sum(torch.abs(x) ** p, dim=1) ** (1.0 / p)


class LpLoss:
    def __init__(self, d: int = 2, p: int = 2, size_average: bool = True,
                 reduction: bool = True):
        if d <= 0 or p <= 0:
            raise ValueError("d and p must be positive")
        self.d = d
        self.p = p
        self.reduction = reduction
        self.size_average = size_average

    def _reduce(self, all_norms):
        if self.reduction:
            if self.size_average:
                return torch.mean(all_norms)
            return torch.sum(all_norms)
        return all_norms

    def abs(self, x, y):
        x, y = _as_tensor(x), _as_tensor(y)
        num = x.shape[0]
        h = 1.0 / (x.shape[1] - 1.0)
        diff = x.reshape(num, -1) - y.reshape(num, -1)
        return self._reduce((h ** (self.d / self.p)) * _lp_norm(diff, self.p))

    def rel(self, x, y):
        x, y = _as_tensor(x), _as_tensor(y)
        num = x.shape[0]
        diff_norms = _lp_norm(x.reshape(num, -1) - y.reshape(num, -1), self.p)
        y_norms = _lp_norm(y.reshape(num, -1), self.p)
        return self._reduce(diff_norms / y_norms)

    def rel_masked(self, x, y, mask):
        """Relative Lp error over valid entries only; ``mask`` [batch, n]
        (or broadcastable) is 1 at valid nodes."""
        x, y = _as_tensor(x), _as_tensor(y)
        num = x.shape[0]
        m = torch.broadcast_to(_as_tensor(mask).to(x.dtype), x.shape)
        diff_norms = _lp_norm(((x - y) * m).reshape(num, -1), self.p)
        y_norms = _lp_norm((y * m).reshape(num, -1), self.p)
        return self._reduce(diff_norms / y_norms)

    def __call__(self, x, y):
        return self.rel(x, y)


def l1_loss(pred, target, mask=None):
    """Sum of absolute errors (the UAI1 GKN training loss)."""
    diff = torch.abs(pred.reshape(-1) - target.reshape(-1))
    if mask is not None:
        diff = diff * mask.reshape(-1)
    return torch.sum(diff)


def mse_loss(pred, target, mask=None):
    """Mean squared error over the valid entries (the UAI3 GKN training
    loss)."""
    diff = (pred.reshape(-1) - target.reshape(-1)) ** 2
    if mask is None:
        return torch.mean(diff)
    m = mask.reshape(-1).to(diff.dtype)
    return torch.sum(diff * m) / torch.clamp(torch.sum(m), min=1.0)


__all__ = ["LpLoss", "l1_loss", "mse_loss"]
