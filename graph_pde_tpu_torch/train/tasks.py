"""Task adapters binding a model family to the trainer (counterpart of
graph_pde_tpu/train/tasks.py): GKN, GCN, and the general and orthogonal
MGKN."""
from __future__ import annotations

import torch

from ..models.gcn import GCNConfig, gcn_apply, gcn_apply_batched
from ..models.gkn import GKNConfig, gkn_apply_batched
from ..models.mgkn_general import (MGKNGeneralConfig,
                                   mgkn_general_apply_batched)
from ..models.mgkn_orthogonal import (MGKNOrthogonalConfig,
                                      mgkn_orthogonal_apply_batched)
from .trainer import Task


def _node_mask_batched(graphs) -> torch.Tensor:
    n_pad = graphs.x.shape[-2]
    ar = torch.arange(n_pad, device=graphs.x.device)
    return ar[None, :] < graphs.n_node[:, None]


class _NormalizerDecodeMixin:
    """Decode through a fitted normalizer, gathering per-node stats at
    sample_idx for Nystrom-subsampled outputs."""

    u_normalizer = None
    use_sample_idx = True

    def decode(self, values, batch):
        if self.u_normalizer is None:
            return values
        idx = getattr(batch, "sample_idx", None)
        if self.use_sample_idx and idx is not None:
            return self.u_normalizer.decode(values, sample_idx=idx)
        return self.u_normalizer.decode(values)


class GKNTask(_NormalizerDecodeMixin, Task):
    def __init__(self, cfg: GKNConfig, u_normalizer=None, loss_type="l1",
                 use_sample_idx=True):
        self.cfg = cfg
        self.u_normalizer = u_normalizer
        self.loss_type = loss_type
        self.use_sample_idx = use_sample_idx

    def forward(self, params, batch):
        return gkn_apply_batched(params, self.cfg, batch)

    def mask(self, batch):
        return _node_mask_batched(batch)


class GCNTask(_NormalizerDecodeMixin, Task):
    """``template``: a Graph whose edges every sample shares (the
    full-grid lattice, neurips4_GCN.py:133), as tensors on the task's
    device; batches are then ``NodeBatch``es carrying only per-sample
    node data. Without a template, batches are stacked Graphs."""

    def __init__(self, cfg: GCNConfig, u_normalizer=None, loss_type="l1",
                 use_sample_idx=True, template=None):
        self.cfg = cfg
        self.u_normalizer = u_normalizer
        self.loss_type = loss_type
        self.use_sample_idx = use_sample_idx
        self.template = template

    def forward(self, params, batch):
        if self.template is not None:
            return gcn_apply(params, self.cfg, self.template, x=batch.x)
        return gcn_apply_batched(params, self.cfg, batch)

    def mask(self, batch):
        return _node_mask_batched(batch)


class MGKNGeneralTask(_NormalizerDecodeMixin, Task):
    """Predictions and targets live on the finest level (no node
    padding)."""

    def __init__(self, cfg: MGKNGeneralConfig, u_normalizer=None,
                 loss_type="rel2", use_sample_idx=True):
        self.cfg = cfg
        self.u_normalizer = u_normalizer
        self.loss_type = loss_type
        self.use_sample_idx = use_sample_idx

    def forward(self, params, batch):
        return mgkn_general_apply_batched(params, self.cfg, batch)

    def mask(self, batch):
        b = batch.y.shape[0]
        return torch.ones((b, self.cfg.points[0]), dtype=torch.float32,
                          device=batch.y.device)


class MGKNOrthogonalTask(_NormalizerDecodeMixin, Task):
    def __init__(self, cfg: MGKNOrthogonalConfig, u_normalizer=None,
                 loss_type="rel2"):
        self.cfg = cfg
        self.u_normalizer = u_normalizer
        self.loss_type = loss_type
        self.use_sample_idx = False  # full-grid outputs

    def forward(self, params, batch):
        return mgkn_orthogonal_apply_batched(params, self.cfg, batch)

    def mask(self, batch):
        b = batch.x.shape[0]
        return torch.ones((b, self.cfg.s), dtype=torch.float32,
                          device=batch.x.device)


__all__ = ["GKNTask", "GCNTask", "MGKNGeneralTask", "MGKNOrthogonalTask"]
