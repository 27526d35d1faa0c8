"""Masked segment reductions over padded edge lists (counterpart of
graph_pde_tpu/ops/segment.py).

Plain ``index_add_`` forms: the one-hot, block-local one-hot and
sender-sorted forms of the JAX package exist because XLA lowers a TPU
scatter to a serial loop; a GPU scatter-add has no such cliff.
"""
from __future__ import annotations

import torch


def _expand(m: torch.Tensor, ndim: int) -> torch.Tensor:
    return m.reshape(m.shape + (1,) * (ndim - m.ndim))


def masked_segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                       mask: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Sum of ``data`` rows per segment, counting only masked-in rows."""
    m = _expand(mask.to(data.dtype), data.ndim)
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add_(0, segment_ids, data * m)


def segment_counts(segment_ids: torch.Tensor, mask: torch.Tensor,
                   num_segments: int) -> torch.Tensor:
    """Valid rows per segment, clamped to 1 (PyG scatter_mean divisor),
    float32 [num_segments]."""
    return segment_degrees(segment_ids, mask, num_segments).clamp_min(1.0)


def segment_degrees(segment_ids: torch.Tensor, mask: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """Valid rows per segment (the mask-weighted in-degree), float32
    [num_segments], not clamped."""
    deg = torch.zeros(num_segments, dtype=torch.float32,
                      device=segment_ids.device)
    return deg.index_add_(0, segment_ids, mask.to(torch.float32))


def masked_segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                        mask: torch.Tensor,
                        num_segments: int) -> torch.Tensor:
    """Scatter-mean with PyG semantics: a segment with no valid row gets
    zeros (its count is clamped to 1)."""
    total = masked_segment_sum(data, segment_ids, mask, num_segments)
    counts = segment_counts(segment_ids, mask, num_segments)
    return total / _expand(counts, total.ndim).to(total.dtype)


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[idx] along the first axis."""
    return x.index_select(0, idx)


__all__ = ["masked_segment_sum", "masked_segment_mean", "segment_counts",
           "segment_degrees", "gather_rows"]
