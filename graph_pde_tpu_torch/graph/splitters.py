"""Split/assemble for full-resolution evaluation (counterpart of
RandomGridSplitter and DownsampleGridSplitter in
graph_pde_tpu/graph/splitters.py).

- ``RandomGridSplitter`` covers the grid with ``l`` random disjoint
  partitions into n/m subgraphs; ``assemble`` accumulates the shard
  predictions and averages the l repetitions.
- ``DownsampleGridSplitter`` covers it with the r^2 strided (x::r, y::r)
  shards, each filled with random extra nodes up to m; ``assemble``
  re-interleaves the shards and Gaussian-smooths the field.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..utils.filters import gaussian_filter
from . import build
from .graph import Graph, build_graph, round_up


class RandomGridSplitter:
    def __init__(self, grid: np.ndarray, resolution: int, d: int = 2,
                 m: int = 200, l: int = 1, radius: float = 0.25,
                 seed: Optional[int] = None):
        self.grid = np.asarray(grid).reshape(resolution ** d, -1)
        self.resolution = resolution
        self.n = resolution ** d
        self.d = d
        self.m = m
        self.l = l
        self.radius = radius
        self.rng = np.random.default_rng(seed)
        if self.n % self.m:
            raise ValueError(f"m={m} must divide the {self.n} grid nodes")
        self.num = self.n // self.m

    def get_data(self, theta: np.ndarray, edge_features: int = 1,
                 edge_multiple: int = 512) -> List[Graph]:
        """One padded host ``Graph`` per shard, all of one capacity."""
        theta = np.asarray(theta).reshape(self.n, -1)
        raw = []
        for _ in range(self.l):
            perm = self.rng.permutation(self.n).reshape(self.num, self.m)
            for j in range(self.num):
                idx = perm[j]
                grid_sample = self.grid[idx]
                theta_sample = theta[idx]
                x = np.concatenate([grid_sample, theta_sample], axis=1)
                ei = build.radius_connectivity(grid_sample, self.radius)
                if edge_features == 0:
                    attr = build.edge_attributes(grid_sample, ei)
                else:
                    attr = build.edge_attributes(grid_sample, ei,
                                                 theta=theta_sample[:, 0])
                raw.append((x, ei, attr, idx))
        e_pad = round_up(max(r[1].shape[1] for r in raw), edge_multiple)
        return [
            build_graph(x, ei[0], ei[1], attr, sample_idx=idx,
                        n_node_pad=round_up(self.m, 8), n_edge_pad=e_pad)
            for (x, ei, attr, idx) in raw
        ]

    def assemble(self, preds: Sequence[np.ndarray],
                 split_idx: Sequence[np.ndarray]) -> np.ndarray:
        """preds[i]: [m] predictions on shard i (valid nodes only);
        split_idx[i]: their grid indices. Averages the l repetitions."""
        if not len(preds) == len(split_idx) == self.num * self.l:
            raise ValueError("one prediction and one index set per shard")
        out = np.zeros(self.n, np.float64)
        for p, idx in zip(preds, split_idx):
            out[np.asarray(idx).reshape(-1)] += np.asarray(p).reshape(-1)
        return (out / self.l).astype(np.float32)


class DownsampleGridSplitter:
    """Strided shards of an s x s grid (reference: multipole-graph-
    neural-operator/utilities.py:1010-1151). Shard (x, y) holds the
    nodes (x::r, y::r) and, where m exceeds their count, m minus that
    many random grid nodes; edge attributes are [x_i, x_j, a_i, a_j]."""

    def __init__(self, grid: np.ndarray, resolution: int, r: int,
                 m: int = 100, radius: float = 0.15,
                 edge_features: int = 1, seed: Optional[int] = None):
        self.grid = np.asarray(grid).reshape(resolution, resolution, 2)
        self.resolution = resolution
        self.s = (int((resolution - 1) / r) + 1 if resolution % 2 == 1
                  else int(resolution / r))
        self.r = r
        self.n = resolution ** 2
        self.m = m
        self.radius = radius
        self.edge_features = edge_features
        self.rng = np.random.default_rng(seed)
        self.index = np.arange(self.n).reshape(resolution, resolution)

    def _attrs(self, grid_split, theta_split, ei):
        a = theta_split[:, : self.edge_features]
        attr = np.zeros((ei.shape[1], 4 + 2 * self.edge_features),
                        np.float32)
        attr[:, :4] = np.concatenate(
            [grid_split[ei[0]], grid_split[ei[1]]], axis=1)
        attr[:, 4:4 + self.edge_features] = a[ei[0]]
        attr[:, 4 + self.edge_features:] = a[ei[1]]
        return attr

    def _shard(self, theta, x, y):
        theta_d = theta.shape[-1]
        grid_sub = self.grid[x::self.r, y::self.r].reshape(-1, 2)
        theta_sub = theta[x::self.r, y::self.r].reshape(-1, theta_d)
        index_sub = self.index[x::self.r, y::self.r].reshape(-1)
        if self.m < grid_sub.shape[0]:
            return grid_sub, theta_sub, index_sub
        idx = self.rng.permutation(self.n)[: self.m - grid_sub.shape[0]]
        return (np.concatenate([grid_sub, self.grid.reshape(self.n, -1)[idx]]),
                np.concatenate([theta_sub, theta.reshape(self.n, -1)[idx]]),
                np.concatenate([index_sub, idx]))

    def _raw(self, theta, x, y):
        gs, ts, idx = self._shard(theta, x, y)
        ei = build.radius_connectivity(gs, self.radius)
        return (np.concatenate([gs, ts], axis=1), ei,
                self._attrs(gs, ts, ei), idx)

    def get_data(self, theta: np.ndarray, edge_multiple: int = 512
                 ) -> List[Tuple[Graph, Tuple[int, int]]]:
        """All r^2 shards, one capacity: [(graph, (x, y)), ...]."""
        theta = np.asarray(theta).reshape(self.resolution, self.resolution,
                                          -1)
        raw = [(self._raw(theta, x, y), (x, y))
               for x in range(self.r) for y in range(self.r)]
        e_pad = round_up(max(r_[1].shape[1] for r_, _ in raw),
                         edge_multiple)
        n_pad = round_up(max(r_[0].shape[0] for r_, _ in raw), 8)
        return [(build_graph(X, ei[0], ei[1], attr, sample_idx=idx,
                             n_node_pad=n_pad, n_edge_pad=e_pad), xy)
                for (X, ei, attr, idx), xy in raw]

    def sample(self, theta: np.ndarray, Y: np.ndarray,
               n_edge_pad: Optional[int] = None, edge_multiple: int = 512):
        """One random training shard with labels: (graph, (x, y))."""
        theta = np.asarray(theta).reshape(self.resolution, self.resolution,
                                          -1)
        Y = np.asarray(Y).reshape(-1)
        x = int(self.rng.integers(0, self.r))
        y = int(self.rng.integers(0, self.r))
        X, ei, attr, idx = self._raw(theta, x, y)
        e_pad = n_edge_pad or round_up(ei.shape[1], edge_multiple)
        g = build_graph(X, ei[0], ei[1], attr, y=Y[idx], sample_idx=idx,
                        n_node_pad=round_up(X.shape[0], 8), n_edge_pad=e_pad)
        return g, (x, y)

    def assemble(self, preds: Sequence[np.ndarray],
                 split_xy: Sequence[Tuple[int, int]],
                 sigma: float = 1.0) -> np.ndarray:
        """Re-interleaves shard predictions (each a prefix of the shard's
        strided nodes) and smooths: [s*s]."""
        out = np.zeros((self.resolution, self.resolution), np.float32)
        for p, (x, y) in zip(preds, split_xy):
            nx = (self.resolution - x + self.r - 1) // self.r
            ny = (self.resolution - y + self.r - 1) // self.r
            out[x::self.r, y::self.r] = np.asarray(p).reshape(-1)[
                : nx * ny].reshape(nx, ny)
        return gaussian_filter(out, sigma=sigma, mode="constant").reshape(-1)


__all__ = ["RandomGridSplitter", "DownsampleGridSplitter"]
