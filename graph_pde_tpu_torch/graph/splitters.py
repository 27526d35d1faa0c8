"""Split/assemble for full-resolution evaluation (counterpart of
RandomGridSplitter in graph_pde_tpu/graph/splitters.py).

``RandomGridSplitter`` covers the grid with ``l`` random disjoint
partitions into n/m subgraphs; ``assemble`` accumulates the shard
predictions and averages the l repetitions.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

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


__all__ = ["RandomGridSplitter"]
