"""Mesh generators: geometry -> node sets, radius graphs, edge attributes
(counterpart of graph_pde_tpu/graph/mesh.py; host numpy).

- ``SquareMeshGenerator``: regular tensor-product grid on a box.
- ``RandomMeshGenerator``: Nystrom node subsampling (m of n grid nodes).

Randomness uses ``np.random.Generator``, so a seed gives the same nodes
as the JAX package's generators.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from . import build


def make_box_grid(real_space: Sequence[Sequence[float]],
                  mesh_size: Sequence[int]) -> np.ndarray:
    """Tensor-product grid over a box, rows in np.meshgrid order."""
    d = len(real_space)
    if len(mesh_size) != d:
        raise ValueError("mesh_size must have one entry per dimension")
    if d == 1:
        n = mesh_size[0]
        return np.linspace(real_space[0][0], real_space[0][1],
                           n).reshape(n, 1)
    grids = [np.linspace(real_space[j][0], real_space[j][1], mesh_size[j])
             for j in range(d)]
    return np.vstack([xx.ravel() for xx in np.meshgrid(*grids)]).T


class SquareMeshGenerator:
    """Regular grid + radius graph."""

    def __init__(self, real_space, mesh_size):
        self.d = len(real_space)
        self.s = mesh_size[0]
        self.grid = make_box_grid(real_space, mesh_size)
        self.n = self.grid.shape[0]
        self.edge_index = None
        self.n_edges = 0

    def ball_connectivity(self, r: float, method: str = "tree") -> np.ndarray:
        self.edge_index = build.radius_connectivity(self.grid, r,
                                                    method=method)
        self.n_edges = self.edge_index.shape[1]
        return self.edge_index

    def get_grid(self) -> np.ndarray:
        return self.grid.astype(np.float32)

    def attributes(self, f=None, theta=None) -> np.ndarray:
        return build.edge_attributes(self.grid, self.edge_index,
                                     theta=theta, f=f)


class RandomMeshGenerator:
    """Nystrom subsampling generator: ``sample()`` draws m of the n grid
    nodes, the graph is built on the sampled nodes."""

    def __init__(self, real_space, mesh_size, sample_size: int,
                 attr_features: int = 1, seed: Optional[int] = None):
        self.d = len(real_space)
        self.m = sample_size
        self.attr_features = attr_features
        self.grid = make_box_grid(real_space, mesh_size)
        self.n = self.grid.shape[0]
        if self.m > self.n:
            self.m = self.n
        self.rng = np.random.default_rng(seed)
        self.idx = np.arange(self.n)
        self.grid_sample = self.grid
        self.edge_index = None
        self.n_edges = 0

    def sample(self) -> np.ndarray:
        self.idx = self.rng.permutation(self.n)[: self.m]
        self.grid_sample = self.grid[self.idx]
        return self.idx

    def get_grid(self) -> np.ndarray:
        return self.grid_sample.astype(np.float32)

    def ball_connectivity(self, r: float, is_forward: bool = False,
                          method: str = "tree") -> np.ndarray:
        ei = build.radius_connectivity(self.grid_sample, r, method=method)
        if is_forward:
            ei = build.forward_filter(ei)
        self.edge_index = ei
        self.n_edges = ei.shape[1]
        return ei

    def attributes(self, f=None, theta=None) -> np.ndarray:
        th = None if theta is None else np.asarray(theta)[self.idx]
        return build.edge_attributes(self.grid_sample, self.edge_index,
                                     theta=th, f=f)


__all__ = ["make_box_grid", "SquareMeshGenerator", "RandomMeshGenerator"]
