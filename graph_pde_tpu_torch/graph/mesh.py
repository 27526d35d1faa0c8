"""Mesh generators: geometry -> node sets, radius graphs, edge attributes
(counterpart of graph_pde_tpu/graph/mesh.py; host numpy).

- ``SquareMeshGenerator``: regular tensor-product grid on a box.
- ``RandomMeshGenerator``: Nystrom node subsampling (m of n grid nodes).
- ``RandomTwoMeshGenerator``: two-level inducing-point graphs.
- ``RandomMultiMeshGenerator``: L-level multipole hierarchies, with
  intra-level and inter-level radius graphs, concatenated edge arrays
  and per-level ranges (the general MGKN's graphs).

Randomness uses ``np.random.Generator``, so a seed gives the same nodes
and edges as the JAX package's generators, bit for bit.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

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

    def gaussian_connectivity(self, sigma: float, rng=None) -> np.ndarray:
        self.edge_index = build.gaussian_connectivity(self.grid, sigma, rng)
        self.n_edges = self.edge_index.shape[1]
        return self.edge_index

    def get_grid(self) -> np.ndarray:
        return self.grid.astype(np.float32)

    def attributes(self, f=None, theta=None) -> np.ndarray:
        return build.edge_attributes(self.grid, self.edge_index,
                                     theta=theta, f=f)

    def get_boundary(self) -> np.ndarray:
        """Indices of the 2-d grid's boundary nodes: first row, last row,
        then the first and last column (corners repeated)."""
        s, n = self.s, self.n
        self.boundary = np.concatenate([
            np.arange(0, s), np.arange(n - s, n), np.arange(s, n, s),
            np.arange(2 * s - 1, n, s)])
        return self.boundary

    def boundary_connectivity2d(self, stride: int = 1) -> np.ndarray:
        """Edges from every ``stride``-th boundary node to every node."""
        boundary = self.boundary[::stride]
        v1 = np.repeat(np.arange(self.n), len(boundary))
        v2 = np.tile(boundary, self.n)
        self.edge_index_boundary = np.stack([v2, v1])
        self.n_edges_boundary = self.edge_index_boundary.shape[1]
        return self.edge_index_boundary

    def attributes_boundary(self, f=None, theta=None) -> np.ndarray:
        return build.edge_attributes(self.grid, self.edge_index_boundary,
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

    def torus1d_connectivity(self, r: float) -> np.ndarray:
        self.edge_index = build.torus1d_connectivity(self.grid_sample, r)
        self.n_edges = self.edge_index.shape[1]
        return self.edge_index

    def gaussian_connectivity(self, sigma: float) -> np.ndarray:
        """Bernoulli-RBF graph on the sampled nodes, drawn from the
        generator's own rng."""
        self.edge_index = build.gaussian_connectivity(
            self.grid_sample, sigma, self.rng)
        self.n_edges = self.edge_index.shape[1]
        return self.edge_index

    def attributes(self, f=None, theta=None) -> np.ndarray:
        th = None if theta is None else np.asarray(theta)[self.idx]
        return build.edge_attributes(self.grid_sample, self.edge_index,
                                     theta=th, f=f)


class RandomTwoMeshGenerator:
    """Two-level inducing-point graphs: one permutation split into a fine
    set (m) and an induced set (m_i); K11/K12/K21/K22 edge sets at radii
    r11/r12/r22, indices offset so both levels live in one node array."""

    def __init__(self, real_space, mesh_size, sample_size: int,
                 induced_point: int, seed: Optional[int] = None):
        self.d = len(real_space)
        self.m = sample_size
        self.m_i = induced_point
        self.grid = make_box_grid(real_space, mesh_size)
        self.n = self.grid.shape[0]
        if self.m > self.n:
            self.m = self.n
        self.rng = np.random.default_rng(seed)
        self.idx = np.arange(self.n)
        self.idx_i = self.idx
        self.idx_both = self.idx
        self.grid_sample = self.grid
        self.grid_sample_i = self.grid
        self.grid_sample_both = self.grid

    def sample(self):
        perm = self.rng.permutation(self.n)
        self.idx = perm[: self.m]
        self.idx_i = perm[self.m: self.m + self.m_i]
        self.idx_both = perm[: self.m + self.m_i]
        self.grid_sample = self.grid[self.idx]
        self.grid_sample_i = self.grid[self.idx_i]
        self.grid_sample_both = self.grid[self.idx_both]
        return self.idx, self.idx_i, self.idx_both

    def get_grid(self):
        return (self.grid_sample.astype(np.float32),
                self.grid_sample_i.astype(np.float32),
                self.grid_sample_both.astype(np.float32))

    def ball_connectivity(self, r11: float, r12: float, r22: float):
        ei = build.radius_connectivity(self.grid_sample, r11)
        ei12 = build.radius_connectivity(self.grid_sample, r12,
                                         points_b=self.grid_sample_i)
        ei12 = ei12.copy()
        ei12[1, :] += self.m
        ei21 = ei12[[1, 0], :]
        ei22 = build.radius_connectivity(self.grid_sample_i, r22) + self.m
        self.edge_index = ei
        self.edge_index_12 = ei12
        self.edge_index_21 = ei21
        self.edge_index_22 = ei22
        return ei, ei12, ei21, ei22

    def attributes(self, theta=None):
        th = None if theta is None else np.asarray(theta)[self.idx_both]
        return tuple(
            build.edge_attributes(self.grid_sample_both, ei, theta=th)
            for ei in (self.edge_index, self.edge_index_12,
                       self.edge_index_21, self.edge_index_22))


class RandomMultiMeshGenerator:
    """L-level multipole graph generator: one permutation partitioned
    into per-level node sets; intra-level radius graphs at
    ``radius_inner[l]`` and inter-level down edges at
    ``radius_inter[l]`` (up = down with its rows swapped). Edge arrays
    come concatenated, with per-level [start, end) ranges."""

    def __init__(self, real_space, mesh_size, level: int,
                 sample_sizes: Sequence[int], seed: Optional[int] = None):
        if len(sample_sizes) != level:
            raise ValueError("one sample size per level")
        self.d = len(real_space)
        self.m = list(sample_sizes)
        self.level = level
        self.grid = make_box_grid(real_space, mesh_size)
        self.n = self.grid.shape[0]
        self.rng = np.random.default_rng(seed)
        self.idx: List[np.ndarray] = []
        self.idx_all = None
        self.grid_sample: List[np.ndarray] = []
        self.grid_sample_all = None
        self.edge_index: List[np.ndarray] = []
        self.edge_index_down: List[np.ndarray] = []
        self.edge_index_up: List[np.ndarray] = []
        self.n_edges_inner: List[int] = []
        self.n_edges_inter: List[int] = []

    def sample(self):
        self.idx = []
        self.grid_sample = []
        perm = self.rng.permutation(self.n)
        index = 0
        for l in range(self.level):
            self.idx.append(perm[index: index + self.m[l]])
            self.grid_sample.append(self.grid[self.idx[l]])
            index += self.m[l]
        self.idx_all = perm[:index]
        self.grid_sample_all = self.grid[self.idx_all]
        return self.idx, self.idx_all

    def get_grid(self):
        return ([g.astype(np.float32) for g in self.grid_sample],
                self.grid_sample_all.astype(np.float32))

    def ball_connectivity(self, radius_inner: Sequence[float],
                          radius_inter: Sequence[float]):
        if len(radius_inner) != self.level \
                or len(radius_inter) != self.level - 1:
            raise ValueError("one inner radius per level and one inter "
                             "radius per pair of levels")
        self.edge_index = []
        self.edge_index_down = []
        self.edge_index_up = []
        self.n_edges_inner = []
        self.n_edges_inter = []

        index = 0
        for l in range(self.level):
            ei = build.radius_connectivity(self.grid_sample[l],
                                           radius_inner[l]) + index
            self.edge_index.append(ei)
            self.n_edges_inner.append(ei.shape[1])
            index += self.grid_sample[l].shape[0]

        index = 0
        for l in range(self.level - 1):
            ei = build.radius_connectivity(
                self.grid_sample[l], radius_inter[l],
                points_b=self.grid_sample[l + 1])
            ei = ei + index
            ei[1, :] += self.grid_sample[l].shape[0]
            self.edge_index_down.append(ei)
            self.edge_index_up.append(ei[[1, 0], :])
            self.n_edges_inter.append(ei.shape[1])
            index += self.grid_sample[l].shape[0]

        empty = np.zeros((2, 0), np.int64)
        return (np.concatenate(self.edge_index, axis=1),
                np.concatenate(self.edge_index_down, axis=1)
                if self.edge_index_down else empty,
                np.concatenate(self.edge_index_up, axis=1)
                if self.edge_index_up else empty)

    def get_edge_index_range(self):
        rng_mid = np.zeros((self.level, 2), np.int64)
        rng_down = np.zeros((self.level - 1, 2), np.int64)
        rng_up = np.zeros((self.level - 1, 2), np.int64)
        acc = 0
        for l in range(self.level):
            rng_mid[l, 0] = acc
            acc += self.edge_index[l].shape[1]
            rng_mid[l, 1] = acc
        acc = 0
        for l in range(self.level - 1):
            rng_down[l, 0] = acc
            rng_up[l, 0] = acc
            acc += self.edge_index_down[l].shape[1]
            rng_down[l, 1] = acc
            rng_up[l, 1] = acc
        return rng_mid, rng_down, rng_up

    def attributes(self, theta=None):
        th = None if theta is None else np.asarray(theta)[self.idx_all]
        attr = [build.edge_attributes(self.grid_sample_all, ei, theta=th)
                for ei in self.edge_index]
        attr_down = [build.edge_attributes(self.grid_sample_all, ei,
                                           theta=th)
                     for ei in self.edge_index_down]
        attr_up = [build.edge_attributes(self.grid_sample_all, ei, theta=th)
                   for ei in self.edge_index_up]
        empty = np.zeros((0, attr[0].shape[1]), np.float32)
        return (np.concatenate(attr, axis=0),
                np.concatenate(attr_down, axis=0) if attr_down else empty,
                np.concatenate(attr_up, axis=0) if attr_up else empty)


__all__ = ["make_box_grid", "SquareMeshGenerator", "RandomMeshGenerator",
           "RandomTwoMeshGenerator", "RandomMultiMeshGenerator"]
