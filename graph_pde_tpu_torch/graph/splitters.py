"""Split/assemble for full-resolution evaluation (counterpart of
RandomGridSplitter and DownsampleGridSplitter in
graph_pde_tpu/graph/splitters.py).

- ``RandomGridSplitter`` covers the grid with ``l`` random disjoint
  partitions into n/m subgraphs; ``assemble`` accumulates the shard
  predictions and averages the l repetitions.
- ``DownsampleGridSplitter`` covers it with the r^2 strided (x::r, y::r)
  shards, each filled with random extra nodes up to m; ``assemble``
  re-interleaves the shards and Gaussian-smooths the field.
- ``RandomMultiMeshSplitter`` walks one fixed permutation in circular
  windows, so that the finest levels of its splits tile every node once,
  and builds the full multilevel graph of each split, one compiled pass
  a window (``native.native_window_graphs``) where the library loads,
  the numpy chain of radius graphs, attributes and padding where it does
  not, with the same arrays; ``assembler`` scatters the splits'
  predictions back onto the grid.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..utils import tracing
from ..utils.filters import gaussian_filter
from . import build, native
from .graph import (Graph, MultiLevelGraph, build_graph,
                    build_multilevel_graph, multilevel_graph_from_padded,
                    round_up)
from .mesh import make_box_grid


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


class RandomMultiMeshSplitter:
    """Multilevel splits covering an s x s grid (reference: multipole-
    graph-neural-operator/utilities.py:786-1007)."""

    def __init__(self, real_space, mesh_size, level: int,
                 sample_sizes: Sequence[int], seed: Optional[int] = None):
        if len(sample_sizes) != level:
            raise ValueError("one sample size per level")
        self.d = len(real_space)
        self.ms = list(sample_sizes)
        self.m = sample_sizes[0]
        self.level = level
        self.grid = make_box_grid(real_space, mesh_size)
        self.n = self.grid.shape[0]
        self.rng = np.random.default_rng(seed)
        self.splits = -(-self.n // self.m)
        self.perm = None

    def _ring_window(self, start: int, count: int) -> np.ndarray:
        """``count`` consecutive entries of the cached permutation read
        circularly from offset ``start``. A positive multiple of n gives
        the whole (rotated) permutation: the reference's wraparound
        comparison does so when a window's two ends coincide."""
        if count % self.n == 0 and count > 0:
            count = self.n
        else:
            count %= self.n
        lo = start % self.n
        hi = lo + count
        if hi <= self.n:
            return self.perm[lo:hi]
        return np.concatenate([self.perm[lo:], self.perm[:hi - self.n]])

    def sample(self, new_sample: bool = True, index0: int = 0):
        """One split's per-level node draws: consecutive circular windows
        of one fixed permutation, sized ms[l], from ``index0`` (successive
        splits advance it by m, so their finest levels tile the grid).
        Returns (per-level id arrays, their union window)."""
        if new_sample or self.perm is None:
            self.perm = self.rng.permutation(self.n)
        per_level = []
        cursor = index0
        for size in self.ms:
            per_level.append(self._ring_window(cursor, size))
            cursor += size
        union = self._ring_window(index0, cursor - index0)
        return per_level, union

    def splitter(self, radius_inner, radius_inter, theta_a: np.ndarray,
                 theta_all: np.ndarray, caps: Optional[tuple] = None,
                 edge_multiple: int = 256
                 ) -> Tuple[List[MultiLevelGraph], tuple]:
        """One test sample -> (host MultiLevelGraphs covering the grid,
        their (mid, down, up) capacities). theta_a: [n] field of the
        edge attributes; theta_all: [n, k] node features appended to the
        coordinates. ``caps`` are minimums: a split whose edges exceed
        them grows them. Spans: ``split``, and inside it one
        ``split.connect`` a window (its radius graphs and edge
        attributes: the compiled pass, or the numpy chain) and
        ``split.pad`` (every window placed into the caps). Counters:
        ``split_native`` and ``split_numpy``, the windows each path
        built."""
        with tracing.span("split"):
            theta_a = np.asarray(theta_a).reshape(self.n)
            theta_all = np.asarray(theta_all).reshape(self.n, -1)
            raw = []
            index = 0
            for i in range(self.splits):
                with tracing.span("split.connect"):
                    idx, idx_all = self.sample(new_sample=(i == 0),
                                               index0=index)
                    raw.append(self._connect_native(
                        radius_inner, radius_inter, theta_a, theta_all,
                        idx, idx_all, slot=i))
                    if raw[-1] is None:
                        raw[-1] = self._connect(radius_inner, radius_inter,
                                                theta_a, theta_all, idx,
                                                idx_all)
                        tracing.count("split_numpy")
                    else:
                        tracing.count("split_native")
                index = (index + self.m) % self.n

            need_mid = tuple(
                round_up(max(r[0][l] for r in raw), edge_multiple)
                for l in range(self.level))
            need_down = tuple(
                round_up(max(r[1][l] for r in raw), edge_multiple)
                for l in range(self.level - 1))
            if caps is None:
                caps = (need_mid, need_down, need_down)
            else:
                caps = (tuple(max(a, b) for a, b in zip(caps[0], need_mid)),
                        tuple(max(a, b) for a, b in zip(caps[1], need_down)),
                        tuple(max(a, b) for a, b in zip(caps[2], need_down)))
            with tracing.span("split.pad"):
                graphs = self._pad(raw, caps)
        return graphs, caps

    def _connect_native(self, radius_inner, radius_inter, theta_a,
                        theta_all, idx, idx_all, slot: int):
        """A window's (mid counts, down counts, None, (x, sample ids))
        from the compiled pass, built into the thread's slot ``slot``;
        None where the library does not load or does not serve the
        window (d > 3, or levels that do not lie in one union window)."""
        if idx_all.shape[0] != sum(self.ms):
            return None
        grid_all = self.grid[idx_all]
        try:
            counts = native.native_window_graphs(
                grid_all, self.ms, radius_inner, radius_inter,
                theta_a[idx_all], slot).tolist()
        except RuntimeError:
            return None
        x = np.concatenate([grid_all, theta_all[idx_all]], axis=1)
        return (counts[:self.level], counts[self.level:2 * self.level - 1],
                None, (x, idx[0]))

    def _pad(self, raw, caps) -> List[MultiLevelGraph]:
        """Every window's MultiLevelGraph at ``caps``: the compiled
        pass's windows placed from their slots, one block a field; the
        numpy chain's padded by its own ``pad``."""
        slots = [i for i, r in enumerate(raw) if r[2] is None]
        if slots:
            n_inter = self.level - 1
            block = native.native_place_windows(
                slots, [c for group in caps for c in group],
                list(self.ms) + [sum(self.ms)] * (2 * n_inter),
                2 * self.d + 2)
            rows = {slot: row for row, slot in enumerate(slots)}
        graphs = []
        for i, (_, _, pad, (x, sample_idx)) in enumerate(raw):
            if pad is not None:
                graphs.append(pad(caps))
                continue
            graphs.append(multilevel_graph_from_padded(
                x, self.ms, *(a[rows[i]] for a in block), caps,
                sample_idx=sample_idx))
        return graphs

    def _connect(self, radius_inner, radius_inter, theta_a, theta_all,
                 idx, idx_all) -> tuple:
        """The numpy chain's (mid counts, down counts, pad, unused) of a
        window: ``pad(caps)`` pads its per-level edge lists and their
        attributes by ``build_multilevel_graph``."""
        grids = [self.grid[ids] for ids in idx]
        grid_all = self.grid[idx_all]
        th = theta_a[idx_all]

        mid_e, mid_a = [], []
        off = 0
        for l in range(self.level):
            ei = build.radius_connectivity(grids[l], radius_inner[l])
            mid_e.append(ei + off)
            mid_a.append(build.edge_attributes(grid_all, ei + off,
                                               theta=th))
            off += grids[l].shape[0]
        down_e, down_a, up_e, up_a = [], [], [], []
        off = 0
        for l in range(self.level - 1):
            ei = build.radius_connectivity(
                grids[l], radius_inter[l], points_b=grids[l + 1])
            ei = ei + off
            ei[1] += grids[l].shape[0]
            down_e.append(ei)
            up_e.append(ei[[1, 0]])
            down_a.append(build.edge_attributes(grid_all, ei, theta=th))
            up_a.append(build.edge_attributes(grid_all, ei[[1, 0]],
                                              theta=th))
            off += grids[l].shape[0]

        x = np.concatenate([grid_all, theta_all[idx_all]], axis=1)

        def pad(caps):
            return build_multilevel_graph(
                x, self.ms, mid_e, mid_a, down_e, down_a, up_e, up_a,
                sample_idx=idx[0], mid_caps=caps[0], down_caps=caps[1],
                up_caps=caps[2])

        return ([e.shape[1] for e in mid_e], [e.shape[1] for e in down_e],
                pad, (None, None))

    def assembler(self, out_list: Sequence[np.ndarray],
                  sample_idx_list: Sequence[np.ndarray]) -> np.ndarray:
        """Scatters the splits' predictions onto the full grid."""
        if not len(out_list) == len(sample_idx_list) == self.splits:
            raise ValueError("one prediction and one index set per split")
        pred = np.zeros(self.n, np.float32)
        for out, idx in zip(out_list, sample_idx_list):
            pred[np.asarray(idx).reshape(-1)] = np.asarray(out).reshape(-1)
        return pred


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

    def _connectivity(self, grid_split):
        return build.radius_connectivity(grid_split, self.radius)

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
        ei = self._connectivity(gs)
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

    _assemble_mode = "constant"

    def _interleave(self, out, p, x, y):
        """Writes shard (x, y)'s predictions [m, ...] (their prefix of
        strided nodes) into ``out`` [..., s, s]."""
        nx = (self.resolution - x + self.r - 1) // self.r
        ny = (self.resolution - y + self.r - 1) // self.r
        p = np.asarray(p)[: nx * ny]
        out[..., x::self.r, y::self.r] = np.moveaxis(p, 0, -1).reshape(
            out.shape[:-2] + (nx, ny))

    def assemble(self, preds: Sequence[np.ndarray],
                 split_xy: Sequence[Tuple[int, int]],
                 sigma: float = 1.0) -> np.ndarray:
        """Re-interleaves shard predictions (each a prefix of the shard's
        strided nodes) and smooths: [s*s]."""
        out = np.zeros((self.resolution, self.resolution), np.float32)
        for p, (x, y) in zip(preds, split_xy):
            self._interleave(out, np.asarray(p).reshape(-1), x, y)
        return gaussian_filter(out, sigma=sigma,
                               mode=self._assemble_mode).reshape(-1)


class TorusGridSplitter(DownsampleGridSplitter):
    """The periodic-domain splitter (reference: utilities.py:1153-1438):
    edges under the torus metric with edge attributes [dx, dy, dist, a_i,
    a_j] of the nearest periodic copy, wrap-mode smoothing, and T-step
    targets (``sampleT`` / ``assembleT``)."""

    _assemble_mode = "wrap"

    def __init__(self, grid, resolution, r, m=100, radius=0.15, T=None,
                 edge_features=1, seed=None):
        super().__init__(grid, resolution, r, m=m, radius=radius,
                         edge_features=edge_features, seed=seed)
        self.T = T

    def _connectivity(self, grid_split):
        ei, dist, xd, yd = build.torus2d_connectivity(grid_split,
                                                      self.radius)
        self._last_edge_geo = (dist, xd, yd)
        return ei

    def _attrs(self, grid_split, theta_split, ei):
        dist, xd, yd = self._last_edge_geo
        a = theta_split[:, : self.edge_features]
        attr = np.zeros((ei.shape[1], 3 + 2 * self.edge_features),
                        np.float32)
        attr[:, 0] = xd
        attr[:, 1] = yd
        attr[:, 2] = dist
        attr[:, 3:3 + self.edge_features] = a[ei[0]]
        attr[:, 3 + self.edge_features:] = a[ei[1]]
        return attr

    def sampleT(self, theta: np.ndarray, Y: np.ndarray,
                n_edge_pad: Optional[int] = None, edge_multiple: int = 512):
        """One random training shard with T-step targets (Y: [T, n]):
        (graph with y [m, T], (x, y))."""
        if self.T is None:
            raise ValueError("sampleT needs the splitter's T")
        theta = np.asarray(theta).reshape(self.resolution, self.resolution,
                                          -1)
        Y = np.asarray(Y).reshape(self.T, self.n)
        x = int(self.rng.integers(0, self.r))
        y = int(self.rng.integers(0, self.r))
        X, ei, attr, idx = self._raw(theta, x, y)
        e_pad = n_edge_pad or round_up(ei.shape[1], edge_multiple)
        g = build_graph(X, ei[0], ei[1], attr, y=Y[:, idx].T,
                        sample_idx=idx, n_node_pad=round_up(X.shape[0], 8),
                        n_edge_pad=e_pad)
        return g, (x, y)

    def assembleT(self, preds, split_xy, sigma: float = 1.0) -> np.ndarray:
        """Shard predictions [m, T] re-interleaved and smoothed in wrap
        mode (over t too, as the JAX package does): [T, s*s]."""
        if self.T is None:
            raise ValueError("assembleT needs the splitter's T")
        out = np.zeros((self.T, self.resolution, self.resolution),
                       np.float32)
        for p, (x, y) in zip(preds, split_xy):
            self._interleave(out, p, x, y)
        return gaussian_filter(out, sigma=sigma, mode="wrap").reshape(
            self.T, self.n)


__all__ = ["RandomGridSplitter", "RandomMultiMeshSplitter",
           "DownsampleGridSplitter", "TorusGridSplitter"]
