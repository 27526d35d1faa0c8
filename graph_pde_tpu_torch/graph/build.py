"""Host-side graph construction: radius graphs and edge attributes
(counterpart of graph_pde_tpu/graph/build.py).

``radius_connectivity`` keeps every pair at distance <= r, self-loops
included, with ``edge[0] = sender`` and ``edge[1] = receiver``, sorted by
(sender, receiver). ``method='tree'`` tries the compiled cell-list builder
(``graph.native``, built with g++ at first use) and falls back to scipy's
cKDTree where no toolchain exists; ``'dense'`` is the exact O(n^2)
threshold. All three give the same edge set as the JAX package's
builders after the final lexsort. While a recording is open
(``utils.tracing``) the counters ``radius_native`` and ``radius_tree``
count the calls each builder answered, and ``radius_edges`` the edges
returned.

``torus2d_connectivity`` keeps the true periodic metric on [0, 1]^2 (the
minimum over all 9 shifted copies), where the reference's aliasing of its
grid degenerates it to the euclidean one.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..utils import tracing
from . import native


def _dense_radius(points_a: np.ndarray, points_b: Optional[np.ndarray],
                  r: float):
    b = points_a if points_b is None else points_b
    d = np.linalg.norm(points_a[:, None, :] - b[None, :, :], axis=-1)
    src, dst = np.where(d <= r)
    return src.astype(np.int64), dst.astype(np.int64)


def _tree_radius(points_a: np.ndarray, points_b: Optional[np.ndarray],
                 r: float):
    from scipy.spatial import cKDTree

    tree_b = cKDTree(points_a if points_b is None else points_b)
    tree_a = cKDTree(points_a)
    coo = tree_a.sparse_distance_matrix(tree_b, r, output_type="coo_matrix")
    return coo.row.astype(np.int64), coo.col.astype(np.int64)


def radius_connectivity(
    points: np.ndarray,
    r: float,
    points_b: Optional[np.ndarray] = None,
    method: str = "tree",
) -> np.ndarray:
    """Edges (2, E) between all pairs with distance <= r; with
    ``points_b`` the bipartite graph from ``points`` rows to ``points_b``
    columns."""
    points = np.ascontiguousarray(points, np.float64)
    if points.ndim == 1:
        points = points[:, None]
    if points_b is not None:
        points_b = np.ascontiguousarray(points_b, np.float64)
        if points_b.ndim == 1:
            points_b = points_b[:, None]
    if method == "dense":
        src, dst = _dense_radius(points, points_b, r)
    elif method == "tree":
        try:
            src, dst = native.native_radius(points, points_b, r)
        except RuntimeError:
            src, dst = _tree_radius(points, points_b, r)
            tracing.count("radius_tree")
        else:
            tracing.count("radius_native")
    else:
        raise ValueError(f"unknown method {method!r}")
    tracing.count("radius_edges", len(src))
    order = np.lexsort((dst, src))
    return np.stack([src[order], dst[order]])


def forward_filter(edge_index: np.ndarray) -> np.ndarray:
    """Keeps only edges with sender >= receiver."""
    keep = edge_index[0] >= edge_index[1]
    return edge_index[:, keep]


def gaussian_connectivity(points: np.ndarray, sigma: float,
                          rng: Optional[np.random.Generator] = None
                          ) -> np.ndarray:
    """Bernoulli-RBF random graph: edge (i, j) with probability
    exp(-|x_i - x_j|^2 / sigma^2), one ``rng.binomial`` draw over the
    dense matrix (so one seed gives the JAX package's edge set)."""
    rng = rng or np.random.default_rng()
    points = np.asarray(points, np.float64)
    d = np.linalg.norm(points[:, None, :] - points[None, :, :], axis=-1)
    rbf = np.exp(-(d ** 2) / sigma ** 2)
    sample = rng.binomial(1, rbf)
    src, dst = np.where(sample)
    return np.stack([src.astype(np.int64), dst.astype(np.int64)])


def torus1d_connectivity(points: np.ndarray, r: float) -> np.ndarray:
    """Radius graph under the 1-d periodic metric on [0, 1]."""
    points = np.asarray(points, np.float64).reshape(-1, 1)
    diff = np.abs(points[:, None, 0] - points[None, :, 0])
    d = np.minimum(diff, 1.0 - diff)
    src, dst = np.where(d <= r)
    return np.stack([src.astype(np.int64), dst.astype(np.int64)])


def torus2d_connectivity(points: np.ndarray, r: float
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                    np.ndarray]:
    """Radius graph and periodic differences on the 2-torus [0, 1]^2.

    Minimizes over the 9 shifted copies (sx, sy in {-1, 0, 1}) and returns
    (edge_index [2, E], dist, dx, dy) of the argmin copy, with dx, dy the
    signed differences x_i - shifted(x_j), sorted by (src, dst). The
    compiled builder runs first; the dense numpy path, with the same
    float64 operations, where no toolchain exists.
    """
    grid = np.asarray(points, np.float64).reshape(-1, 2)
    try:
        return native.native_torus2d(grid, r)
    except RuntimeError:
        pass
    return _dense_torus2d(grid, r)


def _dense_torus2d(grid: np.ndarray, r: float):
    shifts = np.array([[sx, sy] for sx in (0.0, 1.0, -1.0)
                       for sy in (0.0, 1.0, -1.0)])
    x_diffs, y_diffs, dists = [], [], []
    for s in shifts:
        shifted = grid + s[None, :]
        dx = grid[:, None, 0] - shifted[None, :, 0]
        dy = grid[:, None, 1] - shifted[None, :, 1]
        x_diffs.append(dx)
        y_diffs.append(dy)
        dists.append(np.sqrt(dx * dx + dy * dy))
    pwd = np.stack(dists, axis=2)
    xd = np.stack(x_diffs, axis=2)
    yd = np.stack(y_diffs, axis=2)
    dmin = pwd.min(axis=2)
    amin = pwd.argmin(axis=2)
    src, dst = np.where(dmin <= r)
    sel = (src, dst, amin[src, dst])
    edge_index = np.stack([src.astype(np.int64), dst.astype(np.int64)])
    return edge_index, pwd[sel], xd[sel], yd[sel]


def edge_attributes(
    grid: np.ndarray,
    edge_index: np.ndarray,
    theta: Optional[np.ndarray] = None,
    f=None,
) -> np.ndarray:
    """Edge features [x_src, x_dst, theta_src, theta_dst] (float32).

    The first 2d columns are the endpoint coordinates; with ``theta`` the
    trailing columns are the per-endpoint theta values. ``f`` is an
    optional custom map f(x_src, x_dst[, th_src, th_dst]).
    """
    grid = np.asarray(grid, np.float64)
    if grid.ndim == 1:
        grid = grid[:, None]
    d = grid.shape[1]
    src, dst = edge_index[0], edge_index[1]
    xy = np.concatenate([grid[src], grid[dst]], axis=1)
    if f is not None:
        if theta is None:
            out = f(xy[:, :d], xy[:, d:])
        else:
            theta = np.asarray(theta)
            out = f(xy[:, :d], xy[:, d:], theta[src], theta[dst])
        return np.asarray(out, np.float32)
    if theta is None:
        return xy.astype(np.float32)
    theta = np.asarray(theta)
    if theta.ndim == 1:
        theta = theta[:, None]
    k = theta.shape[1]
    out = np.zeros((edge_index.shape[1], 2 * d + 2 * k), np.float64)
    out[:, : 2 * d] = xy
    out[:, 2 * d: 2 * d + k] = theta[src]
    out[:, 2 * d + k:] = theta[dst]
    return out.astype(np.float32)


__all__ = ["radius_connectivity", "forward_filter", "gaussian_connectivity",
           "torus1d_connectivity", "torus2d_connectivity",
           "edge_attributes"]
