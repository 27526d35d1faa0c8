"""Host-side graph construction: radius graphs and edge attributes
(counterpart of graph_pde_tpu/graph/build.py).

``radius_connectivity`` keeps every pair at distance <= r, self-loops
included, with ``edge[0] = sender`` and ``edge[1] = receiver``, sorted by
(sender, receiver). ``method='tree'`` uses scipy's cKDTree; ``'dense'`` is
the exact O(n^2) threshold. Both give the same edge set as the JAX
package's builders after the final lexsort. The compiled cell-list builder
is not part of this package yet.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


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
        src, dst = _tree_radius(points, points_b, r)
    else:
        raise ValueError(f"unknown method {method!r}")
    order = np.lexsort((dst, src))
    return np.stack([src[order], dst[order]])


def forward_filter(edge_index: np.ndarray) -> np.ndarray:
    """Keeps only edges with sender >= receiver."""
    keep = edge_index[0] >= edge_index[1]
    return edge_index[:, keep]


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


__all__ = ["radius_connectivity", "forward_filter", "edge_attributes"]
