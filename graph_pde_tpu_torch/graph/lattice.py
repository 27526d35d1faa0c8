"""Lattice (grid) graph constructors (counterpart of
graph_pde_tpu/graph/lattice.py; numpy only, so every array equals the
JAX package's bit for bit).

Vectorized rewrites of the reference's loop-based lattice functions
(multipole-graph-neural-operator/utilities.py:1448-1699): 4-neighbor
grids with direction, coefficient or hand-engineered RBF edge features,
the periodic 1-d lattice, and the nested dyadic multigrid.

Node indexing follows the reference: node i = y * n_x + x (row = y,
column = x), with grid coordinates from ``np.meshgrid(xs, ys)``
stacking.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _mesh_grid(n_x: int, n_y: int) -> np.ndarray:
    xs = np.linspace(0.0, 1.0, n_x)
    ys = np.linspace(0.0, 1.0, n_y)
    return np.vstack([xx.ravel() for xx in np.meshgrid(xs, ys)]).T


def _lattice_pairs(n_x: int, n_y: int):
    """(i, i+1) horizontal and (i, i+n_x) vertical neighbor pairs with the
    (x, y) coordinates of the source cell, iterated like the reference."""
    ys, xs = np.meshgrid(np.arange(n_y), np.arange(n_x), indexing="ij")
    i = (ys * n_x + xs).ravel()
    x = xs.ravel()
    y = ys.ravel()
    right = x != n_x - 1
    up = y != n_y - 1
    return i, x, y, right, up


def simple_grid(n_x: int, n_y: int):
    """4-neighbor lattice with one-hot direction edge attrs
    (utilities.py:1448-1477)."""
    grid = _mesh_grid(n_x, n_y)
    i, x, y, right, up = _lattice_pairs(n_x, n_y)
    ih, iv = i[right], i[up]
    edge_index = np.concatenate([
        np.stack([ih, ih + 1]), np.stack([ih + 1, ih]),
        np.stack([iv, iv + n_x]), np.stack([iv + n_x, iv]),
    ], axis=1)
    attrs = np.concatenate([
        np.tile([1, 0, 0], (ih.size, 1)), np.tile([-1, 0, 0], (ih.size, 1)),
        np.tile([0, 1, 0], (iv.size, 1)), np.tile([0, -1, 0], (iv.size, 1)),
    ], axis=0).astype(np.float32)
    return grid.astype(np.float32), edge_index.astype(np.int64), attrs


def grid_edge(n_x: int, n_y: int, a: Optional[np.ndarray] = None):
    """Lattice with [x/n_x, y/n_y, a_src, a_dst] edge attrs
    (utilities.py:1480-1520). Note the reference indexes the coefficient as
    a[x, y] after reshape(n_x, n_y)."""
    grid = _mesh_grid(n_x, n_y)
    i, x, y, right, up = _lattice_pairs(n_x, n_y)
    ih, xh, yh = i[right], x[right], y[right]
    iv, xv, yv = i[up], x[up], y[up]
    edge_index = np.concatenate([
        np.stack([ih, ih + 1]), np.stack([ih + 1, ih]),
        np.stack([iv, iv + n_x]), np.stack([iv + n_x, iv]),
    ], axis=1).astype(np.int64)
    if a is None:
        return grid.astype(np.float32), edge_index, None
    a = np.asarray(a).reshape(n_x, n_y)
    a1h, a2h = a[xh, yh], a[np.minimum(xh + 1, n_x - 1), yh]
    a1v, a2v = a[xv, yv], a[xv, np.minimum(yv + 1, n_y - 1)]
    attrs = np.concatenate([
        np.stack([xh / n_x, yh / n_y, a1h, a2h], 1),
        np.stack([yh / n_y, xh / n_x, a2h, a1h], 1),
        np.stack([xv / n_x, yv / n_y, a1v, a2v], 1),
        np.stack([yv / n_y, xv / n_x, a2v, a1v], 1),
    ], axis=0).astype(np.float32)
    return grid.astype(np.float32), edge_index, attrs


def grid_edge1d(n_x: int, a: Optional[np.ndarray] = None):
    """Periodic 1-d lattice with 1- and 2-hop edges (utilities.py:1522-1554)."""
    xs = np.linspace(0.0, 1.0, n_x)
    idx = np.arange(n_x)
    i1 = (idx + 1) % n_x
    i2 = (idx + 2) % n_x
    edge_index = np.concatenate([
        np.stack([idx, i1]), np.stack([i1, idx]),
        np.stack([idx, i2]), np.stack([i2, idx]),
    ], axis=1).astype(np.int64)
    attrs = None
    if a is not None:
        a = np.asarray(a).reshape(n_x)
        a1 = a[idx]
        a2 = a[(idx + 1) % n_x]
        attrs = np.concatenate([
            np.stack([idx / n_x, a1, a2], 1),
            np.stack([idx / n_x, a2, a1], 1),
        ], axis=0).astype(np.float32)
    return xs.astype(np.float32), edge_index, attrs


def _aug_features(d, a1, a2):
    return np.stack([
        np.broadcast_to(d, a1.shape), a1, a2,
        1.0 / np.sqrt(np.abs(a1 * a2)),
        np.exp(-np.broadcast_to(d, a1.shape) ** 2),
        np.exp(-(np.broadcast_to(d, a1.shape) / 0.1) ** 2),
        np.exp(-(np.broadcast_to(d, a1.shape) / 0.01) ** 2),
    ], axis=1)


def grid_edge_aug(n_x: int, n_y: int, a: np.ndarray):
    """Lattice with augmented RBF features (utilities.py:1556-1596)."""
    grid = _mesh_grid(n_x, n_y)
    a = np.asarray(a).reshape(n_x, n_y)
    i, x, y, right, up = _lattice_pairs(n_x, n_y)
    ih, xh, yh = i[right], x[right], y[right]
    iv, xv, yv = i[up], x[up], y[up]
    a1h, a2h = a[xh, yh], a[np.minimum(xh + 1, n_x - 1), yh]
    a1v, a2v = a[xv, yv], a[xv, np.minimum(yv + 1, n_y - 1)]
    dh = 1.0 / n_x
    dv = 1.0 / n_y
    edge_index = np.concatenate([
        np.stack([ih, ih + 1]), np.stack([ih + 1, ih]),
        np.stack([iv, iv + n_x]), np.stack([iv + n_x, iv]),
    ], axis=1).astype(np.int64)
    attrs = np.concatenate([
        _aug_features(dh, a1h, a2h), _aug_features(dh, a2h, a1h),
        _aug_features(dv, a1v, a2v), _aug_features(dv, a2v, a1v),
    ], axis=0).astype(np.float32)
    return grid.astype(np.float32), edge_index, attrs


def grid_edge_aug_full(n_x: int, n_y: int, r: float, a: np.ndarray):
    """Dense radius graph with augmented features (utilities.py:1598-1631).
    Each unordered pair within radius contributes both directions (the
    reference's double loop also emits self-pairs twice; we emit each
    directed edge once, which is the intended graph)."""
    grid = _mesh_grid(n_x, n_y)
    a = np.asarray(a).reshape(-1)
    d = np.linalg.norm(grid[:, None, :] - grid[None, :, :], axis=-1)
    src, dst = np.where(d <= r)
    edge_index = np.stack([src, dst]).astype(np.int64)
    attrs = _aug_features(d[src, dst], a[src], a[dst]).astype(np.float32)
    return grid.astype(np.float32), edge_index, attrs


def downsample_field(data: np.ndarray, grid_size: int, l: int) -> np.ndarray:
    """Strided grid-field downsample (utilities.py:1441-1445)."""
    data = np.asarray(data).reshape(-1, grid_size, grid_size)
    data = data[:, ::l, ::l]
    return data.reshape(-1, (grid_size // l) ** 2)


def multi_grid(depth: int, n_x: int, n_y: int, grid: str, params: np.ndarray):
    """Nested dyadic multigrid graph (utilities.py:1633-1699): ``depth``
    levels with 2x coarsening, inter-level edges from the repeat-upsample
    parent map, one concatenated node/edge array, and a mask selecting the
    finest level."""
    edge_index_global = []
    edge_attr_global = []
    x_global = []
    num_nodes = 0
    for l in range(depth):
        h_x = n_x // (2 ** l)
        h_y = n_y // (2 ** l)
        n_l = h_x * h_y
        a = downsample_field(params, n_x, 2 ** l)
        if grid == "grid":
            X, ei, ea = simple_grid(h_y, h_x)
        else:  # 'grid_edge' and 'grid_edge_aug' both use grid_edge here,
            # matching the reference dispatch (utilities.py:1648-1652)
            X, ei, ea = grid_edge(h_y, h_x, a)
        edge_index_global.append(ei + num_nodes)
        edge_attr_global.append(ea)
        x_global.append(X)

        index1 = np.arange(n_l) + num_nodes
        num_nodes += n_l
        if l != depth - 1:
            parent = np.arange(n_l // 4).reshape(h_x // 2, h_y // 2)
            parent = parent.repeat(2, axis=0).repeat(2, axis=1).reshape(-1)
            index2 = parent + num_nodes
            e1 = np.stack([index1, index2])
            e2 = np.stack([index2, index1])
            edge_index_global.append(np.concatenate([e1, e2], axis=1))
            # Inter-level attrs: zeros with a +/-1 direction flag in the
            # last column, widened to the inner attr width. (The reference
            # hardcodes 3 columns, utilities.py:1684-1686, which cannot
            # concatenate with grid_edge's 4-column attrs — a latent crash
            # we fix by matching widths.)
            a_w = ea.shape[1]
            attr1 = np.zeros((n_l, a_w), np.float32)
            attr1[:, -1] = 1.0
            attr2 = np.zeros((n_l, a_w), np.float32)
            attr2[:, -1] = -1.0
            edge_attr_global.append(np.concatenate([attr1, attr2], axis=0))

    X = np.concatenate(x_global, axis=0)
    edge_index = np.concatenate(edge_index_global, axis=1)
    edge_attr = np.concatenate(edge_attr_global, axis=0)
    mask_index = np.arange(n_x * n_y)
    return X, edge_index, edge_attr, mask_index, num_nodes


__all__ = [
    "simple_grid",
    "grid_edge",
    "grid_edge1d",
    "grid_edge_aug",
    "grid_edge_aug_full",
    "downsample_field",
    "multi_grid",
]
