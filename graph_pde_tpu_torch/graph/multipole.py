"""Orthogonal multipole (FMM-style) 1-d grid decomposition (a copy of
graph_pde_tpu/graph/multipole.py; host numpy, same arrays).

Level l uses the stride-2^(l-1) subsample of the s-point grid; the
finest level gets nearest-neighbor edges and every level gets
"interactive" edges: pairs at offset |dx| in {2, 3} whose parents
(index // 2) are nearest neighbors, the fast-multipole near/far-field
split. Periodic wrap optional.
"""
from __future__ import annotations

from typing import List

import numpy as np


def multipole_levels_1d(s: int) -> int:
    return int(np.log2(s) - 1)


def multi_pole_grid1d(theta: np.ndarray, theta_d: int, s: int, N: int,
                      is_periodic: bool = False):
    """Returns (grid_list, theta_list, edge_index_list).

    grid_list[l]: [s_l] grid coordinates of level l+1 (s_l = s // 2^l).
    theta_list[l]: [N, s_l, theta_d] subsampled per-sample features.
    edge_index_list: [NN_edges(finest), inter(level 1), ..., inter(level
      L)], length L+1.
    """
    theta = np.asarray(theta)
    level = multipole_levels_1d(s)
    grid_list: List[np.ndarray] = []
    theta_list: List[np.ndarray] = []
    edge_index_list: List[np.ndarray] = []

    for l in range(1, level + 1):
        r_l = 2 ** (l - 1)
        s_l = s // r_l
        grid_list.append(np.linspace(0.0, 1.0, s_l).astype(np.float32))
        theta_l = theta[:, :, :theta_d].reshape(N, s, theta_d)[:, ::r_l, :]
        theta_list.append(theta_l.reshape(N, s_l, theta_d)
                          .astype(np.float32))
        if l == 1:
            edge_index_list.append(_nearest_neighbor_edges(s_l, is_periodic))
        edge_index_list.append(_interactive_edges(s_l, is_periodic))

    return grid_list, theta_list, edge_index_list


def _nearest_neighbor_edges(s_l: int, is_periodic: bool) -> np.ndarray:
    edges = []
    for x_i in range(s_l):
        for dx in (-1, 1):
            x_j = x_i + dx
            if is_periodic:
                x_j = x_j % s_l
            if 0 <= x_j < s_l:
                edges.append((x_i, x_j))
    return np.asarray(edges, np.int64).T


def _interactive_edges(s_l: int, is_periodic: bool) -> np.ndarray:
    """Pairs with 2 <= |dx| <= 3 whose parents are nearest neighbors."""
    edges = []
    for x_i in range(s_l):
        for dx in range(-3, 4):
            x_j = x_i + dx
            if is_periodic:
                x_j = x_j % s_l
            if 0 <= x_j < s_l and abs(dx) >= 2:
                if abs(x_i // 2 - x_j // 2) % (s_l // 2) <= 1:
                    edges.append((x_i, x_j))
    if not edges:
        return np.zeros((2, 0), np.int64)
    return np.asarray(edges, np.int64).T


def get_edge_attr(grid: np.ndarray, theta: np.ndarray,
                  edge_index: np.ndarray) -> np.ndarray:
    """1-d edge attrs [x_src, x_dst, theta_src, theta_dst]."""
    grid = np.asarray(grid).reshape(-1)
    theta = np.asarray(theta).reshape(-1)
    src, dst = edge_index[0], edge_index[1]
    return np.stack([grid[src], grid[dst], theta[src], theta[dst]],
                    axis=1).astype(np.float32)


__all__ = ["multi_pole_grid1d", "get_edge_attr", "multipole_levels_1d"]
