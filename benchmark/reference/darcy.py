"""Plain NumPy data path of the Darcy models, for the reference.

Everything here is worked out again from the raw fields the benchmark
made: grid coordinates, normalizer statistics, radius graphs, edge
attributes and node features. It imports nothing of the program.

Conventions (those of the papers' code): the grid lists rows in
``np.meshgrid`` order over linspace(0, 1, s); a radius graph keeps every
pair at distance <= r, self-loops included, edge (sender, receiver);
edge attributes are [x_sender, x_receiver, a_sender, a_receiver];
normalizers divide by (std + 1e-5) with unbiased standard deviations.
"""
from __future__ import annotations

import numpy as np

EPS = 1e-5


def grid(s: int) -> np.ndarray:
    """[s * s, 2] float64 coordinates of the unit square's s x s grid."""
    xs = np.linspace(0.0, 1.0, s)
    xx, yy = np.meshgrid(xs, xs)
    return np.stack([xx.ravel(), yy.ravel()], axis=1)


def aux_fields(a: np.ndarray):
    """The smoothed coefficient and its central differences of one
    [s, s] coefficient (Gaussian filter of width 1 grid step)."""
    from scipy.ndimage import gaussian_filter

    ka = gaussian_filter(np.asarray(a, np.float64), sigma=1.0)
    kx, ky = np.gradient(ka, 1.0 / (a.shape[0] - 1))
    return ka, kx, ky


class Gaussian:
    """A scalar z-score fitted on every entry of ``x``."""

    def __init__(self, x):
        x = np.asarray(x, np.float64)
        self.mean, self.std = x.mean(), x.std(ddof=1)

    def encode(self, x):
        return (np.asarray(x, np.float64) - self.mean) / (self.std + EPS)


class PerNode:
    """A z-score per grid node, fitted over the samples (axis 0)."""

    def __init__(self, x):
        x = np.asarray(x, np.float64)
        self.mean, self.std = x.mean(axis=0), x.std(axis=0, ddof=1)

    def encode(self, x):
        return (np.asarray(x, np.float64) - self.mean) / (self.std + EPS)

    def decode_at(self, values, idx):
        return values * (self.std[idx] + EPS) + self.mean[idx]


def fit(fields: dict, r: int) -> tuple:
    """The input normalizers ({'a', 'a_smooth', 'a_gradx', 'a_grady'})
    and the per-node target normalizer, fitted on every sample of
    ``fields`` (float32 [n, S, S] at the source resolution) after taking
    every r-th grid line."""
    n = fields["coeff"].shape[0]
    flat = {k: v[:, ::r, ::r].reshape(n, -1) for k, v in fields.items()}
    ins = {key: Gaussian(flat[src]) for key, src in
           (("a", "coeff"), ("a_smooth", "Kcoeff"), ("a_gradx", "Kcoeff_x"),
            ("a_grady", "Kcoeff_y"))}
    return ins, PerNode(flat["sol"])


def encoded_inputs(norms: dict, coeff, kcoeff, kx, ky) -> np.ndarray:
    """[s * s, 4] encoded (a, a_smooth, a_gradx, a_grady) of one
    sample."""
    cols = [norms[k].encode(np.asarray(v).reshape(-1)) for k, v in
            (("a", coeff), ("a_smooth", kcoeff), ("a_gradx", kx),
             ("a_grady", ky))]
    return np.stack(cols, axis=1)


def radius_edges(points, r: float, points_b=None) -> np.ndarray:
    """[2, E] (sender, receiver) pairs at distance <= r, by dense float64
    squared distances against r * r (a pair at distance r exactly, as
    grid points can be, decided by that one expression); with
    ``points_b`` the bipartite graph from ``points`` rows to ``points_b``
    columns."""
    b = points if points_b is None else points_b
    d2 = np.zeros((points.shape[0], b.shape[0]))
    for t in range(points.shape[1]):
        diff = points[:, None, t] - b[None, :, t]
        d2 += diff * diff
    src, dst = np.nonzero(d2 <= r * r)
    return np.stack([src, dst])


def radius_edges_tree(points, r: float) -> np.ndarray:
    """The same graph for large point sets, through a k-d tree (for
    grids whose pair distances keep clear of r)."""
    from scipy.spatial import cKDTree

    tree = cKDTree(points)
    pairs = tree.query_pairs(r, output_type="ndarray")
    n = points.shape[0]
    src = np.concatenate([pairs[:, 0], pairs[:, 1], np.arange(n)])
    dst = np.concatenate([pairs[:, 1], pairs[:, 0], np.arange(n)])
    return np.stack([src, dst])


def edge_attr(coords, edges, theta) -> np.ndarray:
    """[E, 6] float32 [x_s, y_s, x_r, y_r, theta_s, theta_r]."""
    s, r = edges
    return np.concatenate([coords[s], coords[r], theta[s, None],
                           theta[r, None]], axis=1).astype(np.float32)
