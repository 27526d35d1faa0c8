"""Plain reference of the orthogonal multipole graph kernel network on
1-d Burgers (Li et al., "Multipole Graph Neural Operator for Parametric
Partial Differential Equations", arXiv:2006.09535, its
MGKN_orthogonal_burgers1d.py), float32, TF32 off.

The s-point periodic grid is cut into L = log2(s) - 1 levels, level l
(l = 0..L-1) holding every 2^l-th point. Edge list 0 joins each finest
node to its two nearest neighbours; edge list l + 1 joins the nodes of
level l at |dx| in {2, 3} whose parents (index // 2) are neighbours: the
script's test |p_i - p_j| mod (s_l / 2) <= 1, which leaves out wrapped
pairs whose parents sit at the two ends of the level (3,066 edges, not
3,072, at s_l = 1024). An edge's attributes are [x_i, x_j, a_i, a_j] on
its level (lists 0 and 1 the finest), a the encoded input.

A conv on edge list l is the mean over a receiver's edges of x_sender @
K_l(e), plus x @ root_l + bias_l; K_l is a ReLU MLP (4, kw_l, kw_l,
width^2), kw_l = ker_width / 2^l, at least 16. Each of depth V-cycles
keeps phi_l, the state pooled l times (pairs averaged), then runs x =
relu(x + conv_L(phi_{L-1})) on the coarsest level and, for l = L-1..1,
x = relu(upsample(x) + conv_l(phi_{l-1})) (each node repeated), and x =
relu(x + conv_0(phi_0)) last. fc1 lifts [x, a] to width; fc2 (ReLU) and
fc3 decode.

Departures from the script: a batch of samples runs at once (the script
trains one at a time); the inputs are synthetic and the targets are not
solutions (``benchmark/burgers.py``); the normalizers are fitted on the
traffic's samples. The loss is the script's: the sum over the batch of
each sample's relative L2 error of the decoded prediction.
"""
from __future__ import annotations

import numpy as np
import torch

from . import common

EPS = 1e-5     # the normalizers' epsilon


def levels(s: int) -> int:
    return int(np.log2(s)) - 1


def nearest_edges(n: int, periodic: bool) -> np.ndarray:
    """[2, E] (sender, receiver) pairs at |dx| = 1, by sender then dx."""
    i = np.repeat(np.arange(n), 2)
    j = i + np.tile([-1, 1], n)
    if periodic:
        j = j % n
    keep = (j >= 0) & (j < n)
    return np.stack([i[keep], j[keep]]).astype(np.int64)


def interactive_edges(n: int, periodic: bool) -> np.ndarray:
    """[2, E] pairs at 2 <= |dx| <= 3 whose parents are neighbours, by
    sender then dx."""
    dx = np.tile(np.arange(-3, 4), n)
    i = np.repeat(np.arange(n), 7)
    j = i + dx
    if periodic:
        j = j % n
    keep = (j >= 0) & (j < n) & (np.abs(dx) >= 2)
    i, j = i[keep], j[keep]
    near = np.abs(i // 2 - j // 2) % max(n // 2, 1) <= 1
    return np.stack([i[near], j[near]]).astype(np.int64)


def edge_lists(s: int, periodic: bool) -> list:
    """The L + 1 edge lists, each [2, E] on its level's node indices."""
    out = [nearest_edges(s, periodic)]
    for l in range(levels(s)):
        out.append(interactive_edges(s // 2 ** l, periodic))
    return out


def list_level(idx: int) -> int:
    """The level whose nodes edge list ``idx`` joins."""
    return max(idx - 1, 0)


def edge_attrs(a_enc: np.ndarray, s: int, edges: list) -> list:
    """Each list's [n, E, 4] attributes [x_i, x_j, a_i, a_j] of the
    encoded inputs a_enc [n, s]."""
    out = []
    for idx, (src, dst) in enumerate(edges):
        stride = 2 ** list_level(idx)
        grid = np.linspace(0.0, 1.0, s // stride)
        theta = a_enc[:, ::stride]
        n = theta.shape[0]
        out.append(np.stack([np.broadcast_to(grid[src], (n, src.size)),
                             np.broadcast_to(grid[dst], (n, dst.size)),
                             theta[:, src], theta[:, dst]], axis=-1))
    return out


def conv(p: dict, idx: int, x, edges, attrs, width: int, q):
    """[B, n, w] -> [B, n, w] on edge list ``idx``."""
    src, dst = edges
    b, n, _ = x.shape
    k = common.mlp(p, f"conv.{idx}.kernel", 3, attrs.reshape(-1, 4), q)
    xs = x[:, src].reshape(-1, width)
    msg = common.contract(xs, k, width, q)
    # the batch as one graph: sample i's nodes offset by i * n
    recv = (dst[None] + n * torch.arange(b, device=x.device)[:, None])
    deg = common.degree(dst, n, x.device).repeat(b)
    out = common.mean_into(msg.reshape(-1, width), recv.reshape(-1), deg,
                           b * n).view(b, n, width)
    return out + q(x) @ q(p[f"conv.{idx}.root"]) + p[f"conv.{idx}.bias"]


def pool(x):
    b, n, w = x.shape
    return x.view(b, n // 2, 2, w).mean(dim=2)


def upsample(x):
    return x.repeat_interleave(2, dim=1)


def forward(p: dict, cfg: dict, x, edges: list, attrs: list, q):
    """[B, s, 2] inputs [x, a_enc] -> [B, s] predictions (encoded)."""
    w, L = cfg["width"], levels(cfg["s"])
    c = lambda idx, h: conv(p, idx, h, edges[idx], attrs[idx], w, q)
    x = q(x) @ q(p["fc1.w"]) + p["fc1.b"]
    for _ in range(cfg["depth"]):
        phi = []
        for l in range(L):
            phi.append(x)
            if l != L - 1:
                x = pool(x)
        x = torch.relu(x + c(L, phi[L - 1]))
        for l in reversed(range(1, L)):
            x = torch.relu(upsample(x) + c(l, phi[l - 1]))
        x = torch.relu(x + c(0, phi[0]))
    x = torch.relu(q(x) @ q(p["fc2.w"]) + p["fc2.b"])
    return (q(x) @ q(p["fc3.w"]) + p["fc3.b"])[..., 0]


class Problem:
    """The samples' graphs and targets, from the raw fields."""

    def __init__(self, cfg: dict, fields: dict, device):
        r, s = cfg["downsample"], cfg["s"]
        a = fields["a"][:, ::r].astype(np.float64)
        u = fields["u"][:, ::r].astype(np.float64)
        if a.shape[1] != s:
            raise ValueError(f"fields give s={a.shape[1]}, the config s={s}")
        # a: one mean and (unbiased) std over every value; u: per point
        a_enc = (a - a.mean()) / (a.std(ddof=1) + EPS)
        self.u_mean, self.u_std = u.mean(0), u.std(0, ddof=1) + EPS
        self.cfg, self.device = cfg, device
        self.edges_np = edge_lists(s, cfg["periodic"])
        t = lambda v, dt=torch.float32: torch.as_tensor(
            np.ascontiguousarray(v), dtype=dt, device=device)
        self.edges = [(t(e[0], torch.int64), t(e[1], torch.int64))
                      for e in self.edges_np]
        self.attrs = [t(v) for v in edge_attrs(a_enc, s, self.edges_np)]
        self.x = t(np.stack([np.broadcast_to(np.linspace(0.0, 1.0, s),
                                             a_enc.shape), a_enc], axis=-1))
        self.u = t(u)
        self.u_mean_t, self.u_std_t = t(self.u_mean), t(self.u_std)

    def loss(self, p: dict, samples, q):
        """The batch's summed relative L2 error of the decoded
        prediction."""
        idx = torch.as_tensor(samples, dtype=torch.int64, device=self.device)
        pred = forward(p, self.cfg, self.x[idx], self.edges,
                       [a[idx] for a in self.attrs], q)
        pred = pred * self.u_std_t + self.u_mean_t
        u = self.u[idx]
        return (torch.linalg.vector_norm(pred - u, dim=1)
                / torch.linalg.vector_norm(u, dim=1)).sum()


def train_steps(cfg: dict, weights: dict, fields: dict, order: list,
                device, rounding: str = "float32",
                graph_seed: int = 0) -> dict:
    """The reference's training steps, one a batch of ``order`` (each
    entry a list of sample indices, or one index). ``graph_seed`` is
    unused: the edge lists are fixed."""
    if cfg["loss"] != "rel2":
        raise ValueError(f"the orthogonal MGKN reference takes rel2, not "
                         f"{cfg['loss']!r}")
    q = common.ROUNDING[rounding]
    with common.fp32_exact():
        prob = Problem(cfg, fields, device)
        params = {k: v.to(device, torch.float32).clone()
                  for k, v in weights.items()}
        batches = [b if isinstance(b, (list, tuple)) else [b] for b in order]
        return common.train_three(
            params, lambda p, b: prob.loss(p, b, q), batches,
            cfg["learning_rate"], cfg["weight_decay"])
