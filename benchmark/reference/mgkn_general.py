"""Plain reference of the general multipole graph kernel network, the
'mkgn' V-cycle (Li et al., "Multipole Graph Neural Operator for
Parametric Partial Differential Equations", arXiv:2006.09535, its
MGKN_general_darcy2d), float32, TF32 off.

Levels l = 0..L-1 hold points[l] nodes of one random draw of grid
nodes; mid edges join a level's nodes within radius_inner[l], down edges
run from level l to l+1 within radius_inter[l], up edges are the down
edges reversed. A conv is the mean over a receiver's edges of
x_sender @ K(e); mid convs add x @ root. Each of depth V-cycles runs
x = relu(x + down_l(x)) for l = 0..L-2, then for l = L-1..0 replaces
level l's rows by mid_l(level l's rows) and, for l > 0, runs
x = relu(x + up_{l-1}(x)). The finest level is decoded by a two-layer
MLP. kappa widths halve per level; mid kappas have two hidden layers,
down and up kappas one.

The node draws replay the generators' streams: one permutation of the
grid per training graph, consecutive windows of it per level; for a
request, one permutation whose consecutive windows, m = points[0] apart
and read circularly, cover the grid, each window's finest-level
predictions written back in turn.
"""
from __future__ import annotations

import numpy as np
import torch

from . import common, darcy


class Graph:
    """One multilevel graph on ``device``: node features, per-level
    (senders, receivers, attr) of each edge kind, finest-level grid
    ids."""

    def __init__(self, x, convs, ids0, device):
        t = lambda v, dt=torch.float32: torch.as_tensor(v, dtype=dt,
                                                        device=device)
        self.x = t(x)
        self.convs = {kind: [(t(e[0], torch.int64), t(e[1], torch.int64),
                              t(a)) for e, a in lst]
                      for kind, lst in convs.items()}
        self.ids0 = ids0


def offsets(points) -> list:
    return [0, *np.cumsum(points).tolist()]


def build(cfg: dict, coords, ids: list, theta_a, features, device) -> Graph:
    """The multilevel graph of per-level grid ids ``ids`` (global
    indices): features [n, 4] encoded inputs of the whole grid, theta_a
    [n] the edge attributes' field."""
    off = offsets(cfg["points"])
    allids = np.concatenate(ids)
    pts = coords[allids]
    th = np.asarray(theta_a, np.float64)[allids]
    convs = {"mid": [], "down": [], "up": []}
    for l, lid in enumerate(ids):
        e = darcy.radius_edges(coords[lid], cfg["radius_inner"][l])
        # local to the level's slice; attributes read the whole union
        convs["mid"].append((e, darcy.edge_attr(pts, e + off[l], th)))
    for l in range(len(ids) - 1):
        e = darcy.radius_edges(coords[ids[l]], cfg["radius_inter"][l],
                               points_b=coords[ids[l + 1]])
        down = np.stack([e[0] + off[l], e[1] + off[l + 1]])
        up = down[::-1]
        convs["down"].append((down, darcy.edge_attr(pts, down, th)))
        convs["up"].append((up, darcy.edge_attr(pts, up, th)))
    x = np.concatenate([pts, np.asarray(features)[allids]], axis=1)
    return Graph(x.astype(np.float32), convs, ids[0], device)


def _conv(p, name, hidden, x, edges, n, width, q, root=None):
    s, r, attr = edges
    k = common.mlp(p, f"{name}.kernel", hidden + 1, attr, q)
    msg = common.contract(x.index_select(0, s), k, width, q)
    out = common.mean_into(msg, r, common.degree(r, n, x.device), n)
    if root is not None:
        out = out + q(x) @ q(root)
    return out


def forward(p: dict, cfg: dict, g: Graph, q):
    """[points[0]] predictions (encoded) on the finest level."""
    w, pts = cfg["width"], cfg["points"]
    off, n, levels = offsets(pts), sum(pts), len(pts)
    x = q(g.x) @ q(p["fc_in.w"]) + p["fc_in.b"]
    for _ in range(cfg["depth"]):
        for l in range(levels - 1):
            x = torch.relu(x + _conv(p, f"conv_down.{l}", 1, x,
                                     g.convs["down"][l], n, w, q))
        for l in reversed(range(levels)):
            sl = x[off[l]:off[l + 1]]
            new = _conv(p, f"conv_mid.{l}", 2, sl, g.convs["mid"][l],
                        pts[l], w, q, root=p[f"conv_mid.{l}.root"])
            x = torch.cat([x[:off[l]], new, x[off[l + 1]:]])
            if l > 0:
                x = torch.relu(x + _conv(p, f"conv_up.{l - 1}", 1, x,
                                         g.convs["up"][l - 1], n, w, q))
    x0 = torch.relu(q(x[:pts[0]]) @ q(p["fc_out1.w"]) + p["fc_out1.b"])
    return (q(x0) @ q(p["fc_out2.w"]) + p["fc_out2.b"])[:, 0]


def _level_ids(perm, points) -> list:
    off = offsets(points)
    return [perm[off[l]:off[l + 1]] for l in range(len(points))]


class Problem:
    """Training graphs and their targets, from the raw fields."""

    def __init__(self, cfg: dict, fields: dict, graph_seed: int, device):
        r = cfg["downsample"]
        s = fields["coeff"][:, ::r, ::r].shape[1]
        self.cfg, self.fields, self.r, self.device = cfg, fields, r, device
        self.coords = darcy.grid(s)
        self.norms, self.u_norm = darcy.fit(fields, r)
        rng = np.random.default_rng(graph_seed)
        # one permutation a training graph, drawn in sample order
        self.perms = [rng.permutation(s * s)
                      for _ in range(fields["coeff"].shape[0])]

    def graph(self, j: int) -> tuple:
        f = {k: v[j, ::self.r, ::self.r] for k, v in self.fields.items()}
        enc = darcy.encoded_inputs(self.norms, f["coeff"], f["Kcoeff"],
                                   f["Kcoeff_x"], f["Kcoeff_y"])
        ids = _level_ids(self.perms[j], self.cfg["points"])
        g = build(self.cfg, self.coords, ids, enc[:, 0], enc, self.device)
        u = f["sol"].reshape(-1).astype(np.float64)
        return g, torch.as_tensor(u[ids[0]], dtype=torch.float32,
                                  device=self.device)


def decode(u_norm, values, ids0, device):
    std = torch.as_tensor(u_norm.std[ids0] + darcy.EPS, dtype=torch.float32,
                          device=device)
    mean = torch.as_tensor(u_norm.mean[ids0], dtype=torch.float32,
                           device=device)
    return values * std + mean


def rel2_loss(p, cfg, prob: Problem, j: int, q):
    g, u = prob.graph(j)
    pred = decode(prob.u_norm, forward(p, cfg, g, q), g.ids0, prob.device)
    return torch.linalg.vector_norm(pred - u) / torch.linalg.vector_norm(u)


def train_steps(cfg: dict, weights: dict, fields: dict, order: list,
                device, rounding: str = "float32",
                graph_seed: int = 0) -> dict:
    """The reference's training steps on samples ``order`` (batch 1)."""
    if cfg["loss"] != "rel2":
        raise ValueError(f"the MGKN reference takes rel2, not "
                         f"{cfg['loss']!r}")
    q = common.ROUNDING[rounding]
    with common.fp32_exact():
        prob = Problem(cfg, fields, graph_seed, device)
        params = {k: v.to(device, torch.float32).clone()
                  for k, v in weights.items()}
        return common.train_three(
            params, lambda p, j: rel2_loss(p, cfg, prob, j, q),
            list(order), cfg["learning_rate"], cfg["weight_decay"])


def _ring(perm, start: int, count: int):
    """``count`` consecutive entries of ``perm`` from ``start``, read
    circularly (a positive multiple of its length reads it whole)."""
    n = perm.shape[0]
    count = n if (count % n == 0 and count > 0) else count % n
    lo = start % n
    hi = lo + count
    if hi <= n:
        return perm[lo:hi]
    return np.concatenate([perm[lo:], perm[:hi - n]])


class Server:
    """The full-field protocol for requests: the splitter's stream of
    permutations replayed from its seed, one a request."""

    def __init__(self, cfg: dict, weights: dict, norm_fields: dict,
                 splitter_seed: int, device, rounding="float32"):
        self.cfg, self.device = cfg, device
        self.q = common.ROUNDING[rounding]
        r = cfg["downsample"]
        self.s = norm_fields["coeff"][:, ::r, ::r].shape[1]
        self.coords = darcy.grid(self.s)
        self.norms, self.u_norm = darcy.fit(norm_fields, r)
        self.rng = np.random.default_rng(splitter_seed)
        self.params = {k: v.to(device, torch.float32)
                       for k, v in weights.items()}
        self.served = 0

    def skip_to(self, k: int):
        """Advances the stream to the k-th request (0-based)."""
        while self.served < k:
            self.rng.permutation(self.s * self.s)
            self.served += 1

    def windows(self, perm) -> list:
        """Per-level id lists of each window, in the order written."""
        pts = self.cfg["points"]
        n, m = perm.shape[0], pts[0]
        out, index = [], 0
        for _ in range(-(-n // m)):
            cursor, ids = index, []
            for size in pts:
                ids.append(_ring(perm, cursor, size))
                cursor += size
            out.append(ids)
            index = (index + m) % n
        return out

    def predict(self, k: int, coeff) -> np.ndarray:
        """The decoded field [s * s] of request k on coefficient coeff
        [s, s]."""
        self.skip_to(k)
        perm = self.rng.permutation(self.s * self.s)
        self.served += 1
        ka, kx, ky = darcy.aux_fields(coeff)
        enc = darcy.encoded_inputs(self.norms, coeff, ka, kx, ky)
        out = np.zeros(self.s * self.s)
        with common.fp32_exact(), torch.no_grad():
            for ids in self.windows(perm):
                g = build(self.cfg, self.coords, ids, enc[:, 0], enc,
                          self.device)
                pred = forward(self.params, self.cfg, g, self.q)
                out[ids[0]] = self.u_norm.decode_at(
                    pred.double().cpu().numpy(), ids[0])
        return out

    def edge_counts(self, k: int) -> list:
        """Each window's valid edge counts {"mid", "down", "up"} of
        request k, for the FLOP count."""
        self.skip_to(k)
        perm = self.rng.permutation(self.s * self.s)
        self.served += 1
        cfg, out = self.cfg, []
        for ids in self.windows(perm):
            c = {"mid": [darcy.radius_edges(self.coords[i], r).shape[1]
                         for i, r in zip(ids, cfg["radius_inner"])],
                 "down": [darcy.radius_edges(self.coords[ids[l]], r,
                                             self.coords[ids[l + 1]]).shape[1]
                          for l, r in enumerate(cfg["radius_inter"])]}
            c["up"] = list(c["down"])
            out.append(c)
        return out
