"""Plain reference of the Graph Kernel Network on full Darcy grids
(Li et al., "Neural Operator: Graph Kernel Network for Partial
Differential Equations", arXiv:2003.03485), float32, TF32 off.

    x = fc1(features)
    depth x: x = mean_{j -> i} x_j @ K(e_ji) + x_i @ root + bias
             (ReLU after every step but the last unless relu_last)
    out = fc2(x),    K(e) = kappa(e) reshaped to [width, width]

The graph is worked out again from the raw fields (``reference.darcy``).
kappa runs in edge blocks under activation checkpointing, so the
[E, width^2] kernel matrices are never held whole; K depends only on
the edge features, so each step recomputes the block's K. ``q`` rounds
the operands of what the configuration computes in its compute dtype
(kappa and the contraction): exact for the reference, a lower precision
for the control.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from . import common, darcy

BLOCK = 1 << 18   # edges a checkpointed kappa block


class Sample:
    """One full-grid sample on ``device``: node features, targets and
    edge attributes."""

    def __init__(self, x, y, attr):
        self.x, self.y, self.attr = x, y, attr


class Problem:
    """The shared full-grid graph and the encoded samples."""

    def __init__(self, cfg: dict, fields: dict, device):
        r = cfg["downsample"]
        a = fields["coeff"][:, ::r, ::r]
        s = a.shape[1]
        coords = darcy.grid(s)
        edges = darcy.radius_edges_tree(coords, cfg["radius"])
        norms, self.u_norm = darcy.fit(fields, r)
        self.device = device
        self.n = s * s
        self.senders = torch.as_tensor(edges[0], device=device)
        self.receivers = torch.as_tensor(edges[1], device=device)
        self.degree = common.degree(self.receivers, self.n, device)
        self.coords, self.edges, self.norms = coords, edges, norms
        self.fields, self.r = fields, r

    def sample(self, j: int) -> Sample:
        f = {k: v[j, ::self.r, ::self.r] for k, v in self.fields.items()}
        enc = darcy.encoded_inputs(self.norms, f["coeff"], f["Kcoeff"],
                                   f["Kcoeff_x"], f["Kcoeff_y"])
        x = np.concatenate([self.coords, enc], axis=1).astype(np.float32)
        y = self.u_norm.encode(f["sol"].reshape(1, -1))[0]
        attr = darcy.edge_attr(self.coords, self.edges,
                               enc[:, 0].astype(np.float32))
        t = lambda v: torch.as_tensor(np.asarray(v, np.float32),
                                      device=self.device)
        return Sample(t(x), t(y), t(attr))


def _block_messages(x, attr, senders, *kernel, n_layers, width, q):
    p = {f"k.{j // 2}.{'wb'[j % 2]}": t for j, t in enumerate(kernel)}
    k = common.mlp(p, "k", n_layers, attr, q)
    return common.contract(x.index_select(0, senders), k, width, q)


def forward(p: dict, cfg: dict, prob: Problem, smp: Sample, q):
    """[n] predictions of one sample."""
    width, n_layers = cfg["width"], len(cfg["kernel_layers"]) - 1
    kernel = [p[f"kernel.{j}.{t}"] for j in range(n_layers) for t in "wb"]
    x = smp.x @ p["fc1.w"] + p["fc1.b"]
    e = smp.attr.shape[0]
    for t in range(cfg["depth"]):
        msg = torch.cat([
            checkpoint(_block_messages, x, smp.attr[b:b + BLOCK],
                       prob.senders[b:b + BLOCK], *kernel,
                       n_layers=n_layers, width=width, q=q,
                       use_reentrant=False)
            for b in range(0, e, BLOCK)])
        x = (common.mean_into(msg, prob.receivers, prob.degree, prob.n)
             + x @ p["root"] + p["bias"])
        if t != cfg["depth"] - 1 or cfg["relu_last"]:
            x = torch.relu(x)
    return (x @ p["fc2.w"] + p["fc2.b"])[:, 0]


def loss(p: dict, cfg: dict, prob: Problem, smp: Sample, q):
    pred = forward(p, cfg, prob, smp, q)
    if cfg["loss"] != "mse":
        raise ValueError(f"the GKN reference takes the MSE, not "
                         f"{cfg['loss']!r}")
    return torch.mean((pred - smp.y) ** 2)


def train_steps(cfg: dict, weights: dict, fields: dict, order: list,
                device, rounding: str = "float32", graph_seed=None) -> dict:
    """The reference's training steps on samples ``order`` (batch 1) from
    ``weights``: each step's loss, the first step's optimizer gradient
    and the parameters after the last step. (The full grid draws no
    nodes: ``graph_seed`` is unused.)"""
    q = common.ROUNDING[rounding]
    with common.fp32_exact():
        prob = Problem(cfg, fields, device)
        params = {k: v.to(device, torch.float32).clone()
                  for k, v in weights.items()}
        return common.train_three(
            params, lambda p, j: loss(p, cfg, prob, prob.sample(j), q),
            list(order), cfg["learning_rate"], cfg["weight_decay"])
