"""Plain reference of the UAI GKN on the full s=61 Darcy grid (Li et
al., arXiv:2003.03485; the script graph-neural-operator/
UAI1_full_resolution.py of github.com/neuraloperator/graph-pde),
float32, TF32 off.

The graph, the encoded inputs and the forward are ``reference.gkn``'s:
the radius graph worked out again from the raw fields (at s=61 and
r=0.1 k-d tree's pairs are the dense threshold's, 383,293 edges with
self-loops), kappa in checkpointed edge blocks so that no whole
[E, width^2] K is held, ReLU after every conv with ``relu_last``. What
that reference lacks is added here:

    target = (u - mean) / (std + 1e-5),  mean and unbiased std over
             every node of every sample (GaussianNormalizer)
    loss   = sum over the nodes of |GKN(x) - target|   (L1, a sum)

Departures from UAI1_full_resolution.py: the fields are seeded, with no
PDE solve, and so are the weights (the configuration's ``assumed``);
every normalizer is fitted on the traffic's samples, not on 100 training
fields; the compared steps follow the traffic's shuffle for three steps,
so StepLR never steps; no test evaluation.
"""
from __future__ import annotations

import torch

from . import common, darcy, gkn


class Problem(gkn.Problem):
    """``gkn.Problem``'s shared graph and encoded samples, with the
    target encoded by one Gaussian over every node of every sample."""

    def __init__(self, cfg: dict, fields: dict, device):
        super().__init__(cfg, fields, device)
        n = fields["sol"].shape[0]
        self.u_norm = darcy.Gaussian(
            fields["sol"][:, ::self.r, ::self.r].reshape(n, -1))


def loss(p: dict, cfg: dict, prob: Problem, smp, q):
    if cfg["loss"] != "l1":
        raise ValueError(f"the UAI GKN reference takes the L1 loss, not "
                         f"{cfg['loss']!r}")
    return torch.sum(torch.abs(gkn.forward(p, cfg, prob, smp, q) - smp.y))


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
