"""The orthogonal-MGKN system under test: the port's Burgers data path
(``prepare_burgers``, ``burgers_multipole_data``, ``multipole_batch``),
model, task and trainer, in fixed batches of samples flattened into one
graph per edge list.

The step's useful work (``mfu`` divides by it) is counted here from the
edge lists' lengths: each kappa once a forward on every edge, each
conv's contraction, root weight and bias once a V-cycle, fc1 and the
two-layer head on every node; the backward counts twice the forward.
"""
from __future__ import annotations

import math

from .. import weights


def levels(cfg: dict) -> int:
    return int(math.log2(cfg["s"])) - 1


def kernel_width(cfg: dict, idx: int) -> int:
    """Edge list ``idx``'s kappa width: ker_width halved a list, at
    least 16."""
    return max(cfg["ker_width"] // 2 ** idx, 16)


def level_nodes(cfg: dict, idx: int) -> int:
    """The nodes edge list ``idx`` joins: lists 0 and 1 the finest
    level's s, list l > 1 level l's s / 2^(l-1)."""
    return cfg["s"] // 2 ** max(idx - 1, 0)


def weight_specs(cfg: dict) -> list:
    w, ki = cfg["width"], cfg["ker_in"]
    specs = weights.linear("fc1", cfg["in_width"], w)
    for l in range(levels(cfg) + 1):
        kw = kernel_width(cfg, l)
        specs += weights.dense(f"conv.{l}.kernel", [ki, kw, kw, w * w])
        specs += [(f"conv.{l}.root", (w, w), w ** -0.5),
                  (f"conv.{l}.bias", (w,), w ** -0.5)]
    return (specs + weights.linear("fc2", w, cfg["ker_width"])
            + weights.linear("fc3", cfg["ker_width"], cfg["out_width"]))


def program_tree(cfg: dict, w: dict) -> dict:
    """The port's parameter tree over the tensors of ``w``."""
    lin = lambda name: {"w": w[f"{name}.w"], "b": w[f"{name}.b"]}
    return {
        "fc1": lin("fc1"),
        "conv": [{"kernel": tuple(lin(f"conv.{l}.kernel.{j}")
                                  for j in range(3)),
                  "root": w[f"conv.{l}.root"], "bias": w[f"conv.{l}.bias"]}
                 for l in range(levels(cfg) + 1)],
        "fc2": lin("fc2"), "fc3": lin("fc3")}


def model_config(cfg: dict):
    from graph_pde_tpu_torch.models import MGKNOrthogonalConfig

    return MGKNOrthogonalConfig(
        width=cfg["width"], ker_width=cfg["ker_width"], depth=cfg["depth"],
        ker_in=cfg["ker_in"], in_width=cfg["in_width"],
        out_width=cfg["out_width"], s=cfg["s"], impl=cfg["impl"],
        compute_dtype=cfg["compute_dtype"])


def kernel_sources(cfg: dict) -> tuple:
    """impl 'kcached', the configuration's, launches no hand kernel."""
    return ()


def forward_flops(cfg: dict, edges: list) -> float:
    """One sample's forward on edge lists of ``edges`` edges each."""
    w, depth, s = cfg["width"], cfg["depth"], cfg["s"]
    total = 0.0
    for idx, e in enumerate(edges):
        kw, n = kernel_width(cfg, idx), level_nodes(cfg, idx)
        layers = [cfg["ker_in"], kw, kw, w * w]
        total += 2.0 * e * sum(a * b for a, b in zip(layers[:-1],
                                                     layers[1:]))
        # contraction, root weight and bias, once a V-cycle
        total += depth * (2.0 * e * w * w + 2.0 * n * w * w + n * w)
    total += 2.0 * s * cfg["in_width"] * w
    total += 2.0 * s * (w * cfg["ker_width"] + cfg["ker_width"]
                        * cfg["out_width"])
    return total


class Training:
    """The traffic's fixed batches on the device, their task and the
    useful work of each batch's step."""

    def __init__(self, cfg: dict, fields: dict, traffic: dict, device):
        from graph_pde_tpu_torch.data.datasets import (
            burgers_multipole_data, map_arrays, prepare_burgers)
        from graph_pde_tpu_torch.models.mgkn_orthogonal import (
            multipole_batch)
        from graph_pde_tpu_torch.train import MGKNOrthogonalTask

        n, bs = fields["a"].shape[0], traffic["batch_size"]
        arrays = prepare_burgers(fields, n=n, r=cfg["downsample"])
        graphs = multipole_batch(*burgers_multipole_data(
            arrays, is_periodic=cfg["periodic"]))
        self.task = MGKNOrthogonalTask(model_config(cfg),
                                       u_normalizer=arrays.u_normalizer,
                                       loss_type=cfg["loss"])
        self.batches = [
            map_arrays(lambda a, j=j: a[j * bs:(j + 1) * bs], graphs)
            .to(device) for j in range(n // bs)]
        edges = [int(se.shape[1]) for se in graphs.senders]
        step = 3 * bs * forward_flops(cfg, edges)
        self.flops = [{"bf16": 0.0, "f32": step} for _ in self.batches]
        self.shapes = {"edges": edges, "batch_size": bs}
