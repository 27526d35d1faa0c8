"""The UAI GKN system under test at its published widths on the full
s=61 grid: the port's registry entry (``uai1_full_resolution``) made
into a model configuration by the runner's own function
(``experiments/runners.py`` ``_gkn_config``), so that the cell runs what
``cli run uai1_full_resolution`` runs; the port's Darcy data path, task,
Adam and ``make_train_step`` as ``systems/gkn.py`` drives them, fed the
benchmark's fields and weights.

At the full size that configuration takes the fused kcached depth loop
on a float32 K: K2 a depth step, B2-bwd a depth step of the backward.
The configuration states float32, so each compared step also checks
that the program stored K in float32 (``KCheck``): no lowering that the
compared numbers might not tell apart from round-off passes.
"""
from __future__ import annotations

import dataclasses
import sys

from . import gkn

weight_specs = gkn.weight_specs
program_tree = gkn.program_tree

# the configuration file's keys that set the registry entry's fields
REGISTRY_KEYS = ("width", "ker_width", "depth", "kernel_variant",
                 "relu_last", "impl", "compute_dtype")


def model_config(cfg: dict):
    """The runner's GKNConfig of the registry entry ``cfg["registry"]``
    at the configuration file's widths (the entry's own at full size)."""
    from graph_pde_tpu_torch.experiments import registry, runners

    exp = dataclasses.replace(registry.get(cfg["registry"]),
                              **{k: cfg[k] for k in REGISTRY_KEYS})
    mcfg = runners._gkn_config(exp)
    if list(mcfg.resolved_kernel_layers()) != list(cfg["kernel_layers"]):
        raise ValueError(f"the runner's kappa {mcfg.resolved_kernel_layers()}"
                         f" is not the configuration's {cfg['kernel_layers']}")
    return mcfg


def kernel_sources(cfg: dict) -> tuple:
    """The CUDA sources the fused kcached training step launches (K2 and
    B2-bwd)."""
    return ("fused_iterate", "fused_iterate_bwd")


class KCheck:
    """The task's forward, which in each of its first ``calls`` calls
    (the compared steps) reads the port's counters: a float32 K counts
    no ``k_lowered`` and ``k_bytes`` of E_pad * width^2 * 4. Where they
    read otherwise (K lowered, or a program that does not count K), the
    call's predictions are NaN, so that every compared number reads
    infinite and the run is not correct. Later calls pass straight
    through."""

    def __init__(self, forward, k_bytes: int, calls: int):
        self.forward, self.k_bytes, self.left = forward, k_bytes, calls

    def __call__(self, params, batch):
        if self.left <= 0:
            return self.forward(params, batch)
        from graph_pde_tpu_torch.utils import tracing

        self.left -= 1
        with tracing.recording() as rec:
            pred = self.forward(params, batch)
        lowered = rec.counters.get("k_lowered", 0)
        k_bytes = rec.counters.get("k_bytes")
        if lowered or k_bytes != self.k_bytes:
            print(f"gkn_uai1: K is not float32 (k_lowered {lowered}, "
                  f"k_bytes {k_bytes}, float32 {self.k_bytes}): this "
                  "compared step's predictions are NaN", file=sys.stderr,
                  flush=True)
            pred = pred * float("nan")
        return pred


class Training(gkn.Training):
    """``systems/gkn.py``'s samples on the device and the useful work of
    each step (all fp32 here), with the task's model configuration the
    runner's and its forward checked by ``KCheck`` in the compared
    steps."""

    def __init__(self, cfg: dict, fields: dict, traffic: dict, device):
        super().__init__(cfg, fields, traffic, device)
        self.task.cfg = model_config(cfg)
        e_pad = int(self.batches[0].senders.shape[-1])
        self.shapes["edges_padded"] = e_pad
        self.task.forward = KCheck(self.task.forward,
                                   e_pad * cfg["width"] ** 2 * 4,
                                   traffic["compared_steps"])
