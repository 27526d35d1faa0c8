"""Burgers training traffic: the closed loop of ``modes/train.py`` over
fixed batches of seeded 1-d Burgers inputs.

Set-up draws ``samples`` inputs (``burgers.burgers_fields``) and cuts
them into ``samples / batch_size`` fixed batches, each flattened into
one graph per edge list; the order of the batches is a seeded shuffle
each epoch. Everything else, set-up's marks, the compared steps, the
window, its spans and the reference's check, is ``modes/train.py``'s
own code: ``run`` is that module's ``run`` over this ``Session``.
"""
from __future__ import annotations

import time
import types

import numpy as np

from .. import burgers, fields, harness, weights
from . import train


class Session(train.Session):
    """``train.Session`` on Burgers fields in fixed batches: its order
    indexes the batches, and the reference takes each batch's samples."""

    def __init__(self, cell, seed: int, device, fault=None):
        from graph_pde_tpu_torch.train import adam_steplr, make_train_step
        from graph_pde_tpu_torch.train.trainer import param_leaves

        cfg, traffic = cell.cfg, cell.traffic
        if traffic["samples"] % traffic["batch_size"]:
            raise ValueError("samples must be a multiple of batch_size")
        self.cell, self.device = cell, device
        self.marks = [("start", time.perf_counter())]
        s_fields, s_weights, s_order = fields.seeds(seed, 3)
        self.fields = burgers.burgers_fields(np.random.default_rng(s_fields),
                                             traffic["samples"],
                                             cfg["source_res"])
        self.marks.append(("fields", time.perf_counter()))
        system = cell.system()
        self.build_s = (harness.build_kernels(system.kernel_sources(cfg))
                        if device.type == "cuda" else 0.0)
        self.marks.append(("build", time.perf_counter()))
        self.data = system.Training(cfg, self.fields, traffic, device)
        self.marks.append(("graphs on the device", time.perf_counter()))
        w = weights.draw(system.weight_specs(cfg), s_weights, device)
        self.p0 = {k: v.detach().cpu().clone() for k, v in w.items()}
        self.leaves = {k: v.clone().requires_grad_(True)
                       for k, v in w.items()}
        self.tree = system.program_tree(cfg, self.leaves)
        self.opt, _ = adam_steplr(
            param_leaves(self.tree), cfg["learning_rate"],
            weight_decay=cfg["weight_decay"],
            step_size_epochs=cfg["scheduler_step"],
            gamma=cfg["scheduler_gamma"])
        if fault == "state_unchanged":
            self.opt.step = lambda *a, **k: None
        self.step_fn = make_train_step(self.data.task, self.opt)
        self.order = train.Order(s_order, len(self.data.batches))
        self.done = 0

    def compared_order(self) -> list:
        """The samples of each compared batch, in step order."""
        bs = self.cell.traffic["batch_size"]
        return [list(range(j * bs, (j + 1) * bs))
                for j in super().compared_order()]


# modes/train.py's run, its globals but this module's Session
run = types.FunctionType(train.run.__code__,
                         dict(vars(train), Session=Session), "run",
                         train.run.__defaults__)
