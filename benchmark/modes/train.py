"""Training traffic: a closed loop of the program's training step over
seeded samples in a seeded shuffle.

Set-up builds one training step object (model, Adam, step function)
and drives it from the seed through the compared steps, on samples that
all differ; the reference follows the same steps from the same weights
once the window has closed. The window then runs the same object on
for ``seconds``, every step timed by the benchmark's own span around
the program's call, and ends at a device sync.
"""
from __future__ import annotations

import contextlib
import gc
import statistics
import time

import numpy as np
import torch

from .. import compare, fields, harness, weights
from ..trace import Spans, Tracer


class Order:
    """Sample indices: one seeded permutation of the samples an epoch."""

    def __init__(self, seed: int, n: int):
        self.rng, self.n, self.seq = np.random.default_rng(seed), n, []

    def __getitem__(self, i: int) -> int:
        while len(self.seq) <= i:
            self.seq.extend(int(j) for j in self.rng.permutation(self.n))
        return self.seq[i]


class Session:
    """A cell's training step object and what set-up read from it."""

    def __init__(self, cell, seed: int, device, fault=None):
        from graph_pde_tpu_torch.train import adam_steplr, make_train_step
        from graph_pde_tpu_torch.train.trainer import param_leaves

        cfg, traffic = cell.cfg, cell.traffic
        self.cell, self.device = cell, device
        self.marks = [("start", time.perf_counter())]
        s_fields, s_weights, s_order = fields.seeds(seed, 3)
        self.fields = fields.darcy_fields(np.random.default_rng(s_fields),
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
        self.order = Order(s_order, traffic["samples"])
        self.done = 0

    def step(self):
        out = self.step_fn(self.tree, self.data.batches[self.order[self.done]])
        self.done += 1
        return out

    def compared_steps(self) -> dict:
        """The first steps, read as the comparison needs them: each
        loss, the gradient the optimizer took at step 1 (its first
        moment over 1 - beta1) and the parameters after the last."""
        beta1 = self.opt.param_groups[0]["betas"][0]
        losses, grad1 = [], None
        for i in range(self.cell.traffic["compared_steps"]):
            losses.append(self.step()["loss"])
            if i == 0:
                grad1 = {}
                for k, p in self.leaves.items():
                    m = self.opt.state.get(p, {}).get("exp_avg")
                    grad1[k] = (torch.zeros_like(p) if m is None
                                else m / (1 - beta1)).detach().cpu()
        return {"loss": [float(v) for v in losses], "grad1": grad1,
                "params": {k: p.detach().cpu().clone()
                           for k, p in self.leaves.items()}}

    def compared_order(self) -> list:
        return [self.order[i]
                for i in range(self.cell.traffic["compared_steps"])]

    def free(self):
        """Drops the program's state so that the reference has the
        card."""
        for name in ("data", "leaves", "tree", "opt", "step_fn"):
            setattr(self, name, None)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, rounding: str = "float32") -> dict:
        return self.cell.reference().train_steps(
            self.cell.cfg, self.p0, self.fields, self.compared_order(),
            self.device, rounding=rounding,
            graph_seed=self.cell.traffic.get("graph_seed"))


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        fault=None, log=print) -> dict:
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    ses = Session(cell, seed, device, fault)
    ses.marks.append(("step object", time.perf_counter()))
    prog = ses.compared_steps()
    sync()
    ses.marks.append(("compared steps", time.perf_counter()))
    setup_s = time.perf_counter() - t_start
    log("setup: " + ", ".join(f"{name} {b - a:.3f} s" for (_, a), (name, b)
                              in zip(ses.marks, ses.marks[1:]))
        + f" (imports and start before: {ses.marks[0][1] - t_start:.3f} s)")
    log(f"build_s {ses.build_s:.3f} (kernels and graph builder, where "
        f"missing)")
    log(f"setup_s {setup_s:.3f}")

    harness.zero_counters()
    first, spans = ses.done, Spans()
    with Tracer(sync, spans) if trace else contextlib.nullcontext() as tracer:
        t0 = time.perf_counter()
        while True:
            spans.call("train_step", ses.step)
            if time.perf_counter() - t0 >= seconds:
                break
        sync()
        window_s = time.perf_counter() - t0
    steps = ses.done - first
    counters = harness.read_counters()
    peak = (torch.cuda.max_memory_allocated() if device.type == "cuda"
            else 0)
    flops = {"bf16": 0.0, "f32": 0.0}
    for i in range(first, ses.done):
        for k, v in ses.data.flops[ses.order[i]].items():
            flops[k] += v
    calls = spans.seconds("train_step")
    tenths = [round(1e3 * sorted(calls)[int(q * (steps - 1))], 3)
              for q in (0.1, 0.5, 0.9)]
    halves = [round(1e3 * statistics.mean(h), 3)
              for h in (calls[:steps // 2], calls[steps // 2:]) if h]
    log(f"steps in window {steps}, window_s {window_s:.6f}; a step's call "
        f"p10/p50/p90 {tenths} ms, first and second half {halves} ms")
    if tracer:
        log(f"profiler stop and trace read {tracer.read_s:.3f} s")
    log(f"launches a step {({k: v / steps for k, v in counters.items() if v})}")
    log(f"memory_peak_bytes {peak} ({peak / 2 ** 30:.3f} GiB)")
    ctx = harness.Context(
        trace=tracer.trace if tracer else None,
        window_s=tracer.trace.window_s if tracer else window_s, work=steps,
        spans={"train_step": calls}, flops=flops, shapes=ses.data.shapes,
        counters=counters)
    ses.free()
    t_ref = time.perf_counter()
    ref = ses.reference()
    scale = (ses.reference(rounding=cell.cfg["scale"])
             if "scale" in cell.cfg else None)
    log(f"reference_s {time.perf_counter() - t_ref:.3f} (the ratios' "
        f"scale {'too' if scale else 'not'})")
    return dict(setup_s=setup_s, window_s=window_s, attempted=steps,
                failed=0, memory_peak=peak, context=ctx,
                # the step time, under the name the cell reports it by
                e2e={"setup_s": setup_s, **{
                    m["name"]: 1e3 * window_s / steps
                    for m in cell.end_to_end if m["name"] != "setup_s"}},
                numbers=compare.training(prog, ref, ses.p0, scale))
