#!/usr/bin/env python3
"""The readings that ``uai1_train``'s limits are set from (not part of a
run): for each seed, the compared numbers of the program against the
plain reference, and of its two controls against it, from the compared
steps alone (no window):

- ``control``: the program with TF32 on (the configuration's
  ``control``);
- ``control_k``: the program with its cached K stored in bfloat16 (as
  the JAX package's 2 GiB gate stores this K), which the cell's K check
  (``systems/gkn_uai1.py`` ``KCheck``) turns into NaN predictions;
- ``witness``: the program again, the unfused kcached path (B3 on the
  same float32 K) and the reference in float32 and in float64, each
  held against the float64 reference (``*_vs_f64``), so that a seed
  whose program reads far from the float32 reference shows which side
  stands apart.

    python3 benchmark/readings_uai1.py --seeds 1 2 3 \
        [--what program control control_k witness]

Prints one JSON line a seed.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

import torch

BENCH = Path(__file__).resolve().parent
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != BENCH]
sys.path.insert(0, str(BENCH.parent))


def _steps(cell, seed: int, device, fused=None) -> dict:
    import dataclasses

    from benchmark.modes.train import Session

    ses = Session(cell, seed, device)
    if fused is not None:
        task = ses.data.task
        task.cfg = dataclasses.replace(task.cfg, kcached_fused=fused)
    out = ses.compared_steps()
    ses.free()
    return out


def reference_f64(ses) -> dict:
    """The reference's compared steps in float64, on the same float32
    inputs and weights."""
    import torch

    from benchmark.reference import common, gkn, gkn_uai1

    cfg = ses.cell.cfg
    with common.fp32_exact():
        prob = gkn_uai1.Problem(cfg, ses.fields, ses.device)

        def loss(p, j):
            s = prob.sample(j)
            smp = gkn.Sample(s.x.double(), s.y.double(), s.attr.double())
            return gkn_uai1.loss(p, cfg, prob, smp, common.exact)

        params = {k: v.to(ses.device, torch.float64).clone()
                  for k, v in ses.p0.items()}
        return common.train_three(params, loss, ses.compared_order(),
                                  cfg["learning_rate"], cfg["weight_decay"])


def training(cell, seed: int, what, device) -> dict:
    from benchmark import compare, readings
    from benchmark.modes.train import Session
    from graph_pde_tpu_torch.models import gkn

    ses = Session(cell, seed, device)
    runs = ({"program": ses.compared_steps()}
            if {"program", "witness"} & set(what) else {})
    ses.free()
    if "control" in what:
        with readings.program_precision(cell.cfg["control"]["precision"]):
            runs["control"] = _steps(cell, seed, device)
    if "control_k" in what:
        dtype = gkn.cached_k_dtype
        gkn.cached_k_dtype = lambda *a: torch.bfloat16
        try:
            runs["control_k"] = _steps(cell, seed, device)
        finally:
            gkn.cached_k_dtype = dtype
    if "witness" in what:
        runs["program_again"] = _steps(cell, seed, device)
        runs["unfused"] = _steps(cell, seed, device, fused="off")
    ref = ses.reference()
    out = {k: compare.training(v, ref, ses.p0) for k, v in runs.items()}
    if "witness" in what:
        for k in ("program", "program_again", "unfused"):
            out[k]["leaf_grad_gaps"] = _leaf_grad_gaps(runs[k], ref)
        ref64 = reference_f64(ses)
        for k, v in dict(runs, reference=ref).items():
            out[f"{k}_vs_f64"] = compare.training(v, ref64, ses.p0)
            out[f"{k}_vs_f64"]["leaf_grad_gaps"] = _leaf_grad_gaps(v, ref64)
    return out


def _leaf_grad_gaps(run: dict, ref: dict) -> dict:
    """Each leaf's first-gradient gap, as ``grad_gap`` takes the worst."""
    from benchmark import compare

    cpu = lambda d: {n: g.detach().cpu() for n, g in d["grad1"].items()}
    return dict(zip(ref["grad1"], compare.leaf_gaps(cpu(run), cpu(ref))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="uai1_train")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--what", nargs="+",
                    default=["program", "control", "control_k"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    from benchmark import harness

    cell = harness.find_cell(args.workload)
    dev = torch.device(args.device)
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = training(cell, seed, args.what, dev)
        out = {k: {n: (v if not isinstance(v, float) or math.isfinite(v)
                       else str(v)) for n, v in d.items()}
               for k, d in out.items()}
        print(json.dumps({"workload": cell.name, "seed": seed, **out,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
