#!/usr/bin/env python3
"""Readings that the correctness limits are set from (not part of a
run): for each seed, the compared numbers of the program against the
plain reference, and of the control against it. The control is what
the configuration's ``control`` names, one precision below the
configuration's, put in the program's place: the plain reference
computed in that precision (``"run": "reference"``), or the program
with its own path to that precision switched on (``"run": "program"``;
``tf32``: torch's TF32 switch for float32 matmuls).

    python3 benchmark/readings.py --workload <name> --seeds 1 2 3 \
        [--what program control]

Training cells run the program's compared steps (no window), the
control's, the reference and the ratios' scale (where the configuration
names one) in one process a seed.
Serving cells read the control only (the program's readings are those
of ordinary runs): the control's answers to the requests a run of that
seed would compare first, against the reference's. Prints one JSON
line a seed.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != BENCH]
sys.path.insert(0, str(BENCH.parent))


def detail(prog: dict, ref: dict, p0: dict) -> dict:
    """Where a training reading comes from: each step's loss gap, the
    three worst leaves of the gradient and change gaps (each over the
    larger of its own and the median leaf's reference norm) and the
    median leaf's gap."""
    import statistics

    import torch

    out = {"loss_steps": [abs(x - y) / abs(y) for x, y in
                          zip(prog["loss"], ref["loss"])]}
    for key, a, b in (("grad1", prog["grad1"], ref["grad1"]),
                      ("change", {k: v.cpu() - p0[k] for k, v in
                                  prog["params"].items()},
                       {k: v.cpu() - p0[k] for k, v in
                        ref["params"].items()})):
        norm = lambda t: float(torch.linalg.vector_norm(t.cpu().double()))
        an = {k: norm(v) for k, v in a.items()}
        bn = {k: norm(v) for k, v in b.items()}
        med = statistics.median(bn.values())
        gaps = {k: abs(an[k] - bn[k]) / max(bn[k], med) for k in bn}
        out[key] = gaps
        out[key + "_median_leaf"] = statistics.median(gaps.values())
    return out


@contextlib.contextmanager
def program_precision(precision: str):
    """The program's own path to ``precision``, switched on."""
    import torch

    if precision != "tf32":
        raise ValueError(f"no program path to {precision!r}")
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def training(cell, seed: int, what, device, fault=None,
             repeat: bool = False) -> dict:
    from benchmark import compare
    from benchmark.modes.train import Session

    control = cell.cfg["control"]
    ses = Session(cell, seed, device, fault)
    prog = ses.compared_steps() if "program" in what else None
    ses.free()
    ctl = None
    if "control" in what and control["run"] == "program":
        with program_precision(control["precision"]):
            low = Session(cell, seed, device)
            ctl = low.compared_steps()
            low.free()
    ref = ses.reference()
    scale = (ses.reference(rounding=cell.cfg["scale"])
             if "scale" in cell.cfg else None)
    if "control" in what and control["run"] == "reference":
        ctl = ses.reference(rounding=control["precision"])
    out = {}
    if prog is not None:
        out["program"] = compare.training(prog, ref, ses.p0, scale)
        if repeat:
            out["detail"] = detail(prog, ref, ses.p0)
            again = Session(cell, seed, device)
            out["program_again"] = compare.training(
                again.compared_steps(), ref, ses.p0)
            again.free()
            out["reference_again"] = compare.training(ses.reference(), ref,
                                                      ses.p0)
    if ctl is not None:
        out["control"] = compare.training(ctl, ref, ses.p0, scale)
        if repeat:
            out["control_detail"] = detail(ctl, ref, ses.p0)
    return out


def serving(cell, seed: int, what, device, requests: int) -> dict:
    from benchmark import compare
    from benchmark.modes.serve import Session

    control = cell.cfg["control"]
    ses = Session(cell, seed, device)
    first = cell.traffic["warmup_requests"]
    ks = list(range(first, first + requests))
    if control["run"] == "program":
        with program_precision(control["precision"]):
            ses.start()
            answers = [ses.request() for _ in range(first + requests)]
        ses.free()
        ctl = {k: answers[k] for k in ks}
    else:
        for _ in range(first + requests):
            ses.served.append(ses.pick())
        ctl = ses.reference(ks, rounding=control["precision"])
    ref = ses.reference(ks)
    return {"control": {"field_gap": max(compare.field_gap(ctl[k], ref[k])
                                         for k in ks)}}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--what", nargs="+", default=["program", "control"])
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fault", default=None,
                    help="plant a fault in the program: state_unchanged")
    ap.add_argument("--detail", action="store_true",
                    help="per-step and per-leaf readings, and the program "
                    "and the reference each run twice")
    args = ap.parse_args()
    import torch

    from benchmark import harness

    cell = harness.find_cell(args.workload)
    dev = torch.device(args.device)
    for seed in args.seeds:
        t0 = time.perf_counter()
        if cell.traffic["kind"] == "train":
            out = training(cell, seed, args.what, dev, args.fault,
                           args.detail)
        else:
            out = serving(cell, seed, args.what, dev, args.requests)
        out = {k: {n: (v if not isinstance(v, float) or math.isfinite(v)
                       else str(v)) for n, v in d.items()}
               for k, d in out.items()}
        print(json.dumps({"workload": cell.name, "seed": seed, **out,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
