#!/usr/bin/env python3
"""``readings.py``'s training readings for the cells whose traffic kind
is ``train_burgers``: for each seed, the compared numbers of the
program against the plain reference, and of the control (the program
with TF32 on) against it, from the compared steps alone (no window).

    python3 benchmark/readings_burgers.py --workload ortho1024_train \
        --seeds 1 2 3 [--what program control] [--fault state_unchanged]

Prints one JSON line a seed.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != BENCH]
sys.path.insert(0, str(BENCH.parent))


def training(cell, seed: int, what, device, fault=None) -> dict:
    """``readings.training`` over ``modes/train_burgers.py``'s Session."""
    from benchmark import compare, readings
    from benchmark.modes.train_burgers import Session

    control = cell.cfg["control"]
    if control["run"] != "program":
        raise ValueError("the Burgers cells' control is the program's")
    ses = Session(cell, seed, device, fault)
    prog = ses.compared_steps() if "program" in what else None
    ses.free()
    ctl = None
    if "control" in what:
        with readings.program_precision(control["precision"]):
            low = Session(cell, seed, device)
            ctl = low.compared_steps()
            low.free()
    ref = ses.reference()
    out = {}
    if prog is not None:
        out["program"] = compare.training(prog, ref, ses.p0)
    if ctl is not None:
        out["control"] = compare.training(ctl, ref, ses.p0)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--what", nargs="+", default=["program", "control"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fault", default=None,
                    help="plant a fault in the program: state_unchanged")
    args = ap.parse_args()
    import torch

    from benchmark import harness

    cell = harness.find_cell(args.workload)
    if cell.traffic["kind"] != "train_burgers":
        raise SystemExit(f"{cell.name} is not a train_burgers cell")
    dev = torch.device(args.device)
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = training(cell, seed, args.what, dev, args.fault)
        out = {k: {n: (v if not isinstance(v, float) or math.isfinite(v)
                       else str(v)) for n, v in d.items()}
               for k, d in out.items()}
        print(json.dumps({"workload": cell.name, "seed": seed, **out,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
