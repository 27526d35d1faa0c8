#!/usr/bin/env python3
"""Runs one cell traced, as ``run.py --trace 1`` does, and prints where
the host was when the device sat idle, by the program's own spans.

    python3 benchmark/gaps.py --workload <name> --seed <n> --seconds <s>

from the root of a checkout, on a machine with a CUDA card. The window
opens with a ~2 ms device sleep that measures the profiler's clock
error in this session (``clock_offset_ms``: the host's stamp of the
sleep's end less the profiler's), which is taken out of the device's
times before they are laid over the spans. Prints the result line of
the traced run, then one JSON object: ``idle_gaps``,
the longest idle gaps of the device, each named by the benchmark's span
and the program's spans open at its middle
(``program_spans.gap_names``, e.g. ``request/split/split.connect``);
``idle_by_name``, the seconds of every gap summed by that name;
``spans_ms`` and ``spans_count``, each program span's total ms and
number a step or request; and ``counters``, each program counter a step
or request.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != BENCH]
sys.path.insert(0, str(BENCH.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--top", type=int, default=20)
    args = ap.parse_args(argv)

    from benchmark import run
    os.environ.update(run.ENV)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ.setdefault(var, run.THREADS)
    import torch

    from benchmark import harness, program_spans, trace
    from graph_pde_tpu_torch.utils import tracing

    if not torch.cuda.is_available():
        print("gaps: needs a CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(int(os.environ["OMP_NUM_THREADS"]))
    seen = {}
    enter, read_trace = trace.Tracer.__enter__, trace.read

    def probed_enter(self):
        """The window's first device operation: a ~2 ms sleep whose end
        the host stamps once the device is done, to measure the
        profiler's clock error in this session."""
        out = enter(self)
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        torch.cuda._sleep(4_000_000)
        torch.cuda.synchronize()
        seen["probe_end_ns"] = time.time_ns()
        return out

    def naming_read(prof, window_s, spans):
        probe = next(iv for iv in program_spans.device_intervals(prof)
                     if iv[1] - iv[0] > 500_000)
        seen["offset_ns"] = seen["probe_end_ns"] - probe[1]
        seen["gaps"] = program_spans.named_gaps(
            prof, spans, tracing.profiled(), seen["offset_ns"])
        return read_trace(prof, window_s, spans)

    trace.Tracer.__enter__ = probed_enter
    trace.read = naming_read
    cell = harness.find_cell(args.workload)
    result = run.run_cell(cell, args.seed, args.seconds, True,
                          torch.device("cuda"))
    print(json.dumps(result), flush=True)
    rec, work = tracing.profiled(), result["attempted"]
    by_name = collections.Counter()
    for name, seconds in seen["gaps"]:
        by_name[name] += seconds
    spans, counts = collections.Counter(), collections.Counter()
    for n, _, t0, t1 in rec.spans:
        if t1 is not None:
            spans[n] += (t1 - t0) * 1e-6 / work
            counts[n] += 1 / work
    print(json.dumps({
        "work": work,
        "clock_offset_ms": seen["offset_ns"] * 1e-6,
        "idle_gaps": seen["gaps"][:args.top],
        "idle_by_name": by_name.most_common(),
        "spans_ms": spans.most_common(),
        "spans_count": counts.most_common(),
        "counters": {k: v / work for k, v in rec.counters.items()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
