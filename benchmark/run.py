#!/usr/bin/env python3
"""Runs one cell of the benchmark of graph_pde_tpu_torch once.

    python3 benchmark/run.py --workload <name> --seed <n> \
        --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with as many CUDA cards as the
cell asks for. Set-up (loading, kernel builds, warm-up, the compared
steps or warm-up requests) is timed as ``setup_s``; the window then
runs for ``--seconds``; ``--trace 1`` runs the window under
torch.profiler and reports the cell's per-layer metrics instead of its
end-to-end ones. Once the window has closed, the plain reference checks
what the timed path produced. Informational lines come first; the last
lines of standard error give each compared number beside its limit; the
last line of standard output is the result as one JSON object.

Exits non-zero, printing no result, without enough CUDA cards, when
the program is missing, or when JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# import the benchmark as the package ``benchmark`` from the checkout's
# root, never its modules by their bare names from the script's folder
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != BENCH]
sys.path.insert(0, str(ROOT))
# the program's build and kernel caches live at fixed paths inside the
# checkout (the port's own graph_pde_tpu_torch/_build/ is one); a few
# host threads keep one process's load steady
CACHE = ROOT / ".bench_cache"
ENV = {"TORCH_EXTENSIONS_DIR": str(CACHE / "torch_extensions"),
       "TRITON_CACHE_DIR": str(CACHE / "triton"),
       "USE_FLAX": "0"}
THREADS = "4"
FORBIDDEN = ("jax", "jaxlib", "flax", "graph_pde_tpu")


def loaded_forbidden() -> list:
    """Top-level module names, compared whole, that no run may load."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    os.environ.update(ENV)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ.setdefault(var, THREADS)
    import torch

    from benchmark import harness

    cell = harness.find_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"benchmark: needs {cell.chips} CUDA card(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              "; no result", file=sys.stderr)
        return 2
    torch.set_num_threads(int(os.environ["OMP_NUM_THREADS"]))
    card = harness.card()
    print(f"device {card['kind']} x {card['count']}; nvidia-smi "
          f"name, power.limit: {card['nvidia_smi']}", flush=True)
    from benchmark import cost
    print(f"peaks (H100 SXM, 700 W): bf16 {cost.PEAK_BF16_FLOPS:g} FLOP/s, "
          f"fp32 {cost.PEAK_F32_FLOPS:g} FLOP/s, {cost.PEAK_BYTES:g} B/s",
          flush=True)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda"))
    found = loaded_forbidden()
    if found:
        print(f"benchmark: loaded {found} (JAX or the JAX package); no "
              "result", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             fault=None, t_start: float = None, log=None) -> dict:
    """One run of ``cell``: the result object of the last line."""
    import torch

    from benchmark import compare, harness

    log = log or (lambda msg: print(msg, flush=True))
    out = cell.mode().run(cell, seed, seconds, trace, device,
                          T_START if t_start is None else t_start,
                          fault=fault, log=log)
    correct, compared = compare.verdict(out["numbers"], cell.limits)
    for name, c in compared.items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    if trace:
        metrics = harness.read_metrics(cell, out["context"])
    else:
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        metrics = {k: {"value": out["e2e"][k], "unit": u}
                   for k, u in units.items()}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(0) if device.type == "cuda"
                    else "cpu"),
           "count": cell.chips, "memory_peak_bytes": out["memory_peak"]}
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": dev}
    tr = out["context"].trace
    if trace and tr is not None:
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = tr.breakdown()
    result["compared"] = compared
    return result


if __name__ == "__main__":
    sys.exit(main())
