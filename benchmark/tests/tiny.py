"""Tiny versions of the benchmark's cells, for the CPU tests: the same
files and code paths at sizes a test run holds."""
from __future__ import annotations

import copy
import dataclasses

from benchmark import harness

# per configuration: the keys changed from the full-size file
TINY = {
    "gkn_darcy241": {"source_res": 21, "radius": 0.12, "node_block": 256,
                     "width": 8, "ker_width": 16, "depth": 2,
                     "kernel_layers": [6, 8, 16, 64]},
    "mgkn_darcy85": {"source_res": 41, "downsample": 2,
                     "points": [40, 12, 4], "width": 8, "ker_width": 16,
                     "depth": 2},
}
TRAFFIC = {"train": {"samples": 4},
           "serve": {"fields": 3, "warmup_requests": 1,
                     "compared_share": 1.0}}


def cell(name: str, limits: dict = None) -> harness.Cell:
    """Workload ``name`` of BENCHMARK.json at a tiny size."""
    spec = harness.load_json(harness.ROOT / "BENCHMARK.json")
    c = harness.find_cell(name, spec)
    conf = {w["name"]: w["config"] for w in spec["workloads"]}[name]
    cfg = dict(copy.deepcopy(c.cfg), **TINY[conf])
    traffic = dict(c.traffic, **TRAFFIC[c.traffic["kind"]])
    return dataclasses.replace(c, cfg=cfg, traffic=traffic,
                               limits=c.limits if limits is None else limits)
