"""The harness: finds a cell's files by name, runs its traffic's mode,
reads its per-layer metrics and assembles the result line.

Everything that belongs to one configuration, traffic mix or metric is
found by name:

- ``BENCHMARK.json``'s ``configs`` entry gives the configuration's file;
  its ``family`` names the system under test (``systems/<family>.py``)
  and the plain reference (``reference/<family>.py``);
- ``traffic/<traffic>.json`` holds the mix's parameters; its ``kind``
  names the mode that drives it (``modes/<kind>.py``);
- ``metrics/<name>.py`` reads one per-layer metric (``read(ctx)``,
  None where it finds nothing to read);
- ``limits/<workload>.json`` holds the limit of each compared number.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import subprocess
from pathlib import Path

import torch

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One workload of BENCHMARK.json with its files read."""
    name: str
    cfg: dict
    traffic: dict
    limits: dict
    end_to_end: list      # the e2e metric entries this cell reports
    per_layer: list       # the per-layer metric entries this cell reports
    chips: int
    root: Path = ROOT     # the checkout its files were read from

    @property
    def family(self) -> str:
        return self.cfg["family"]

    def system(self):
        return importlib.import_module(f"benchmark.systems.{self.family}")

    def reference(self):
        return importlib.import_module(f"benchmark.reference.{self.family}")

    def mode(self):
        return importlib.import_module(
            f"benchmark.modes.{self.traffic['kind']}")


def _reports(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def find_cell(name: str, spec: dict = None, root: Path = ROOT) -> Cell:
    """The workload ``name`` of ``spec`` (default: ``root``'s
    BENCHMARK.json) with its configuration, traffic and limits, read
    from the checkout at ``root``."""
    spec = spec if spec is not None else load_json(root / "BENCHMARK.json")
    bench = root / BENCH.name
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: "
                         f"{sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    e2e = [m for m in spec["end_to_end"] if _reports(m, name)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in e2e_names)]
    limits_path = bench / "limits" / f"{name}.json"
    return Cell(name=name, cfg=load_json(root / conf["file"]),
                traffic=load_json(bench / "traffic" / f"{w['traffic']}.json"),
                limits=load_json(limits_path) if limits_path.exists() else {},
                end_to_end=e2e, per_layer=per_layer, chips=w["chips"],
                root=root)


def metric_reader(name: str, root: Path = ROOT):
    """The ``read`` function of ``metrics/<name>.py`` in the checkout at
    ``root``."""
    path = root / BENCH.name / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Context:
    """What a per-layer metric reads, from the traced run."""
    trace: object          # trace.Trace, or None
    window_s: float
    work: int              # steps or requests in the traced window
    spans: dict            # benchmark span name -> [seconds, ...]
    flops: dict            # useful FLOPs in the window: {"bf16", "f32"}
    shapes: dict           # what the system reports of the cell's shapes
    counters: dict         # launch counters summed over the window


def read_metrics(cell: Cell, ctx: Context) -> dict:
    out = {}
    for m in cell.per_layer:
        value = metric_reader(m["name"], cell.root)(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def launch_counters() -> dict:
    """The port's launch counters by kernel form."""
    cc, fe, fi = (importlib.import_module(f"graph_pde_tpu_torch.ops.{m}")
                  for m in ("cached_contraction", "fused_edge_conv",
                            "fused_iterate"))

    return {
        "K1 tc": (fe.fused_edge_messages, "tc_launches"),
        "K1 simt": (fe.fused_edge_messages, "simt_launches"),
        "K1 general": (fe.fused_edge_messages, "general_launches"),
        "B1-bwd tc": (fe.fused_edge_messages_bwd, "tc_launches"),
        "B1-bwd simt": (fe.fused_edge_messages_bwd, "simt_launches"),
        "K2": (fi.fused_iterate_total, "launches"),
        "B2-bwd": (fi.fused_iterate_bwd, "launches"),
        "B3-fwd": (cc.cached_contraction, "launches"),
        "B3-bwd": (cc.cached_contraction_bwd, "launches"),
    }


def zero_counters() -> None:
    for fn, attr in launch_counters().values():
        setattr(fn, attr, 0)


def read_counters() -> dict:
    return {k: getattr(fn, attr) for k, (fn, attr)
            in launch_counters().items()}


def card() -> dict:
    """Name, count and power limit of the cards."""
    out = {"kind": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count()}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        out["nvidia_smi"] = smi.stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as err:
        out["nvidia_smi"] = [f"unavailable: {err}"]
    return out


def build_kernels(sources) -> float:
    """Builds the port's CUDA sources that the cell launches and its
    native graph builder, where missing; returns the seconds taken."""
    import time

    from graph_pde_tpu_torch.graph import native
    from graph_pde_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    if sources:
        kernels.build(sources)
    try:
        native.build()
    except RuntimeError:
        pass   # the port falls back to cKDTree
    return time.perf_counter() - t0
