"""The orthogonal-MGKN cell (``ortho1024_train``): its files found by
name, a tiny run end to end through ``modes/train_burgers.py`` traced
and untraced, Adam's no-op refused by its limits, its control refused
(on a card), and its plain reference free of JAX and of the port."""
from __future__ import annotations

import ast
import dataclasses
import subprocess
import sys
import time

import pytest
import torch

from benchmark import compare, harness, readings_burgers, run
from benchmark.reference import mgkn_orthogonal as ref

NAME = "ortho1024_train"
TINY = {"source_res": 256, "s": 32, "width": 8, "ker_width": 64,
        "depth": 2}
METRICS = ["host_ms.ortho_train", "idle_share.ortho_train",
           "mfu.ortho_train", "kbuild_ms.ortho_train",
           "fine_conv_ms.ortho_train", "coarse_conv_ms.ortho_train",
           "k_mb.ortho_train"]


def tiny(limits: dict = None) -> harness.Cell:
    """The cell at s=32, two batches of 3."""
    c = harness.find_cell(NAME)
    return dataclasses.replace(
        c, cfg=dict(c.cfg, **TINY),
        traffic=dict(c.traffic, samples=6, batch_size=3),
        limits=c.limits if limits is None else limits)


def test_cell_files_found_by_name():
    c = harness.find_cell(NAME)
    assert c.traffic["kind"] == "train_burgers" and c.chips == 1
    assert [m["name"] for m in c.end_to_end] == ["setup_s", "mgkn_step_ms"]
    assert sorted(m["name"] for m in c.per_layer) == sorted(METRICS)
    for m in c.per_layer:
        assert callable(harness.metric_reader(m["name"]))
    compared = {k: v for k, v in c.limits.items() if v is not None}
    assert set(compared) == {"loss_gap", "grad_gap", "change_median"}
    assert all(v > 0 for v in compared.values())
    assert c.traffic["samples"] % c.traffic["batch_size"] == 0


@pytest.mark.parametrize("trace", [False, True])
def test_tiny_run_end_to_end(trace):
    out = run.run_cell(tiny(), 2 ** 31 + 5, 0.3, trace, torch.device("cpu"),
                       t_start=time.perf_counter(), log=lambda m: None)
    assert out["correct"] is True and out["attempted"] >= 1
    if not trace:
        assert set(out["metrics"]) == {"setup_s", "mgkn_step_ms"}
        return
    got = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(got) == set(METRICS) and None not in got.values()
    # every edge list's K, [B * E_l, width^2] float32, once a step
    edges = sum(e.shape[1] for e in ref.edge_lists(32, True))
    assert got["k_mb.ortho_train"] == edges * 3 * 8 ** 2 * 4 / 2 ** 20


def test_adam_no_op_is_refused():
    out = run.run_cell(tiny(), 2 ** 31 + 6, 0.3, False, torch.device("cpu"),
                       fault="state_unchanged", t_start=time.perf_counter(),
                       log=lambda m: None)
    assert out["correct"] is False
    assert any(c["limit"] is not None and c["value"] > c["limit"]
               for c in out["compared"].values())


def test_control_is_not_correct():
    if not torch.cuda.is_available():
        pytest.skip("the program's TF32 path runs only on a CUDA card")
    cell = tiny()
    out = readings_burgers.training(cell, 3, ["control"],
                                    torch.device("cuda"))
    correct, compared = compare.verdict(out["control"], cell.limits)
    assert correct is False, compared


def test_reference_imports_neither_jax_nor_the_port():
    path = harness.BENCH / "reference" / "mgkn_orthogonal.py"
    tree = ast.parse(path.read_text())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    names |= {n.module or "" for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)}
    assert not {n.split(".")[0] for n in names} & set(run.FORBIDDEN + (
        "graph_pde_tpu_torch",))
    code = ("import sys; import benchmark.reference.mgkn_orthogonal; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    loaded = subprocess.run([sys.executable, "-c", code], check=True,
                            capture_output=True, text=True,
                            cwd=harness.ROOT).stdout
    for bad in run.FORBIDDEN + ("graph_pde_tpu_torch",):
        assert f"'{bad}'" not in loaded
