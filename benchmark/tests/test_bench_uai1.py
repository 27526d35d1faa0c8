"""The UAI GKN's cell ``uai1_train``: its files found by name, the bounds
of K2 and B2-bwd against hand counts, and a planted fault (Adam's step a
no-op) coming out not correct on the CPU at a tiny size."""
from __future__ import annotations

import copy
import dataclasses
import time

import pytest
import torch

from benchmark import cost, cost_iterate, harness, run

# the configuration's keys changed for the tiny run: s=11, width 16,
# kappa (6, 32, 32, 256), depth 3
TINY = {"source_res": 41, "radius": 0.25, "width": 16, "ker_width": 32,
        "depth": 3, "kernel_layers": [6, 32, 32, 256]}


def tiny_cell(limits=None):
    c = harness.find_cell("uai1_train")
    return dataclasses.replace(
        c, cfg=dict(copy.deepcopy(c.cfg), **TINY),
        traffic=dict(c.traffic, samples=4),
        limits=c.limits if limits is None else limits)


def test_cell_files_found_by_name():
    c = harness.find_cell("uai1_train")
    assert c.family == "gkn_uai1" and c.traffic["kind"] == "train"
    assert c.system().kernel_sources(c.cfg) == ("fused_iterate",
                                                "fused_iterate_bwd")
    assert c.reference().train_steps
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
    assert len(c.end_to_end) == 2
    assert {m["name"] for m in c.per_layer} == {
        f"{k}.uai1_train" for k in ("host_ms", "idle_share", "mfu",
                                    "kbuild_ms", "k_mb", "k2_roofline",
                                    "b2_bwd_roofline")}
    for m in c.per_layer:
        assert callable(harness.metric_reader(m["name"]))
    compared = {k: v for k, v in c.limits.items() if v is not None}
    assert set(compared) == {"grad_gap", "change_median"}
    assert all(0 < v < 1 for v in compared.values())


def test_iterate_costs_against_hand_counts():
    # 1,024 edges (1,000 valid), 100 nodes, 64 -> 64, a float32 K
    k2 = cost_iterate.k2_cost(1024, 1000, 100, 64, 64)
    assert k2["flops"] == 2 * 1000 * 4096
    assert k2["bytes"] == (4 * 1000 * 4096 + 9 * 1024 + 4 * 100 * 64
                           + 8 * 101 + 4 * 100 * 64)
    b2 = cost_iterate.b2_bwd_cost(1024, 1000, 100, 64, 64, k_bytes=2)
    assert b2["flops"] == 2 * 1000 * 4096
    assert b2["bytes"] == (2 * 1000 * 4096 + 9 * 1024 + 4 * 100 * 64
                           + 4 * 1024 * 128)
    for r in (k2, b2):
        # 2 FLOPs a K element of at least 2 bytes: bound by the bytes
        assert r["bound_by"] == "bytes"
        assert r["bound_s"] == pytest.approx(r["bytes"] / cost.PEAK_BYTES)


def test_metrics_read_nothing_without_the_kernels():
    """Where the program launched neither kernel, nor counted K (a
    parent without the fused route), the readers return None."""
    ctx = harness.Context(trace=None, window_s=1.0, work=3,
                          spans={"train_step": [0.1] * 3}, flops={},
                          shapes={"nodes": 121, "edges": 2077,
                                  "edges_padded": 2560, "width": 16},
                          counters={"K2": 0, "B2-bwd": 0})
    for name in ("k2_roofline", "b2_bwd_roofline", "kbuild_ms", "k_mb",
                 "idle_share", "mfu"):
        assert harness.metric_reader(f"{name}.uai1_train")(ctx) is None
    assert harness.metric_reader("host_ms.uai1_train")(ctx) == \
        pytest.approx(100.0)


def test_fault_is_not_correct():
    out = run.run_cell(tiny_cell(), 11, 0.3, False, torch.device("cpu"),
                       fault="state_unchanged",
                       t_start=time.perf_counter(), log=lambda m: None)
    assert out["correct"] is False
    assert out["compared"]["change_median"]["value"] > \
        out["compared"]["change_median"]["limit"]


def test_lowered_k_is_not_correct(monkeypatch, capsys):
    """K stored below the configuration's float32 fails the cell's K
    check: every compared number reads infinite."""
    from graph_pde_tpu_torch.models import gkn

    monkeypatch.setattr(gkn, "_KCACHED_F32_MAX_BYTES", 0)
    out = run.run_cell(tiny_cell(), 2 ** 31 + 7, 0.3, False,
                       torch.device("cpu"), t_start=time.perf_counter(),
                       log=lambda m: None)
    assert out["correct"] is False
    assert all(c["value"] == "inf" for c in out["compared"].values())
    assert "K is not float32" in capsys.readouterr().err


def test_tiny_run_is_correct():
    out = run.run_cell(tiny_cell(), 2 ** 31 + 7, 0.3, False,
                       torch.device("cpu"), t_start=time.perf_counter(),
                       log=lambda m: None)
    assert out["correct"] is True, out["compared"]
