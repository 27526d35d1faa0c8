"""The frozen plain references against the port on the CPU at tiny
sizes, through a whole harness run: in float32 the two agree to
rounding; the GKN's bf16 path stays within bf16's reach."""
from __future__ import annotations

import dataclasses
import time

import pytest
import torch

import tiny
from benchmark import run

CPU = torch.device("cpu")


def _run(cell, trace=False, seconds=0.3, fault=None, seed=2 ** 40 + 7):
    return run.run_cell(cell, seed, seconds, trace, CPU, fault=fault,
                        t_start=time.perf_counter(), log=lambda m: None)


@pytest.mark.parametrize("name,dtype", [("gkn241_train", None),
                                        ("mgkn85_train", None),
                                        ("mgkn85_predict", None)])
def test_reference_agrees_in_float32(name, dtype):
    cell = tiny.cell(name)
    cell = dataclasses.replace(cell, cfg=dict(cell.cfg,
                                              compute_dtype=dtype))
    out = _run(cell)
    numbers = {k: v["value"] for k, v in out["compared"].items()
               if not k.endswith("_ratio")}
    assert max(numbers.values()) < 1e-5, numbers
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["correct"] is True


def test_gkn_bf16_within_bf16_reach():
    out = _run(tiny.cell("gkn241_train"))
    numbers = {k: v["value"] for k, v in out["compared"].items()}
    assert 1e-5 < max(v for k, v in numbers.items()
                      if not k.endswith("_ratio")) < 5e-2, numbers
    # nearer the reference than the fp8 scale, as on the card
    assert max(v for k, v in numbers.items() if k.endswith("_ratio")) < 0.5
    assert out["correct"] is True


def test_result_line_keys():
    out = _run(tiny.cell("mgkn85_train"))
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "compared"
    assert set(out["metrics"]) == {"setup_s", "mgkn_step_ms"}
    assert all(v["value"] > 0 for v in out["metrics"].values())
    traced = _run(tiny.cell("mgkn85_predict"), trace=True, seconds=0.5)
    assert {"busy_s", "window_s"} <= set(traced["device"])
    assert set(traced["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "setup_s" not in traced["metrics"]
