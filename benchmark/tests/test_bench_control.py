"""The control, what the configuration's ``control`` names one precision
below the configuration's put in the program's place, comes out not
correct under each cell's limits (at test sizes; the readings at the
cells' own sizes come from ``readings.py`` on the card). A control that
is the program with its own TF32 path switched on needs a CUDA card:
on the CPU that switch changes nothing."""
from __future__ import annotations

import pytest
import torch

import tiny
from benchmark import compare, readings
from benchmark.reference import common


@pytest.mark.parametrize("name", ["gkn241_train", "mgkn85_train",
                                  "mgkn85_predict"])
def test_control_is_not_correct(name):
    cell = tiny.cell(name)
    device = torch.device("cpu")
    if cell.cfg["control"]["run"] == "program":
        if not torch.cuda.is_available():
            pytest.skip("the program's TF32 path runs only on a CUDA card")
        device = torch.device("cuda")
    if cell.traffic["kind"] == "train":
        out = readings.training(cell, 3, ["control"], device)
    else:
        out = readings.serving(cell, 3, ["control"], device, requests=2)
    correct, compared = compare.verdict(out["control"], cell.limits)
    assert correct is False, compared


def test_control_is_not_the_ratios_scale():
    """Where a cell divides by a scale, its control is another run, so
    that the control's ratio is a reading and not 1 by construction."""
    for name in ("gkn241_train", "mgkn85_train"):
        cfg = tiny.cell(name).cfg
        if "scale" in cfg:
            assert (cfg["control"]["run"], cfg["control"]["precision"]) != (
                "reference", cfg["scale"])


def test_fp8_both_rounds_the_backward():
    """The GKN control's rounding: e4m3 forward, as the scale's; the
    gradient through it on e5m2's grid under a per-tensor scale."""
    x = torch.linspace(-1.0, 1.0, 97, requires_grad=True)
    y = common.fp8_both(x)
    assert torch.equal(y.detach(), common.fp8(x).detach())
    g = torch.linspace(1e-7, 3e-5, 97)
    (y * g).sum().backward()
    scale = torch.finfo(torch.float8_e5m2).max / g.abs().max()
    assert torch.equal(x.grad, (g * scale).to(torch.float8_e5m2).float()
                       / scale)
    assert not torch.equal(x.grad, g)
    assert torch.all(x.grad > 0)      # scaled, nothing underflows
