"""A run with the timed path broken underneath must come out not
correct: a training step that leaves its state unchanged, an answer
altered where it is produced. (Batch 1 has no half to leave out; one
chip has no exchange between chips.)"""
from __future__ import annotations

import time

import pytest
import torch

import tiny
from benchmark import run


@pytest.mark.parametrize("name,fault", [
    ("gkn241_train", "state_unchanged"),
    ("mgkn85_train", "state_unchanged"),
    ("mgkn85_predict", "answer_altered")])
def test_fault_is_not_correct(name, fault):
    out = run.run_cell(tiny.cell(name), 11, 0.3, False, torch.device("cpu"),
                       fault=fault, t_start=time.perf_counter(),
                       log=lambda m: None)
    assert out["correct"] is False
    assert any(c["limit"] is not None and c["value"] > c["limit"]
               for c in out["compared"].values())
