"""BENCHMARK.json against the contract's shape, every file it names
found by name, and a new cell and a new metric taken as data files
alone."""
from __future__ import annotations

import dataclasses
import json
import re
import shutil
import time

import pytest
import torch

import tiny
from benchmark import harness, run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def spec():
    return harness.load_json(harness.ROOT / "BENCHMARK.json")


def test_contract_shape(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["benchmark"]
    assert 1 <= spec["run_seconds"] <= 51
    names = [c["name"] for c in spec["configs"]]
    cells = [w["name"] for w in spec["workloads"]]
    metrics = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    for group in (names, cells, metrics):
        assert len(group) == len(set(group))
        assert all(NAME.match(n) for n in group)
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
    pairs = [(w["config"], w["traffic"]) for w in spec["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= set(cells)
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    assert len(json.dumps(spec)) < 64 * 1024


@pytest.mark.parametrize("cell", ["gkn241_train", "mgkn85_train",
                                  "mgkn85_predict"])
def test_cell_files_found_by_name(spec, cell):
    c = harness.find_cell(cell, spec)
    assert c.cfg["family"] and c.traffic["kind"]
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
    assert len(c.end_to_end) >= 2 and c.per_layer
    assert c.mode().run and c.system().weight_specs(c.cfg)
    assert c.reference()
    for m in c.per_layer:
        assert callable(harness.metric_reader(m["name"]))
    compared = [v for v in c.limits.values() if v is not None]
    assert compared and all(v > 0 for v in compared)


def test_new_cell_and_metric_are_data_files_alone(tmp_path, spec):
    """A cell of a new traffic mix and a new per-layer metric, added as
    files beside the benchmark's, run without a line of harness code
    changed."""
    bench = tmp_path / "benchmark"
    for d in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(harness.BENCH / d, bench / d)
    (bench / "traffic" / "train_rotation3.json").write_text(json.dumps(
        dict(harness.load_json(harness.BENCH / "traffic"
                               / "train_rotation8.json"), samples=3)))
    shutil.copy(bench / "limits" / "mgkn85_train.json",
                bench / "limits" / "mgkn85_train3.json")
    (bench / "metrics" / "steps_seen.train.py").write_text(
        "def read(ctx):\n    return float(ctx.work)\n")
    new = json.loads(json.dumps(spec))
    new["workloads"].append({"name": "mgkn85_train3",
                             "config": "mgkn_darcy85",
                             "traffic": "train_rotation3", "chips": 1,
                             "why": "three samples"})
    new["per_layer"].append({"name": "steps_seen.train", "unit": "steps",
                             "better": "higher", "source": "host_clock",
                             "layer": "training entry",
                             "moves": "mgkn_step_ms",
                             "workloads": ["mgkn85_train3"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(new))
    cell = harness.find_cell("mgkn85_train3", root=tmp_path)
    assert cell.traffic["samples"] == 3
    small = tiny.cell("mgkn85_train")
    cell = dataclasses.replace(cell, cfg=small.cfg,
                               traffic=dict(cell.traffic, samples=3),
                               limits={k: 1.0 for k in cell.limits})
    out = run.run_cell(cell, 5, 0.3, True, torch.device("cpu"),
                       t_start=time.perf_counter(), log=lambda m: None)
    assert out["metrics"]["steps_seen.train"]["value"] == out["attempted"]
    # the existing metrics list their cells; the new cell takes only its own
    assert set(out["metrics"]) == {"steps_seen.train"}
