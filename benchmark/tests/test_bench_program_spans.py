"""The per-layer metrics that read the program's own spans and counters
(``program_spans``): each reads a value in a tiny traced run of its
cell, none where the program has no tracing module, and the device's
idle gaps are named by the program's spans open there."""
from __future__ import annotations

import sys
import time
import types

import pytest
import torch
from torch.autograd import DeviceType

import tiny
from benchmark import harness, program_spans, run, trace

NEW = {"mgkn85_predict": ["split_ms.serve", "window_ms.serve",
                          "readbacks.serve", "h2d_mb.serve"],
       "mgkn85_train": ["forward_ms.mgkn_train", "backward_ms.mgkn_train",
                        "optimizer_ms.mgkn_train", "mid_conv_ms.mgkn_train",
                        "transfer_ms.mgkn_train"]}


def _traced(name: str, monkeypatch) -> tuple:
    """A tiny traced run of ``name``: its result and the benchmark's
    spans (start ns, end ns, name) of the window."""
    seen = {}
    read = trace.read

    def keep(prof, window_s, spans):
        seen["spans"] = list(spans)
        return read(prof, window_s, spans)

    monkeypatch.setattr(trace, "read", keep)
    cell = tiny.cell(name, limits={})
    out = run.run_cell(cell, 2147483791, 0.3, True, torch.device("cpu"),
                       t_start=time.perf_counter(), log=lambda m: None)
    return out, seen["spans"]


@pytest.mark.parametrize("name", sorted(NEW))
def test_new_metrics_read_in_a_tiny_traced_run(name, monkeypatch):
    out, _ = _traced(name, monkeypatch)
    for metric in NEW[name]:
        assert out["metrics"][metric]["value"] is not None, metric
    assert {m["name"] for m in harness.find_cell(name).per_layer} >= set(
        NEW[name])


def test_gaps_named_by_program_spans(monkeypatch):
    _, bench = _traced("mgkn85_predict", monkeypatch)
    from graph_pde_tpu_torch.utils import tracing

    rec = tracing.profiled()
    mids = [(t0 + t1) // 2 for n, _, t0, t1 in rec.spans
            if n in ("split.connect", "window.readback", "predict.encode")]
    last = max(t1 for _, _, _, t1 in rec.spans)
    names = program_spans.gap_names(bench, rec, mids + [last + 10 ** 9])
    assert set(names[:-1]) == {"request/split/split.connect",
                               "request/window/window.readback",
                               "request/predict.encode"}
    assert names[-1] == "between calls"

    # the gaps between device operations, named at their middles
    w0, w1, _ = bench[0]
    ops = [(w0, 10), ((w0 + w1) // 2, 10), (w1 - 10, 10)]

    class Event:
        def __init__(self, start, dur):
            self.start, self.dur = start, dur

        def device_type(self):
            return DeviceType.CUDA

        def start_ns(self):
            return self.start

        def duration_ns(self):
            return self.dur

    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(
            events=lambda: [Event(*o) for o in ops])))
    gaps = program_spans.named_gaps(prof, bench, rec)
    assert len(gaps) == 2 and gaps[0][1] >= gaps[1][1] > 0
    assert all(g[0].startswith("request/") for g in gaps)


def test_without_the_programs_tracing_nothing_is_read(monkeypatch):
    import graph_pde_tpu_torch.utils as utils

    monkeypatch.delattr(utils, "tracing")
    monkeypatch.setitem(sys.modules, "graph_pde_tpu_torch.utils.tracing",
                        None)
    ctx = harness.Context(trace=trace.Trace({}, 0.0, 1.0, []), window_s=1.0,
                          work=3, spans={}, flops=None, shapes={},
                          counters={})
    for metric in NEW["mgkn85_predict"] + NEW["mgkn85_train"]:
        assert harness.metric_reader(metric)(ctx) is None
