"""The port's spans and counters (graph_pde_tpu_torch/utils/tracing.py):
nothing recorded while off, outputs bit-equal with recording on and off,
the spans of a general-MGKN request and training step nested where the
work happens, the counters, the recording of a profiler session, and the
operator's exporter; and the general-MGKN request's stacked windows
(inference.py): the group-size rule, and a request equal to a loop of
single-window forwards at any group size. At toy sizes (s=16, points
(24, 12, 6), width 8, depth 2, kcached): a few seconds on the CPU, no
JAX."""
import dataclasses
import time

import numpy as np
import pytest
import torch

from graph_pde_tpu_torch.data import synthetic
from graph_pde_tpu_torch.data.datasets import (darcy_mgkn_graphs,
                                               map_arrays, prepare_darcy)
from graph_pde_tpu_torch.graph import build, native
from graph_pde_tpu_torch.graph.graph import _to_tensor
from graph_pde_tpu_torch import inference
from graph_pde_tpu_torch.graph import RandomMultiMeshSplitter
from graph_pde_tpu_torch.inference import MGKNGeneralPredictor, _np
from graph_pde_tpu_torch.models import mgkn_general as mg
from graph_pde_tpu_torch.train import (MGKNGeneralTask, adam_steplr,
                                       make_train_step, param_leaves,
                                       profile_trace)
from graph_pde_tpu_torch.train.trainer import to_device, trainable
from graph_pde_tpu_torch.utils import tracing

S = 16
R_INNER = (0.25, 0.5, 1.0)
R_INTER = (0.125, 0.25)
CFG = mg.MGKNGeneralConfig(width=8, ker_width=16, depth=2,
                           points=(24, 12, 6), impl="kcached")
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def darcy():
    fields = synthetic.darcy_dataset(3, S, seed=7)
    arrays, norms = prepare_darcy(fields, n=3)
    return fields, arrays, norms


def _predictor(darcy):
    _, arrays, norms = darcy
    params = mg.mgkn_general_init(torch.Generator().manual_seed(4), CFG,
                                  device=CPU)
    return MGKNGeneralPredictor(params, CFG, norms, arrays.u_normalizer,
                                R_INNER, R_INTER, device=CPU)


def _steps(darcy, n: int = 2):
    """``n`` training steps from one init: the losses and the params."""
    _, arrays, _ = darcy
    graphs, _ = darcy_mgkn_graphs(arrays, points=CFG.points,
                                  radius_inner=R_INNER,
                                  radius_inter=R_INTER, k=1, seed=0)
    data = to_device(graphs, CPU)
    params = trainable(mg.mgkn_general_init(
        torch.Generator().manual_seed(3), CFG, device=CPU), CPU)
    opt, _ = adam_steplr(param_leaves(params), 1e-3, weight_decay=1e-4)
    step = make_train_step(MGKNGeneralTask(
        CFG, u_normalizer=arrays.u_normalizer), opt)
    losses = [step(params, map_arrays(lambda a, j=j: a[j:j + 1], data))
              ["loss"] for j in range(n)]
    return losses, param_leaves(params)


def _children(rec, parent):
    return [(i, s[0]) for i, s in enumerate(rec.spans) if s[1] == parent]


def test_off_records_nothing(darcy):
    assert tracing.span("a") is tracing.span("b")
    before = tracing.profiled()
    _predictor(darcy).predict(darcy[0]["coeff"][:1])
    tracing.count("readbacks")
    assert tracing.profiled() is before
    with tracing.recording() as rec:
        pass
    assert rec.spans == [] and rec.counters == {}


def test_predict_bit_equal_and_spans_nest(darcy):
    coeff = darcy[0]["coeff"][:1]
    off = _predictor(darcy).predict(coeff)
    with tracing.recording() as rec:
        on = _predictor(darcy).predict(coeff)
    assert np.array_equal(on, off)
    assert all(t1 is not None and t0 <= t1 for _, _, t0, t1 in rec.spans)
    (root, name), = _children(rec, None)
    assert name == "predict"
    top = [n for _, n in _children(rec, root)]
    windows = -(-S * S // CFG.points[0])
    groups = 1      # on the host every window is in one stacked forward
    assert top == ["predict.encode", "split"] + ["window"] * groups + [
        "assemble"]
    split = next(i for i, n in _children(rec, root) if n == "split")
    assert [n for _, n in _children(rec, split)] == (
        ["split.connect"] * windows + ["split.pad"])
    convs = 7 * CFG.depth
    for i, n in _children(rec, root):
        if n != "window":
            continue
        kids = _children(rec, i)
        assert [k for _, k in kids] == ["window.h2d", "window.forward",
                                        "window.readback"]
        starts = [rec.spans[j][2] for j, _ in kids]
        assert starts == sorted(starts)
        inner = [k for _, k in _children(rec, kids[1][0])]
        assert inner[0] == "kbuild" and len(inner) == 1 + convs
    assert rec.counters["window_forwards"] == groups


def _request(darcy, j: int = 0):
    """Sample j's encoded fields and the predictor's parts, and a fresh
    splitter of the predictor's seed."""
    fields, _, _ = darcy
    pred = _predictor(darcy)
    enc = inference._encode_darcy(
        pred.input_normalizers, fields["coeff"][j:j + 1],
        fields["Kcoeff"][j:j + 1], fields["Kcoeff_x"][j:j + 1],
        fields["Kcoeff_y"][j:j + 1])
    theta = np.stack([enc[k][0] for k in ("a", "a_smooth", "a_gradx",
                                          "a_grady")], axis=1)
    sp = RandomMultiMeshSplitter([[0, 1], [0, 1]], [S, S],
                                 level=len(CFG.points),
                                 sample_sizes=list(CFG.points),
                                 seed=pred.seed)
    return pred, theta, sp


def _stacked(darcy, monkeypatch, size=None):
    """One request through mgkn_split_predict, with ``size`` windows a
    group where given, and its recording. Each forward output the
    predictor reads back (an inference-mode tensor; the normalizer's
    host tensors are not) counts as a readback, as a device tensor does
    on the card."""
    pred, theta, sp = _request(darcy)
    if size is not None:
        monkeypatch.setattr(inference, "window_group_size",
                            lambda caps, cfg, n, free: size)
    host = inference._np

    def read(t):
        if isinstance(t, torch.Tensor) and t.is_inference():
            tracing.count("readbacks")
        return host(t)

    monkeypatch.setattr(inference, "_np", read)
    with tracing.recording() as rec:
        out, caps = inference.mgkn_split_predict(
            pred.params, CFG, sp, R_INNER, R_INTER, theta, None,
            pred.u_normalizer, CPU)
    monkeypatch.undo()
    return out, caps, rec


@pytest.mark.parametrize("size", [1, 7])
def test_stacked_request_equals_window_loop(darcy, monkeypatch, size):
    """A request's stacked forwards give the field of one forward a
    window (same splitter seed, same caps, the same decode and stitch),
    at one group and at forced groups of ``size`` windows; readbacks and
    stacked forwards are one a group."""
    pred, theta, sp = _request(darcy)
    shards, caps = sp.splitter(list(R_INNER), list(R_INTER), theta[:, 0],
                               theta)
    with torch.no_grad():
        rows = [mg.mgkn_general_apply(pred.params, CFG, g.to(CPU))[:, 0]
                .numpy() for g in shards]
    idxs = [np.asarray(g.sample_idx) for g in shards]
    loop = sp.assembler([inference._decode_rows(pred.u_normalizer, r, i)
                         for r, i in zip(rows, idxs)], idxs)
    tol = 1e-6 * np.abs(loop).max()
    one, caps1, rec1 = _stacked(darcy, monkeypatch)
    assert caps1 == caps
    assert np.abs(one - loop).max() <= tol
    assert rec1.counters["readbacks"] == 1 == rec1.counters[
        "window_forwards"]
    out, _, rec = _stacked(darcy, monkeypatch, size)
    groups = -(-len(shards) // size)
    assert groups > 1
    assert np.abs(out - one).max() <= tol
    assert rec.counters["readbacks"] == groups == rec.counters[
        "window_forwards"]
    assert [s[0] for s in rec.spans].count("window") == groups


def test_window_group_size():
    """A window's K bytes from its caps, width and K dtype; groups fit
    half of the free bytes, hold at least one window, and take every
    window on the host or where no K is built."""
    caps = ((512, 256, 256), (256, 256), (256, 256))
    w2 = CFG.width ** 2
    edges = sum(c for part in caps for c in part)
    for k_cfg, size in ((CFG, 4),
                        (dataclasses.replace(CFG, compute_dtype="bfloat16"),
                         2),
                        (dataclasses.replace(CFG, k_storage="float8_e4m3"),
                         1)):
        assert inference.window_k_bytes(caps, k_cfg) == edges * w2 * size
    assert inference.window_k_bytes(
        caps, dataclasses.replace(CFG, impl="reference")) == 512 * w2 * 4
    for impl in ("auto", "pallas", "scan"):
        assert inference.window_k_bytes(
            caps, dataclasses.replace(CFG, impl=impl)) == 0
    k = edges * w2 * 4
    assert inference.window_group_size(caps, CFG, 19, 2 * 5 * k) == 5
    assert inference.window_group_size(caps, CFG, 19, 2 * 5 * k - 1) == 4
    assert inference.window_group_size(caps, CFG, 19, 10 ** 15) == 19
    assert inference.window_group_size(caps, CFG, 19, 0) == 1
    assert inference.window_group_size(caps, CFG, 19, None) == 19
    assert inference.window_group_size(
        caps, dataclasses.replace(CFG, impl="auto"), 19, 0) == 19


def test_train_step_bit_equal_and_spans_nest(darcy):
    losses_off, params_off = _steps(darcy)
    with tracing.recording() as rec:
        losses_on, params_on = _steps(darcy)
    assert all(torch.equal(a, b) for a, b in zip(losses_on, losses_off))
    assert all(torch.equal(a, b) for a, b in zip(params_on, params_off))
    steps = _children(rec, None)
    assert [n for _, n in steps] == ["train_step"] * 2
    for i, _ in steps:
        kids = _children(rec, i)
        assert [k for _, k in kids] == ["forward", "backward", "optimizer"]
        fwd = [k for _, k in _children(rec, kids[0][0])]
        assert fwd[0] == "kbuild"
        assert sorted(fwd[1:]) == sorted(
            ["conv.down"] * 2 * CFG.depth + ["conv.mid"] * 3 * CFG.depth
            + ["conv.up"] * 2 * CFG.depth)


def test_counters(darcy, monkeypatch):
    pts = np.random.default_rng(0).random((50, 2))
    with tracing.recording() as rec:
        ei = build.radius_connectivity(pts, 0.2)

        def no_toolchain(*a, **k):
            raise RuntimeError("no compiler")

        monkeypatch.setattr(native, "native_radius", no_toolchain)
        ei2 = build.radius_connectivity(pts, 0.2)
    c = rec.counters
    assert c.get("radius_native", 0) + c["radius_tree"] == 2
    assert c["radius_tree"] >= 1
    assert c["radius_edges"] == ei.shape[1] + ei2.shape[1]

    meta = torch.device("meta")
    x = np.zeros((10, 3), np.float64)
    with tracing.recording() as rec:
        _to_tensor(x, meta)                       # 120 bytes as float32
        _to_tensor(torch.zeros(4, dtype=torch.int64), meta)
        _to_tensor(x, CPU)                        # stays on the host
        to_device({"a": np.zeros(5, np.float32)}, meta)
        to_device({"a": np.zeros(5, np.float32)}, CPU)
        _np(torch.ones(3))                        # a host tensor
    assert rec.counters == {"h2d_copies": 3, "h2d_bytes": 120 + 32 + 20}


def test_profiler_session_records(darcy):
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts):
        with tracing.span("a"):
            tracing.count("n", 2)
    rec = tracing.profiled()
    assert [s[0] for s in rec.spans] == ["a"] and rec.counters == {"n": 2}
    with tracing.span("after"):       # the profiler stopped: not recorded
        pass
    assert tracing.profiled() is rec and len(rec.spans) == 1
    with torch.profiler.profile(activities=acts):
        tracing.count("n")
    assert tracing.profiled() is not rec
    assert tracing.profiled().counters == {"n": 1}


def test_recordings_do_not_nest():
    with tracing.recording():
        with pytest.raises(RuntimeError, match="already open"):
            with tracing.recording():
                pass


def test_profile_trace_shows_the_spans(darcy, tmp_path):
    pred = _predictor(darcy)
    with profile_trace(str(tmp_path)) as prof:
        pred.predict(darcy[0]["coeff"][:1])
    keys = {e.key for e in prof.key_averages()}
    assert {"predict", "split", "window.forward", "conv.mid"} <= keys
    assert (tmp_path / "trace.json").exists()


def test_off_cost_printed():
    n = 100_000

    def loop():
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with tracing.span("conv.mid"):
                pass
        return (time.perf_counter_ns() - t0) / n

    off = min(loop() for _ in range(3))
    with tracing.recording():
        on = loop()
    print(f"span off {off:.0f} ns, on {on:.0f} ns a span (this host)")
