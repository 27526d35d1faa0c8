"""The orthogonal MGKN's timed path (the benchmark's system module over
the port's Burgers data, model, task and trainer) against the
benchmark's plain reference (benchmark/reference/mgkn_orthogonal.py),
and the model's spans and counter (utils/tracing.py).

Toy sizes: s=32 (four levels, five edge lists), width 16, ker_width 64,
depth 2, two batches of 3 seeded Burgers inputs, fp32 kcached, on the
CPU; a few seconds, no JAX. Tolerances are stated where they are
used."""
import numpy as np
import pytest
import torch

from benchmark import burgers, fields, weights
from benchmark.reference import common
from benchmark.reference import mgkn_orthogonal as ref
from benchmark.systems import mgkn_orthogonal as system
from graph_pde_tpu_torch.graph.multipole import (get_edge_attr,
                                                 multi_pole_grid1d)
from graph_pde_tpu_torch.models import mgkn_orthogonal as mo
from graph_pde_tpu_torch.train import adam_steplr, make_train_step
from graph_pde_tpu_torch.train.trainer import make_loss_fn, param_leaves
from graph_pde_tpu_torch.utils import tracing

CPU = torch.device("cpu")
CFG = {"source_res": 256, "downsample": 8, "s": 32, "periodic": True,
       "width": 16, "ker_width": 64, "depth": 2, "ker_in": 4,
       "in_width": 2, "out_width": 1, "impl": "kcached",
       "compute_dtype": None, "loss": "rel2", "learning_rate": 1e-3,
       "weight_decay": 5e-4, "scheduler_step": 10, "scheduler_gamma": 0.8}
TRAFFIC = {"samples": 6, "batch_size": 3}
SEED = 2 ** 31 + 18


@pytest.fixture(scope="module")
def setup():
    s_fields, s_weights = fields.seeds(SEED, 2)
    f = burgers.burgers_fields(np.random.default_rng(s_fields),
                               TRAFFIC["samples"], CFG["source_res"])
    data = system.Training(CFG, f, TRAFFIC, CPU)
    w = {k: v.cpu() for k, v in weights.draw(system.weight_specs(CFG),
                                              s_weights, CPU).items()}
    return f, data, w


def _leaves(w):
    leaves = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    return leaves, system.program_tree(CFG, leaves)


@pytest.mark.parametrize("s", [16, 32])
@pytest.mark.parametrize("periodic", [True, False])
def test_edge_lists_and_attrs_match_multipole(s, periodic):
    n = 2
    theta = np.random.default_rng(s).normal(size=(n, s)).astype(np.float32)
    grids, thetas, edges = multi_pole_grid1d(theta[:, :, None], 1, s, n,
                                             is_periodic=periodic)
    mine = ref.edge_lists(s, periodic)
    assert len(mine) == len(edges) == ref.levels(s) + 1
    for e, m in zip(edges, mine):
        np.testing.assert_array_equal(m, e)
    attrs = ref.edge_attrs(theta, s, mine)
    for idx, (e, a) in enumerate(zip(edges, attrs)):
        li = ref.list_level(idx)
        want = np.stack([get_edge_attr(grids[li], thetas[li][j, :, 0], e)
                         for j in range(n)])
        # both take float32 grids and inputs; the reference's float64
        # stack rounds back to the same float32 values
        np.testing.assert_array_equal(a.astype(np.float32), want)


def test_forward_loss_and_gradients_match_the_reference(setup):
    f, data, w = setup
    batch = data.batches[0]
    prob = ref.Problem(CFG, f, CPU)
    leaves, tree = _leaves(w)
    got = mo.mgkn_orthogonal_apply_batched(tree, system.model_config(CFG),
                                           batch)[..., 0]
    p = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    want = ref.forward(p, CFG, prob.x[:3], prob.edges,
                       [a[:3] for a in prob.attrs], common.exact)
    # float32 through two V-cycles whose sums (means, GEMMs) run in
    # other orders: 1e-5 of the output's largest magnitude
    scale = float(want.detach().abs().max())
    assert float((got - want).detach().abs().max()) <= 1e-5 * scale
    loss, _ = make_loss_fn(data.task, "rel2")(tree, batch)
    loss.backward()
    ref_loss = prob.loss(p, [0, 1, 2], common.exact)
    ref_loss.backward()
    # the decoded rel-L2 of the same predictions: the normalizers'
    # float32 fit against the reference's float64 one, 1e-6 relative
    a, b = loss.item(), ref_loss.item()
    assert abs(a - b) <= 1e-6 * b
    for k in w:
        g, r = leaves[k].grad, p[k].grad
        # each leaf's gradient within 1e-4 of its norm: float32 sums of
        # up to B * E = 6,000 edge terms in another order, amplified by
        # the backward through two V-cycles (the readings sit at 1e-6)
        assert float((g - r).norm()) <= 1e-4 * float(r.norm()) + 1e-9, k


def test_adam_step_matches_the_reference(setup):
    f, data, w = setup
    leaves, tree = _leaves(w)
    opt, _ = adam_steplr(param_leaves(tree), CFG["learning_rate"],
                         weight_decay=CFG["weight_decay"])
    make_train_step(data.task, opt)(tree, data.batches[1])
    out = ref.train_steps(CFG, w, f, [[3, 4, 5]], CPU)
    lr = CFG["learning_rate"]
    for k in w:
        moved, want = leaves[k].detach() - w[k], out["params"][k] - w[k]
        # Adam's first step is lr * g / (|g| + eps) elementwise (eps
        # 1e-8), at most lr anywhere; where the reference's gradient
        # exceeds 100 eps the step takes the gradient's 1e-6 relative
        # error times eps / |g| <= 1e-2: within 1e-4 of lr
        big = out["grad1"][k].abs() > 1e-6
        assert float((moved - want)[big].abs().max()) <= 1e-4 * lr, k
        assert float(moved.abs().max()) <= lr * (1 + 1e-5), k


def test_spans_and_counter_in_a_recording(setup):
    _, data, w = setup
    _, tree = _leaves(w)
    with tracing.recording() as rec:
        mo.mgkn_orthogonal_apply_batched(tree, system.model_config(CFG),
                                         data.batches[0])
    names = [s[0] for s in rec.spans]
    # four levels, depth 2: two fine and three coarse convs, three pools
    # and three upsamplings a V-cycle
    assert {n: names.count(n) for n in set(names)} == {
        "kbuild": 1, "conv.fine": 4, "conv.coarse": 6, "pool": 6,
        "upsample": 6}
    assert all(t1 is not None and t1 >= t0 for _, _, t0, t1 in rec.spans)
    edges = sum(int(se.shape[1]) for se in data.batches[0].senders)
    # every conv's contraction on the CPU takes the plain path
    assert rec.counters == {"k_bytes": edges * 3 * CFG["width"] ** 2 * 4,
                            "contract_plain": 10}


def test_nothing_recorded_when_off(setup, monkeypatch):
    _, data, w = setup
    _, tree = _leaves(w)
    made = []

    class Seen(tracing._Span):
        def __init__(self, rec, name):
            made.append(name)
            super().__init__(rec, name)

    monkeypatch.setattr(tracing, "_Span", Seen)
    before = tracing.profiled()
    mo.mgkn_orthogonal_apply_batched(tree, system.model_config(CFG),
                                     data.batches[0])
    assert made == [] and tracing.profiled() is before
    assert tracing.span("conv.fine") is tracing._OFF
