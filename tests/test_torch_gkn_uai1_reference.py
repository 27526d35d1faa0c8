"""The UAI GKN's timed path (the benchmark's system module
``benchmark/systems/gkn_uai1.py`` over the port's Darcy data, model,
task and trainer) against the benchmark's plain reference
(``benchmark/reference/gkn_uai1.py``): the fused kcached path (K2's and
B2-bwd's plain versions on the CPU) and the unfused one; the cached K's
precision gate; and the cell's model configuration against the
runner's.

Toy sizes: s=11 (41 grid lines, every 4th), radius 0.25, width 16,
kappa (6, 32, 32, 256), depth 3, ReLU after every conv, L1 on the
Gaussian-encoded target, 4 seeded samples, fp32, on the CPU; a few
seconds, no JAX. Tolerances are stated where they are used."""
import copy
import dataclasses
import json

import numpy as np
import pytest
import torch

from benchmark import compare, fields, weights
from benchmark.reference import common, darcy
from benchmark.reference import gkn_uai1 as ref
from benchmark.systems import gkn_uai1 as system
from graph_pde_tpu_torch.experiments import registry, runners
from graph_pde_tpu_torch.models import gkn as gkn_model
from graph_pde_tpu_torch.train import (GKNTask, adam_steplr,
                                       make_train_step)
from graph_pde_tpu_torch.train.trainer import make_loss_fn, param_leaves
from graph_pde_tpu_torch.utils import tracing

CPU = torch.device("cpu")
with open("benchmark/configs/gkn_uai1_darcy61.json") as f:
    FULL = json.load(f)
CFG = dict(copy.deepcopy(FULL), source_res=41, radius=0.25, width=16,
           ker_width=32, depth=3, kernel_layers=[6, 32, 32, 256],
           learning_rate=1e-3)
SAMPLES = 4
SEED = 2 ** 31 + 24
PATHS = {"fused": "on", "unfused": "off"}


@pytest.fixture(scope="module")
def setup():
    s_fields, s_weights = fields.seeds(SEED, 2)
    f = fields.darcy_fields(np.random.default_rng(s_fields), SAMPLES,
                            CFG["source_res"])
    data = system.Training(CFG, f, {"samples": SAMPLES, "compared_steps": 0},
                           CPU)
    w = {k: v.cpu() for k, v in weights.draw(system.weight_specs(CFG),
                                              s_weights, CPU).items()}
    return f, data, w


def _task(data, path):
    return GKNTask(dataclasses.replace(data.task.cfg,
                                       kcached_fused=PATHS[path]),
                   u_normalizer=data.task.u_normalizer, loss_type="l1",
                   use_sample_idx=False)


def _leaves(w):
    leaves = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    return leaves, system.program_tree(CFG, leaves)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_loss_and_gradients_match_the_reference(setup, path):
    f, data, w = setup
    leaves, tree = _leaves(w)
    with tracing.recording() as rec:
        loss, _ = make_loss_fn(_task(data, path), "l1")(tree,
                                                        data.batches[1])
    # the fused path runs a plain K2 each depth step, the unfused none
    assert rec.counters.get("iterate_plain", 0) == (
        CFG["depth"] if path == "fused" else 0)
    loss.backward()
    prob = ref.Problem(CFG, f, CPU)
    p = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    ref_loss = ref.loss(p, CFG, prob, prob.sample(1), common.exact)
    ref_loss.backward()
    # an L1 sum over 121 nodes of float32 predictions whose edge sums run
    # in another order: 1e-5 relative
    assert abs(loss.item() - ref_loss.item()) <= 1e-5 * ref_loss.item()
    for k in w:
        g, r = leaves[k].grad, p[k].grad
        # each leaf's gradient within 1e-4 of its norm: float32 sums of
        # ~2,000 edge terms in another order, through three depth steps
        # and back (no node sits near a kink of |.|: the sign is the
        # reference's wherever the readings were taken)
        assert float((g - r).norm()) <= 1e-4 * float(r.norm()) + 1e-9, k


@pytest.mark.parametrize("path", sorted(PATHS))
def test_three_adam_steps_match_the_reference(setup, path):
    f, data, w = setup
    leaves, tree = _leaves(w)
    opt, _ = adam_steplr(param_leaves(tree), CFG["learning_rate"],
                         weight_decay=CFG["weight_decay"])
    step = make_train_step(_task(data, path), opt)
    order = [2, 0, 3]
    losses = [float(step(tree, data.batches[j])["loss"]) for j in order]
    out = ref.train_steps(CFG, w, f, order, CPU)
    prog = {"loss": losses, "grad1": out["grad1"],
            "params": {k: v.detach() for k, v in leaves.items()}}
    gaps = compare.training(prog, out, w)
    # three losses of float32 forwards, the later two after Adam steps
    # whose float32 gradients differ in their last bits: 1e-5 relative
    assert gaps["loss_gap"] <= 1e-5
    # each leaf's change after three steps within 1e-5 of its norm (or of
    # the median leaf's; a state left unchanged reads 1): Adam's
    # elementwise steps lr * m / (sqrt(v) + eps) carry the gradients'
    # float32 round-off, amplified where a gradient is near eps (the
    # readings sit at 2.3e-7)
    assert gaps["change_gap"] <= 1e-5


def test_k_precision_gate():
    cfg = system.model_config(FULL)
    e = 383_488    # the s=61 graph's edge capacity
    with tracing.recording() as rec:
        # a card stores K in the configuration's dtype, whatever its size
        assert gkn_model.cached_k_dtype(cfg, e, torch.device("cuda")) == \
            torch.float32
        assert gkn_model.cached_k_dtype(cfg, 1 << 26, torch.device(
            "cuda")) == torch.float32
        # a bf16 compute dtype asks for a bf16 K: nothing lowered
        bf16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
        assert gkn_model.cached_k_dtype(bf16, 512, CPU) == torch.bfloat16
        assert rec.counters == {}
        # the CPU keeps the JAX package's 2 GiB gate, and counts it
        assert gkn_model.cached_k_dtype(cfg, 512, CPU) == torch.float32
        assert gkn_model.cached_k_dtype(cfg, e, CPU) == torch.bfloat16
        assert rec.counters == {"k_lowered": 1}


def test_lowered_k_forward_is_counted(setup, monkeypatch):
    _, data, w = setup
    _, tree = _leaves(w)
    task = _task(data, "fused")
    e = int(data.batches[0].senders.shape[-1])
    w2 = CFG["width"] ** 2
    for limit, elem, lowered in ((None, 4, 0), (0, 2, 1)):
        if limit is not None:
            monkeypatch.setattr(gkn_model, "_KCACHED_F32_MAX_BYTES", limit)
        with tracing.recording() as rec:
            task.forward(tree, data.batches[0])
        assert rec.counters["k_bytes"] == e * w2 * elem
        assert rec.counters.get("k_lowered", 0) == lowered


def test_k_check_turns_a_lowered_k_into_nan(setup, monkeypatch, capsys):
    """The cell's check passes a float32 K's predictions as they are and
    makes a lowered K's NaN, in its first calls only."""
    _, data, w = setup
    _, tree = _leaves(w)
    task = _task(data, "fused")
    e = int(data.batches[0].senders.shape[-1])
    check = system.KCheck(task.forward, e * CFG["width"] ** 2 * 4, 2)
    plain = task.forward(tree, data.batches[0])
    assert torch.equal(check(tree, data.batches[0]), plain)
    assert capsys.readouterr().err == ""
    monkeypatch.setattr(gkn_model, "_KCACHED_F32_MAX_BYTES", 0)
    assert torch.isnan(check(tree, data.batches[0])).all()
    assert "K is not float32 (k_lowered 1" in capsys.readouterr().err
    # past the compared steps it passes straight through, inside an open
    # recording too
    with tracing.recording() as rec:
        assert torch.isfinite(check(tree, data.batches[0])).all()
    assert rec.counters["k_lowered"] == 1


def test_system_and_runner_build_equal_configs():
    exp = registry.get(FULL["registry"])
    assert system.model_config(FULL) == runners._gkn_config(exp)
    assert runners._gkn_config(exp).kcached_fused == "auto"
    # the configuration file holds the registry entry's numbers
    assert (FULL["downsample"], FULL["radius"], FULL["u_norm"],
            FULL["loss"], FULL["batch_size"], FULL["learning_rate"],
            FULL["weight_decay"], FULL["scheduler_step"],
            FULL["scheduler_gamma"], FULL["node_block"]) == (
        exp.downsample, exp.radius_train, exp.u_norm, exp.loss,
        exp.batch_size, exp.learning_rate, exp.weight_decay,
        exp.scheduler_step, exp.scheduler_gamma, exp.node_block)
    assert (FULL["source_res"] - 1) // FULL["downsample"] + 1 == 61


def test_reference_graph_at_s61_is_the_dense_threshold():
    """At s=61 and r=0.1, pairs lie at distance r exactly; the k-d tree
    the reference builds its graph with keeps the same pairs as the
    dense float64 threshold."""
    coords = darcy.grid(61)
    tree = darcy.radius_edges_tree(coords, 0.1)
    dense = darcy.radius_edges(coords, 0.1)
    assert tree.shape == dense.shape == (2, 383_293)
    key = lambda e: np.sort(e[0] * 3721 + e[1])
    np.testing.assert_array_equal(key(tree), key(dense))
