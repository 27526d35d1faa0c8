"""Port parity, training slice: losses, Darcy datasets, the optimizer,
train steps, fit and checkpoints of graph_pde_tpu_torch against
graph_pde_tpu, on the CPU (the port's kernel wrappers take their plain
versions; the JAX Pallas kernels run in interpret mode).

Tolerances are stated where they are used."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_pde_tpu.data import datasets as jdata
from graph_pde_tpu.models import gkn as jgkn
from graph_pde_tpu.train import optim as joptim
from graph_pde_tpu.train import tasks as jtasks
from graph_pde_tpu.train import trainer as jtrainer
from graph_pde_tpu.utils import losses as jlosses

from graph_pde_tpu_torch.convert import gkn_params_from_numpy
from graph_pde_tpu_torch.data import darcy_dataset
from graph_pde_tpu_torch.data import datasets as tdata
from graph_pde_tpu_torch.models import gkn as tgkn
from graph_pde_tpu_torch.train import (GKNTask, MetricsLogger, TrainConfig,
                                       adam_steplr, evaluate, fit,
                                       latest_step, make_train_step,
                                       param_leaves, restore_checkpoint,
                                       save_checkpoint, step_lr,
                                       trainable)
from graph_pde_tpu_torch.utils import losses as tlosses


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def fields():
    # 4 synthetic Darcy samples on an 11 x 11 grid
    return darcy_dataset(4, 11, seed=0)


# ---------------------------------------------------------------- losses

@pytest.mark.parametrize("p,size_average", [(2, False), (2, True),
                                            (1, True)])
def test_lp_loss_matches(p, size_average):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 40)).astype(np.float32)
    y = rng.normal(size=(3, 40)).astype(np.float32)
    m = (rng.uniform(size=(3, 40)) > 0.2).astype(np.float32)
    jl = jlosses.LpLoss(p=p, size_average=size_average)
    tl = tlosses.LpLoss(p=p, size_average=size_average)
    tx, ty = torch.as_tensor(x), torch.as_tensor(y)
    for name in ("abs", "rel"):
        assert _rel(getattr(tl, name)(tx, ty).numpy(),
                    getattr(jl, name)(x, y)) <= 1e-6, name
    assert _rel(tl.rel_masked(tx, ty, torch.as_tensor(m)).numpy(),
                jl.rel_masked(x, y, m)) <= 1e-6
    assert _rel(tl(tx, ty).numpy(), jl(x, y)) <= 1e-6
    nored = tlosses.LpLoss(p=p, reduction=False).rel(tx, ty)
    assert nored.shape == (3,)
    tm = torch.as_tensor(m)
    assert _rel(tlosses.l1_loss(tx, ty, tm).numpy(),
                jlosses.l1_loss(x, y, m)) <= 1e-6
    assert _rel(tlosses.mse_loss(tx, ty, tm).numpy(),
                jlosses.mse_loss(x, y, m)) <= 1e-6
    assert _rel(tlosses.mse_loss(tx, ty).numpy(),
                jlosses.mse_loss(x, y)) <= 1e-6


# -------------------------------------------------------------- datasets

def _graph_fields_equal(tg, jg):
    for f in ("x", "senders", "receivers", "edge_attr", "n_node", "n_edge",
              "y", "sample_idx", "edge_valid"):
        a, b = getattr(tg, f), getattr(jg, f)
        assert (a is None) == (b is None), f
        if a is not None:
            # float fields: the normalizers' float32 statistics are
            # reduced in different orders, so 1e-5 of the max-abs
            assert _rel(a, b) <= 1e-5 if np.asarray(a).dtype.kind == "f" \
                else np.array_equal(np.asarray(a), np.asarray(b)), f
    assert (tg.node_block, tg.sorted_span) == (jg.node_block, jg.sorted_span)


@pytest.mark.parametrize("kw", [dict(radius=0.2),
                                dict(m=40, k=2, radius=0.3, seed=3),
                                dict(radius=0.2, node_block=32)])
def test_darcy_gkn_graphs_match(fields, kw):
    for u_norm in ("unit", "gaussian"):
        ja, jn = jdata.prepare_darcy(fields, n=3, r=1, u_norm=u_norm)
        ta, tn = tdata.prepare_darcy(fields, n=3, r=1, u_norm=u_norm)
        for f in ("a", "a_smooth", "a_gradx", "a_grady", "u"):
            assert _rel(getattr(ta, f), getattr(ja, f)) <= 1e-5, f
        assert ta.s == ja.s == 11
    # a test set encoded with the training normalizers
    jt, _ = jdata.prepare_darcy(fields, n=4, normalizers=jn,
                                u_normalizer=ja.u_normalizer)
    tt, _ = tdata.prepare_darcy(fields, n=4, normalizers=tn,
                                u_normalizer=ta.u_normalizer)
    assert _rel(tt.a, jt.a) <= 1e-5 and _rel(tt.u, jt.u) == 0.0
    _graph_fields_equal(tdata.darcy_gkn_graphs(ta, **kw),
                        jdata.darcy_gkn_graphs(ja, **kw))


def test_load_or_generate_darcy_caches(tmp_path):
    a = tdata.load_or_generate_darcy(2, 9, seed=1, cache_dir=str(tmp_path))
    assert (tmp_path / "darcy_n2_s9_seed1.npz").exists()
    b = tdata.load_or_generate_darcy(2, 9, seed=1, cache_dir=str(tmp_path))
    c = jdata.load_or_generate_darcy(2, 9, seed=1, cache_dir=str(tmp_path))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_array_equal(a[k], c[k])


def test_batch_iterator_order_matches(fields):
    """The same seed gives the same batches in the same order as the JAX
    package's iterator, host and device graphs alike, remainder too."""
    ja, _ = jdata.prepare_darcy(fields, n=4)
    ta, _ = tdata.prepare_darcy(fields, n=4)
    jg = jdata.darcy_gkn_graphs(ja, radius=0.2)
    tg = tdata.darcy_gkn_graphs(ta, radius=0.2)
    for drop in (True, False):
        want = [np.asarray(b.x) for b in jdata.batch_iterator(
            jg, 3, np.random.default_rng(5), drop_remainder=drop)]
        for graphs in (tg, tg.to("cpu")):
            got = [np.asarray(b.x) for b in tdata.batch_iterator(
                graphs, 3, np.random.default_rng(5), drop_remainder=drop)]
            assert [a.shape for a in got] == [a.shape for a in want]
            for a, b in zip(got, want):
                assert _rel(a, b) <= 1e-5


# ------------------------------------------------------------- optimizer

def test_adam_steplr_matches_optax():
    """Six steps over two epochs (3 steps each, the lr halves after the
    first): the torch Adam + StepLR trajectory equals the JAX optax
    chain's, and the lr equals the JAX schedule at every step; the
    port's step_lr equals JAX's step_lr."""
    rng = np.random.default_rng(1)
    p0 = rng.normal(size=(5, 4)).astype(np.float32)
    grads = rng.normal(size=(6, 5, 4)).astype(np.float32)
    tx = joptim.adam_steplr(1e-2, weight_decay=5e-4, steps_per_epoch=3,
                            step_size_epochs=1, gamma=0.5)
    jp, state = jnp.asarray(p0), None
    state = tx.init(jp)
    tp = torch.tensor(p0, requires_grad=True)
    opt, sched = adam_steplr([tp], 1e-2, weight_decay=5e-4,
                             step_size_epochs=1, gamma=0.5)
    jsch = joptim.step_lr(1e-2, 3, 1, 0.5)
    for t in range(6):
        assert opt.param_groups[0]["lr"] == pytest.approx(float(jsch(t)),
                                                          rel=1e-6)
        upd, state = tx.update(jnp.asarray(grads[t]), state, jp)
        jp = jp + upd
        tp.grad = torch.as_tensor(grads[t])
        opt.step()
        if t % 3 == 2:
            sched.step()
        # Adam's float32 moments: 1e-6 of the parameters' max-abs
        assert _rel(tp.detach().numpy(), jp) <= 1e-6, t
    # the port's step_lr schedule over 3 epochs of 4 steps, a step every
    # 2 epochs
    jsch, tsch = joptim.step_lr(1e-3, 4, 2, 0.5), step_lr(1e-3, 4, 2, 0.5)
    for count in range(12):
        assert tsch(count) == pytest.approx(float(jsch(count)), rel=1e-7)
    assert tsch(11) == 0.5e-3 and tsch(7) == 1e-3



# ----------------------------------------------------------- train steps

def _train_setup(fields, impl, dtype, fused, loss, **extra):
    base = dict(width=8, ker_width=16, depth=2, ker_in=6, in_width=6,
                kernel_layers=(6, 8, 16, 64), relu_last=False, impl=impl,
                compute_dtype=dtype, kcached_fused=fused, **extra)
    jcfg, tcfg = jgkn.GKNConfig(**base), tgkn.GKNConfig(**base)
    ja, _ = jdata.prepare_darcy(fields, n=3)
    ta, _ = tdata.prepare_darcy(fields, n=3)
    jg = jdata.darcy_gkn_graphs(ja, radius=0.15)
    tg = tdata.darcy_gkn_graphs(ta, radius=0.15)
    assert jg.sorted_span > 0 and jg.senders.shape[1] % 512 == 0
    jtask = jtasks.GKNTask(jcfg, u_normalizer=ja.u_normalizer,
                           loss_type=loss)
    ttask = GKNTask(tcfg, u_normalizer=ta.u_normalizer, loss_type=loss)
    jp = jgkn.gkn_init(jax.random.PRNGKey(0), jcfg)
    tp = gkn_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jtask, ttask, jp, tp, jg, tg


# (impl, compute dtype, kcached_fused, loss): the K1 path (fp32, bf16)
# and the K2 path, under the MSE and L1 losses
@pytest.mark.parametrize("impl,dtype,fused,loss", [
    ("pallas", None, "off", "mse"),
    ("pallas", "bfloat16", "off", "l1"),
    ("kcached", None, "on", "l1"),
    ("kcached", None, "on", "mse")])
def test_train_steps_match_jax(fields, impl, dtype, fused, loss):
    """Three train steps (one sample each) from the same parameters.

    Tolerances: float32 losses to 1e-5 relative (sums in other orders).
    After three Adam steps the parameters agree to 1e-4 of each leaf's
    max-abs: Adam divides by the gradient's running RMS, so a gradient
    component at rounding level (~1e-7 of its leaf) can take a full
    lr-sized step of either sign; lr 1e-3 keeps three such steps at
    3e-3 of a leaf whose entries are O(0.1-1), and none occur at these
    sizes. With bf16 compute the losses agree to 1e-3 and the
    parameters to 1e-3 of the max-abs (one bf16 ulp of an operand moves
    a gradient by ~4e-3 of itself, and Adam's normalized step by less)."""
    jtask, ttask, jp, tp, jg, tg = _train_setup(fields, impl, dtype, fused,
                                                loss)
    tc = TrainConfig(learning_rate=1e-3, weight_decay=5e-4, loss=loss)
    jtx = joptim.adam_steplr(tc.learning_rate, weight_decay=tc.weight_decay,
                             steps_per_epoch=3, step_size_epochs=50,
                             gamma=0.5)
    jstep = jtrainer.make_train_step(jtask, jtx)
    jstate = jtx.init(jp)
    params = trainable(tp, "cpu")
    opt, _ = adam_steplr(param_leaves(params), tc.learning_rate,
                         weight_decay=tc.weight_decay)
    tstep = make_train_step(ttask, opt)
    tgd = tg.to("cpu")
    loss_tol = 1e-5 if dtype is None else 1e-3
    for j in range(3):
        jb = jax.tree_util.tree_map(lambda a: jnp.asarray(a)[j:j + 1], jg)
        tb = tdata.map_arrays(lambda a: a[j:j + 1], tgd)
        jp, jstate, jm = jstep(jp, jstate, jb)
        tm = tstep(params, tb)
        assert _rel(tm["loss"].numpy(), jm["loss"]) <= loss_tol, j
        assert _rel(tm["l2_sum"].numpy(), jm["l2_sum"]) <= loss_tol, j
        assert _rel(tm["mse"].numpy(), jm["mse"]) <= loss_tol, j
    p_tol = 1e-4 if dtype is None else 1e-3
    for tl, jl in zip(param_leaves(params),
                      jax.tree_util.tree_leaves(
                          jax.tree.map(np.asarray, jp),
                          is_leaf=lambda x: isinstance(x, np.ndarray))):
        assert _rel(tl.detach().numpy(), jl) <= p_tol


# (kcached_fused, compute dtype): the fused path (k8 through K2 and
# B2-bwd) in bf16, the configuration of the JAX package's fp8 A/B, and
# the unfused one (the straight-through estimator) in float32. The
# unfused path's bf16 products leave some gradient components at
# rounding level, where Adam's first step (+-lr whatever the size) may
# take either sign; its bf16 gradients are held in test_torch_gkn.py.
@pytest.mark.parametrize("fused,dtype", [("on", "bfloat16"), ("off", None)])
def test_train_step_fp8_k_storage_matches_jax(fields, fused, dtype):
    """One train step with k_storage='float8_e4m3'. Tolerances as in
    test_train_steps_match_jax."""
    jtask, ttask, jp, tp, jg, tg = _train_setup(
        fields, "kcached", dtype, fused, "l1", k_storage="float8_e4m3")
    tc = TrainConfig(learning_rate=1e-3, weight_decay=5e-4, loss="l1")
    jtx = joptim.adam_steplr(tc.learning_rate, weight_decay=tc.weight_decay,
                             steps_per_epoch=3, step_size_epochs=50,
                             gamma=0.5)
    jb = jax.tree_util.tree_map(lambda a: jnp.asarray(a)[:1], jg)
    jp, _, jm = jtrainer.make_train_step(jtask, jtx)(jp, jtx.init(jp), jb)
    params = trainable(tp, "cpu")
    opt, _ = adam_steplr(param_leaves(params), tc.learning_rate,
                         weight_decay=tc.weight_decay)
    tm = make_train_step(ttask, opt)(
        params, tdata.map_arrays(lambda a: a[:1], tg.to("cpu")))
    tol = 1e-5 if dtype is None else 1e-3
    for key in ("loss", "l2_sum", "mse"):
        assert _rel(tm[key].numpy(), jm[key]) <= tol, key
    p_tol = 1e-4 if dtype is None else 1e-3
    for tl, jl in zip(param_leaves(params),
                      jax.tree_util.tree_leaves(
                          jax.tree.map(np.asarray, jp),
                          is_leaf=lambda x: isinstance(x, np.ndarray))):
        assert _rel(tl.detach().numpy(), jl) <= p_tol


# ------------------------------------------------------- fit, checkpoint

def _small_fit_setup(fields):
    cfg = tgkn.GKNConfig(width=8, ker_width=16, depth=2, ker_in=6,
                         in_width=6, kernel_layers=(6, 8, 16, 64),
                         relu_last=False, impl="reference")
    ta, _ = tdata.prepare_darcy(fields, n=2)
    g = tdata.darcy_gkn_graphs(ta, radius=0.2)
    task = GKNTask(cfg, u_normalizer=ta.u_normalizer, loss_type="mse")
    params = tgkn.gkn_init(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    return task, params, g


def test_checkpoint_round_trip(tmp_path):
    params = {"a": torch.randn(3, 2), "k": ({"w": torch.randn(2)},)}
    opt_state = {"optimizer": {"state": {0: {"step": torch.tensor(4.0)}},
                               "param_groups": [{"lr": 0.1,
                                                 "params": [0]}]},
                 "scheduler": {"last_epoch": 2}}
    for step in (1, 2, 3, 4):
        save_checkpoint(str(tmp_path), step, params, opt_state)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_2", "step_3", "step_4"]
    assert latest_step(str(tmp_path)) == 4
    r = restore_checkpoint(str(tmp_path))
    assert r["step"] == 4
    assert torch.equal(r["params"]["a"], params["a"])
    assert torch.equal(r["params"]["k"][0]["w"], params["k"][0]["w"])
    assert r["opt_state"]["scheduler"]["last_epoch"] == 2
    assert restore_checkpoint(str(tmp_path), step=2)["step"] == 2
    assert restore_checkpoint(str(tmp_path / "none")) is None


def test_fit_resume_equals_uninterrupted_run(fields, tmp_path):
    """fit with checkpoints, resumed after 2 epochs, ends where an
    uninterrupted 3-epoch run ends (one batch per epoch, so the shuffle
    seed does not enter), and StepLR continues across the resume."""
    task, params, g = _small_fit_setup(fields)
    tc = TrainConfig(epochs=3, batch_size=2, learning_rate=1e-3,
                     scheduler_step=2, scheduler_gamma=0.5, loss="mse")
    full = fit(task, params, g, tc, test_data=g, device="cpu")
    d = str(tmp_path / "ck")
    fit(task, params, g, dataclasses.replace(tc, epochs=2),
        checkpoint_dir=d, checkpoint_every=1, device="cpu")
    assert latest_step(d) == 2
    resumed = fit(task, params, g, tc, test_data=g, checkpoint_dir=d,
                  resume=True, device="cpu")
    assert len(resumed.train_l2) == 1 and resumed.test_epochs == [3]
    for a, b in zip(param_leaves(full.params), param_leaves(resumed.params)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert resumed.opt_state["scheduler"]["last_epoch"] == 3
    assert latest_step(d) == 3
    train, test = full.curves()
    assert train.shape == (3, 2) and test.shape == (3, 2)
    assert full.test_l2[-1] == pytest.approx(
        evaluate(task, full.params, g, batch_size=1, device="cpu"),
        rel=1e-5)
    paths = full.save_curves(str(tmp_path / "curves"))
    assert len(paths) == 2


def test_metrics_logger_matches_jax(tmp_path):
    """The same records give the same JSONL stream (time aside) and the
    same np.savetxt error-curve file as the JAX package's logger."""
    from graph_pde_tpu.train.metrics import MetricsLogger as JLogger

    recs = [(1, {"train_l2": torch.tensor(0.5), "test_l2": None}),
            (2, {"train_l2": torch.tensor(0.25), "test_l2": 0.75})]
    files = {}
    for key, cls in (("torch", MetricsLogger), ("jax", JLogger)):
        log = cls(out_dir=str(tmp_path / key), name="run", echo=False)
        for step, m in recs:
            log.log(step, **m)
        files[key] = (log.save_txt("train_l2"),
                      (tmp_path / key / "run.jsonl").read_text())
        log.close()
    np.testing.assert_array_equal(files["torch"][0], [0.5, 0.25])
    np.testing.assert_array_equal(files["torch"][0], files["jax"][0])
    assert (np.loadtxt(tmp_path / "torch" / "run_train_l2.txt").tolist()
            == [0.5, 0.25])
    streams = [[{k: v for k, v in json.loads(line).items() if k != "time"}
                for line in text.splitlines()]
               for _, text in files.values()]
    assert streams[0] == streams[1] and streams[0][0]["test_l2"] is None


def test_fit_steps_and_needs_a_device(fields):
    """fit calls step_callback after every step, and without a GPU it
    raises unless the CPU is asked for."""
    task, params, g = _small_fit_setup(fields)
    tc = TrainConfig(epochs=2, batch_size=1, learning_rate=1e-3,
                     loss="mse")
    seen = []
    res = fit(task, params, g, tc, device="cpu",
              step_callback=lambda ep, step, m: seen.append(
                  (ep, step, float(m["loss"]))))
    assert [s[:2] for s in seen] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert all(np.isfinite(s[2]) for s in seen)
    assert len(res.epoch_times) == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fit(task, params, g, tc)
