"""Port parity, the orthogonal MGKN: model, gradients, train step,
predictor, bundle and runner of graph_pde_tpu_torch against
graph_pde_tpu, on the CPU (the port's kernel wrappers take their plain
versions; JAX's impl='pallas' runs the Pallas kernels in interpret
mode).

Small shapes (as the JAX package's own tests): s=16 (three levels, four
edge lists), width 8, ker_width 32, depth 2, on synthetic Burgers data.
Parameters are JAX's, carried over as numpy. Tolerances are stated
where they are used."""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_pde_tpu import inference as jinf
from graph_pde_tpu.data import datasets as jdata
from graph_pde_tpu.experiments import registry as jreg
from graph_pde_tpu.experiments import runners as jrun
from graph_pde_tpu.models import mgkn_orthogonal as jmo
from graph_pde_tpu.train import export as jexport
from graph_pde_tpu.train import optim as joptim
from graph_pde_tpu.train import tasks as jtasks
from graph_pde_tpu.train import trainer as jtrainer

from graph_pde_tpu_torch.convert import mgkn_orthogonal_params_from_numpy
from graph_pde_tpu_torch.data import datasets as tdata
from graph_pde_tpu_torch.data import synthetic as tsyn
from graph_pde_tpu_torch.experiments import registry as treg
from graph_pde_tpu_torch.experiments import runners as trun
from graph_pde_tpu_torch.inference import MGKNOrthogonalPredictor
from graph_pde_tpu_torch.models import mgkn_orthogonal as tmo
from graph_pde_tpu_torch.ops.fused_edge_conv import fused_edge_messages
from graph_pde_tpu_torch.train import (MGKNOrthogonalTask, adam_steplr,
                                       load_bundle, load_meta,
                                       make_train_step, param_leaves,
                                       save_bundle, trainable)

S = 16
BASE = dict(width=8, ker_width=32, depth=2, s=S)
# float32 through the V-cycle's sums in other orders: 1e-4 of the
# output's max-abs, and 1e-5 absolute plus 1e-4 relative elementwise
MODEL_TOL = 1e-4
HIST_RTOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def own_data_cache(tmp_path_factory):
    """Both packages cache synthetic data under ./.data_cache; this
    module generates its own in a directory of its own."""
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(tmp_path_factory.mktemp("cwd"))
        yield


def _close(got, want, tol=MODEL_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"max-abs error {err:.3g} > {tol:g} of max-abs"
    if tol <= MODEL_TOL:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def arrays():
    fields = tsyn.burgers_dataset(3, S, seed=5, gen_res=256)
    ta = tdata.prepare_burgers(fields, n=3)
    ja = jdata.prepare_burgers(fields, n=3)
    ja.a, ja.u = ta.a, ta.u   # the same encoded arrays on both sides
    return ta, ja


def _graphs(arrays):
    ta, ja = arrays
    tg = tmo.multipole_batch(*tdata.burgers_multipole_data(ta)).to("cpu")
    xs, ys, se, re, at = jdata.burgers_multipole_data(ja)
    n = xs.shape[0]
    jg = jmo.MultipoleGraph1D(
        x=jnp.asarray(xs),
        senders=[jnp.asarray(np.broadcast_to(v, (n,) + v.shape)) for v in se],
        receivers=[jnp.asarray(np.broadcast_to(v, (n,) + v.shape))
                   for v in re],
        attrs=[jnp.asarray(a) for a in at], y=jnp.asarray(ys))
    return tg, jg


def _cfgs(**kw):
    base = dict(BASE, **kw)
    return jmo.MGKNOrthogonalConfig(**base), tmo.MGKNOrthogonalConfig(**base)


def _params(jcfg, seed=0):
    jp = jmo.mgkn_orthogonal_init(jax.random.PRNGKey(seed), jcfg)
    return jp, mgkn_orthogonal_params_from_numpy(
        jax.tree.map(np.asarray, jp), "cpu")


def _jleaves(tree):
    return jax.tree_util.tree_leaves(jax.tree.map(np.asarray, tree))


def test_config_and_init_match_jax():
    jcfg, tcfg = _cfgs()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert dataclasses.asdict(jmo.MGKNOrthogonalConfig()) == \
        dataclasses.asdict(tmo.MGKNOrthogonalConfig())
    assert tcfg.level == jcfg.level == 3
    jp = jmo.mgkn_orthogonal_init(jax.random.PRNGKey(0), jcfg)
    tp = tmo.mgkn_orthogonal_init(torch.Generator().manual_seed(0), tcfg,
                                  device="cpu")
    assert len(tp["conv"]) == len(jp["conv"]) == 4
    tshapes = jax.tree.map(lambda t: tuple(t.shape), tp)
    jshapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    assert jax.tree_util.tree_structure(tshapes) == \
        jax.tree_util.tree_structure(jshapes)
    assert jax.tree_util.tree_leaves(tshapes) == \
        jax.tree_util.tree_leaves(jshapes)
    assert [p["kernel"][0]["w"].shape[1] for p in tp["conv"]] == \
        [32, 16, 16, 16]
    # fc1 is torch.nn.Linear's U(+-1/sqrt(in)); root U(+-1/sqrt(width))
    assert float(tp["fc1"]["w"].abs().max()) <= 1 / np.sqrt(2)
    assert float(tp["conv"][0]["root"].abs().max()) <= 1 / np.sqrt(8)


def test_init_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmo.mgkn_orthogonal_init(torch.Generator(), _cfgs()[1])


@pytest.mark.parametrize("impl", ["reference", "kcached", "pallas", "auto"])
def test_apply_matches_jax(arrays, impl):
    """Batched and single-sample forwards on impl='reference',
    'kcached' (float32 K), 'pallas' (JAX: the Pallas kernels in
    interpret mode; the port: K1's plain version) and 'auto'."""
    jcfg, tcfg = _cfgs(impl=impl)
    jp, tp = _params(jcfg)
    tg, jg = _graphs(arrays)
    before = fused_edge_messages.launches
    got = tmo.mgkn_orthogonal_apply_batched(tp, tcfg, tg)
    want = jax.jit(lambda q, g: jmo.mgkn_orthogonal_apply_batched(
        q, jcfg, g))(jp, jg)
    assert got.shape == (3, S, 1)
    _close(got.detach().numpy(), want)
    one = tmo.mgkn_orthogonal_apply(
        tp, tcfg, tmo.MultipoleGraph1D(
            x=tg.x[1], senders=[v[1] for v in tg.senders],
            receivers=[v[1] for v in tg.receivers],
            attrs=[v[1] for v in tg.attrs]))
    _close(one.detach().numpy(), np.asarray(want)[1])
    assert fused_edge_messages.launches == before   # CPU: plain versions


@pytest.mark.parametrize("k_storage", ["float8_e4m3", "float8_e5m2"])
@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_kcached_fp8_and_bf16_match_jax(arrays, k_storage, dtype):
    """fp8 storage of each level's cached K (and bf16 kappa and K): the
    same fp8 roundings on both sides, float32 sums in other orders; 5e-3
    of the max-abs, as the GKN fp8 tests (an fp8 ulp flip where a K
    value lands on a rounding boundary)."""
    jcfg, tcfg = _cfgs(impl="kcached", k_storage=k_storage,
                       compute_dtype=dtype)
    jp, tp = _params(jcfg, seed=1)
    tg, jg = _graphs(arrays)
    got = tmo.mgkn_orthogonal_apply_batched(tp, tcfg, tg)
    want = jax.jit(lambda q, g: jmo.mgkn_orthogonal_apply_batched(
        q, jcfg, g))(jp, jg)
    _close(got.detach().numpy(), want, 5e-3)


@pytest.mark.parametrize("impl", ["reference", "kcached", "pallas"])
def test_grads_match_jax(arrays, impl):
    """Gradients of sum(out^2) in every parameter leaf: 1e-4 of each
    leaf's max-abs (the port's B1-bwd plain version against JAX's
    Pallas custom_vjp in interpret mode for 'pallas')."""
    jcfg, tcfg = _cfgs(impl=impl)
    jp, tp = _params(jcfg, seed=2)
    tg, jg = _graphs(arrays)
    p = trainable(tp, "cpu")
    (tmo.mgkn_orthogonal_apply_batched(p, tcfg, tg) ** 2).sum().backward()
    jgr = jax.jit(jax.grad(lambda q: jnp.sum(
        jmo.mgkn_orthogonal_apply_batched(q, jcfg, jg) ** 2)))(jp)
    want = _jleaves(jgr)
    got = [t.grad for t in param_leaves(p)]
    assert len(got) == len(want) == 2 + 4 * 8 + 4
    for a, b in zip(got, want):
        _close(a.numpy(), b)


def test_train_steps_match_jax(arrays):
    """Two Adam steps (one sample each) under the decoded rel-L2 loss
    from the same parameters: losses within 1e-5 relative, parameters
    within 1e-4 of each leaf's max-abs (tests/test_torch_train.py says
    why Adam keeps that bound)."""
    ta, ja = arrays
    jcfg, tcfg = _cfgs(impl="kcached")
    jp, tp = _params(jcfg, seed=3)
    tg, jg = _graphs(arrays)
    jtask = jtasks.MGKNOrthogonalTask(jcfg, u_normalizer=ja.u_normalizer)
    ttask = MGKNOrthogonalTask(tcfg, u_normalizer=ta.u_normalizer)
    jtx = joptim.adam_steplr(1e-3, weight_decay=5e-4, steps_per_epoch=2,
                             step_size_epochs=50, gamma=0.5)
    jstep = jtrainer.make_train_step(jtask, jtx)
    jstate = jtx.init(jp)
    params = trainable(tp, "cpu")
    opt, _ = adam_steplr(param_leaves(params), 1e-3, weight_decay=5e-4)
    tstep = make_train_step(ttask, opt)
    for j in range(2):
        jb = jax.tree_util.tree_map(lambda a: a[j:j + 1], jg)
        tb = tdata.map_arrays(lambda a: a[j:j + 1], tg)
        jp, jstate, jm = jstep(jp, jstate, jb)
        tm = tstep(params, tb)
        for k in ("loss", "l2_sum", "mse"):
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-5), k
    for a, b in zip(param_leaves(params), _jleaves(jp)):
        _close(a.detach().numpy(), b)


def _predictors(arrays, impl="kcached"):
    ta, ja = arrays
    jcfg, tcfg = _cfgs(impl=impl)
    jp, tp = _params(jcfg, seed=4)
    return (jinf.MGKNOrthogonalPredictor(jp, jcfg, ja.a_normalizer,
                                         ja.u_normalizer),
            MGKNOrthogonalPredictor(tp, tcfg, ta.a_normalizer,
                                    ta.u_normalizer, device="cpu"))


def test_predictor_matches_jax(arrays):
    jpred, tpred = _predictors(arrays)
    a = tsyn.burgers_dataset(2, S, seed=9, gen_res=256)["a"]
    got, want = tpred.predict(a), np.asarray(jpred.predict(a))
    assert got.shape == (2, S)
    _close(got, want)
    with pytest.raises(ValueError, match="training resolution s=16"):
        tpred.predict(np.zeros((1, 32), np.float32))


def test_bundle_json_matches_jax(arrays, tmp_path):
    ta, ja = arrays
    jcfg, tcfg = _cfgs(compute_dtype="bfloat16", k_storage="float8_e4m3")
    jp, tp = _params(jcfg)
    extra = {"family": "mgkn_orthogonal", "experiment": "x",
             "dataset": "burgers", "train_s": S}
    jexport.save_bundle(str(tmp_path / "j"), jp, jcfg,
                        normalizers={"a": ja.a_normalizer,
                                     "u": ja.u_normalizer}, extra=extra)
    save_bundle(str(tmp_path / "t"), tp, tcfg,
                normalizers={"a": ta.a_normalizer, "u": ta.u_normalizer},
                extra=extra)
    metas = [json.load(open(tmp_path / d / "bundle.json"))
             for d in ("j", "t")]
    assert metas[0]["model_config_class"] == metas[1]["model_config_class"] \
        == "MGKNOrthogonalConfig"
    assert metas[0]["model_config"] == metas[1]["model_config"]
    assert metas[0]["extra"] == metas[1]["extra"] == extra
    for k in ("a", "u"):
        jn, tn = metas[0]["normalizers"][k], metas[1]["normalizers"][k]
        assert jn["kind"] == tn["kind"]
        np.testing.assert_allclose(tn["mean"], jn["mean"], rtol=1e-5)
        np.testing.assert_allclose(tn["std"], jn["std"], rtol=1e-5)
    cfg, _, ex = load_meta(str(tmp_path / "j"))
    assert cfg == tcfg and ex == extra
    params, cfg2, _, _ = load_bundle(str(tmp_path / "t"))
    assert cfg2 == tcfg and isinstance(params["conv"], list)
    for a, b in zip(param_leaves(params), param_leaves(tp)):
        assert torch.equal(a, b)


def test_smoke_run_matches_jax(monkeypatch):
    """mgkn_orthogonal_burgers1d at smoke size on each side from JAX's
    initial parameters: train/test histories within 1e-4 relative (the
    port's Adam, StepLR and shuffle follow JAX's; float32 sums in
    another order drift over the steps), the same bundle payload."""
    cfg = treg.get("mgkn_orthogonal_burgers1d")
    jcfg = jreg.get("mgkn_orthogonal_burgers1d")
    seen = {}

    def init(gen, c, device=None):
        jm = jmo.MGKNOrthogonalConfig(**dataclasses.asdict(c))
        seen["cfg"] = jm
        return _params(jm, seed=cfg.seed)[1]

    monkeypatch.setattr(trun, "mgkn_orthogonal_init", init)
    got = trun.run_experiment(cfg, smoke=True, device="cpu")
    want = jrun.run_experiment(jcfg, smoke=True)
    assert seen["cfg"].s == 64 and seen["cfg"].impl == "kcached"
    for key in ("train_l2", "test_l2"):
        assert len(got[key]) == len(want[key]) == 2
        np.testing.assert_allclose(got[key], want[key], rtol=HIST_RTOL,
                                   atol=0, err_msg=key)
    assert got["test_epochs"] == want["test_epochs"]
    assert got["_bundle"]["extra"] == want["_bundle"]["extra"]
    assert dataclasses.asdict(got["_bundle"]["model_cfg"]) == \
        dataclasses.asdict(want["_bundle"]["model_cfg"])
    assert os.path.isdir(".data_cache")
