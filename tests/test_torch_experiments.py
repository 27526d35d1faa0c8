"""Port parity: the experiment registry, sweeps and the Darcy GKN
evaluation protocols of graph_pde_tpu_torch against graph_pde_tpu, on
the CPU.

The registry and the sweep specs must be equal field by field. Each
protocol runs on both sides from the same parameters (JAX ``gkn_init``,
carried over as numpy) and the same data (the shared synthetic cache):
every rel-L2 within 1e-5 relative. The protocols loop over test samples
and the JAX side compiles once per graph shape, so they take ntest=1.
One end-to-end smoke run of neurips1_gkn on each side, the port's
initial parameters replaced by JAX's: the train/test rel-L2 histories
within 1e-4 relative (the port's Adam, StepLR and shuffle follow the
JAX trainer's; float32 sums in another order drift over the steps).
"""
import dataclasses

import jax
import numpy as np
import pytest

from graph_pde_tpu.data import datasets as jdata
from graph_pde_tpu.experiments import registry as jreg
from graph_pde_tpu.experiments import runners as jrun
from graph_pde_tpu.experiments import sweeps as jsweeps
from graph_pde_tpu.models import gkn as jgkn
from graph_pde_tpu.train import GKNTask as JTask
from graph_pde_tpu.train import evaluate as jevaluate

from graph_pde_tpu_torch.convert import gkn_params_from_numpy
from graph_pde_tpu_torch.data import datasets as tdata
from graph_pde_tpu_torch.experiments import registry as treg
from graph_pde_tpu_torch.experiments import runners as trun
from graph_pde_tpu_torch.experiments import sweeps as tsweeps

RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def own_data_cache(tmp_path_factory):
    """Both packages cache synthetic data under ./.data_cache; this
    module generates its own in a directory of its own, so no other test
    process reads a file while it is being written."""
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(tmp_path_factory.mktemp("cwd"))
        yield
HIST_RTOL = 1e-4
CPU = jax.devices("cpu")[0]


def test_registry_names_match_jax():
    assert treg.names() == jreg.names()
    assert ([f.name for f in dataclasses.fields(treg.ExperimentConfig)]
            == [f.name for f in dataclasses.fields(jreg.ExperimentConfig)])


@pytest.mark.parametrize("name", jreg.names())
def test_registry_entry_matches_jax(name):
    t, j = treg.get(name), jreg.get(name)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(t.smoke()) == dataclasses.asdict(j.smoke())


def test_registry_checks_match_jax():
    for kw in ({"compute_dtype": "float16"}, {"assemble_sigma": 0.0}):
        for reg in (treg, jreg):
            with pytest.raises(ValueError):
                reg.ExperimentConfig(name="x", family="gkn", **kw)


@pytest.mark.parametrize("name", sorted(jsweeps.REFERENCE_SWEEPS))
def test_sweep_configs_match_jax(name):
    assert tsweeps.REFERENCE_SWEEPS[name] == jsweeps.REFERENCE_SWEEPS[name]
    t = tsweeps.sweep_configs(name)
    j = jsweeps.sweep_configs(name)
    assert [dataclasses.asdict(c) for c in t] == \
        [dataclasses.asdict(c) for c in j]


def _setup(name, **overrides):
    """The smoke config of ``name``; both packages' model configs, data
    and normalizers, and the same initial parameters on both sides."""
    cfg = dataclasses.replace(treg.get(name).smoke(), **overrides)
    jcfg = dataclasses.replace(jreg.get(name).smoke(), **overrides)
    tm = trun._gkn_config(cfg)
    jm = jgkn.GKNConfig(**dataclasses.asdict(tm))
    jp = jgkn.gkn_init(jax.random.PRNGKey(cfg.seed), jm)
    tp = gkn_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    t_arrays, t_norms, t_test = trun._darcy_data(cfg)
    fields = jrun._load_darcy_fields(jcfg, jcfg.ntrain, None,
                                     jcfg.data_seed)
    j_arrays, j_norms = jdata.prepare_darcy(
        fields, n=jcfg.ntrain, r=jcfg.downsample, u_norm=jcfg.u_norm)
    test_fields = jrun._load_darcy_fields(jcfg, jcfg.ntest, None,
                                          jcfg.data_seed + 1)
    j_test, _ = jdata.prepare_darcy(
        test_fields, n=jcfg.ntest, r=jcfg.downsample, normalizers=j_norms,
        u_normalizer=j_arrays.u_normalizer)
    j_test.u = np.asarray(j_arrays.u_normalizer.encode(j_test.u))
    return dict(cfg=cfg, jcfg=jcfg, tm=tm, jm=jm, tp=tp, jp=jp,
                t=(t_arrays, t_norms, t_test), j=(j_arrays, j_norms, j_test))


def _close(got, want, rtol=RTOL):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=rtol), k


def test_multires_matches_jax():
    s = _setup("uai3_resolution", ntest=1)
    got, fresh = trun._eval_gkn_multires(s["cfg"], s["tm"], s["tp"],
                                         *s["t"][:2], s["cfg"].radius_train,
                                         "cpu")
    want, jfresh = jrun._eval_gkn_multires(s["jcfg"], s["jm"], s["jp"],
                                           *s["j"][:2],
                                           s["jcfg"].radius_train)
    assert fresh == jfresh
    assert sorted(got) == [17, 33]
    _close(got, want)


def test_split_random_matches_jax():
    s = _setup("uai7_evaluate2", ntest=1)
    got = trun._eval_gkn_split_random(s["cfg"], s["tm"], s["tp"],
                                      *s["t"][:2], "cpu")
    want = jrun._eval_gkn_split_random(s["jcfg"], s["jm"], s["jp"],
                                       *s["j"][:2])
    _close(got, want)


def test_split_downsample_matches_jax():
    s = _setup("uai7_evaluate", ntest=1)
    got = trun._eval_gkn_split_downsample(s["cfg"], s["tm"], s["tp"],
                                          *s["t"][:2], "cpu")
    want = jrun._eval_gkn_split_downsample(s["jcfg"], s["jm"], s["jp"],
                                           *s["j"][:2])
    _close(got, want)


def test_shard_train_graphs_match_jax():
    """From the same prepared arrays, the same shards bit for bit."""
    s = _setup("uai7_evaluate", ntrain=3)
    ja = s["j"][0]
    ta = tdata.DarcyArrays(ja.a, ja.a_smooth, ja.a_gradx, ja.a_grady,
                           np.asarray(ja.u), None, ja.s)
    tg = trun._darcy_shard_train_graphs(s["cfg"], ta)
    jg = jrun._darcy_shard_train_graphs(s["jcfg"], ja)
    assert tg.x.shape[0] == 3 * s["cfg"].graphs_per_sample
    for f in ("x", "senders", "receivers", "edge_attr", "n_node", "n_edge",
              "y", "sample_idx", "sender_perm"):
        a, b = getattr(tg, f), getattr(jg, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=f)
    assert (tg.sorted_span, tg.sender_span) == (int(jg.sorted_span),
                                                int(jg.sender_span))


def test_eval_by_m_matches_jax():
    s = _setup("uai5_sample_generalize", ntest=1)
    cfg, jcfg = s["cfg"], s["jcfg"]
    t_arrays, _, t_test = s["t"]
    j_arrays, _, j_test = s["j"]
    task = trun._task(cfg, s["tm"], t_arrays)
    got = trun._eval_gkn_by_m(cfg, task, s["tp"], t_test,
                              cfg.radius_train, "cpu")
    # the JAX runner's inline eval_m loop (runners.py:271-283)
    jtask = JTask(s["jm"], u_normalizer=j_arrays.u_normalizer,
                  loss_type=jcfg.loss, use_sample_idx=jcfg.u_norm == "unit")
    want = {int(m): jevaluate(
        jtask, s["jp"], jdata.darcy_gkn_graphs(
            j_test, m=m, radius=jcfg.radius_train, seed=jcfg.seed + 5),
        batch_size=jcfg.batch_size) for m in jcfg.eval_m}
    assert sorted(got) == [100, 200, 400, 800]
    _close(got, want)


def test_neurips1_smoke_run_matches_jax(monkeypatch):
    cfg = treg.get("neurips1_gkn")
    tm = trun._gkn_config(cfg.smoke())
    jp = jgkn.gkn_init(jax.random.PRNGKey(cfg.seed),
                       jgkn.GKNConfig(**dataclasses.asdict(tm)))
    tp = gkn_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    monkeypatch.setattr(trun, "gkn_init", lambda gen, c, device=None: tp)
    got = trun.run_experiment(cfg, smoke=True, device="cpu")
    want = jrun.run_experiment(jreg.get("neurips1_gkn"), smoke=True)
    for key in ("train_l2", "test_l2"):
        assert len(got[key]) == len(want[key]) == 2
        np.testing.assert_allclose(got[key], want[key], rtol=HIST_RTOL,
                                   atol=0, err_msg=key)
    assert got["test_epochs"] == want["test_epochs"]
    assert got["_bundle"]["extra"] == want["_bundle"]["extra"]
    # the port's runner also fuses the kcached depth loop where the
    # one-hot gate would apply ('auto'); JAX's runner leaves it 'off'
    assert got["_bundle"]["model_cfg"].kcached_fused == "auto"
    assert dataclasses.asdict(dataclasses.replace(
        got["_bundle"]["model_cfg"], kcached_fused="off")) == \
        dataclasses.asdict(want["_bundle"]["model_cfg"])
