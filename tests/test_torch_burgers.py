"""Port parity, Burgers data: the multipole graph, the pooling ops, the
synthetic Burgers generator, the Burgers dataset builders and the GKN
runner's Burgers branch (neurips5_gkn with its split_random evaluation)
of graph_pde_tpu_torch against graph_pde_tpu, on the CPU.

The host builders are numpy copies, so their arrays must be equal bit
for bit. Model outputs and rel-L2 values are float32 sums taken in
other orders: tolerances are stated where they are used."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_pde_tpu.data import datasets as jdata
from graph_pde_tpu.data import synthetic as jsyn
from graph_pde_tpu.experiments import registry as jreg
from graph_pde_tpu.experiments import runners as jrun
from graph_pde_tpu.graph import multipole as jmp
from graph_pde_tpu.models import gkn as jgkn
from graph_pde_tpu.ops import pooling as jpool

from graph_pde_tpu_torch.convert import gkn_params_from_numpy
from graph_pde_tpu_torch.data import datasets as tdata
from graph_pde_tpu_torch.data import synthetic as tsyn
from graph_pde_tpu_torch.experiments import registry as treg
from graph_pde_tpu_torch.experiments import runners as trun
from graph_pde_tpu_torch.graph import multipole as tmp
from graph_pde_tpu_torch.ops import pooling as tpool

HIST_RTOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def own_data_cache(tmp_path_factory):
    """Both packages cache synthetic data under ./.data_cache; this
    module generates its own in a directory of its own."""
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(tmp_path_factory.mktemp("cwd"))
        yield


@pytest.fixture(scope="module")
def fields():
    return tsyn.burgers_dataset(5, 64, seed=2, gen_res=256)


@pytest.mark.parametrize("s,periodic", [(16, True), (16, False),
                                        (64, True)])
def test_multipole_edges_and_attrs_equal(s, periodic):
    rng = np.random.default_rng(s)
    theta = rng.normal(size=(3, s, 1)).astype(np.float32)
    tg, tt, te = tmp.multi_pole_grid1d(theta, 1, s, 3, is_periodic=periodic)
    jg, jt, je = jmp.multi_pole_grid1d(theta, 1, s, 3, is_periodic=periodic)
    assert tmp.multipole_levels_1d(s) == jmp.multipole_levels_1d(s)
    assert len(te) == len(je) == tmp.multipole_levels_1d(s) + 1
    for a, b in zip(tg + tt + te, jg + jt + je):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for l, e in enumerate(te):
        li = max(l - 1, 0)
        np.testing.assert_array_equal(
            tmp.get_edge_attr(tg[li], tt[li][1, :, 0], e),
            jmp.get_edge_attr(jg[li], jt[li][1, :, 0], e))


@pytest.mark.parametrize("shape", [(16, 3), (2, 8, 5)])
def test_pooling_matches(shape):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)

    def jax_op(fn):
        if len(shape) == 2:
            return np.asarray(fn(jnp.asarray(x)))
        return np.stack([np.asarray(fn(jnp.asarray(v))) for v in x])

    t = torch.from_numpy(x)
    np.testing.assert_array_equal(tpool.upsample_nearest_1d(t).numpy(),
                                  jax_op(jpool.upsample_nearest_1d))
    np.testing.assert_allclose(tpool.avg_pool_1d(t).numpy(),
                               jax_op(jpool.avg_pool_1d), rtol=1e-7,
                               atol=0)


def test_burgers_dataset_bit_equal():
    t = tsyn.burgers_dataset(2, 64, seed=3, gen_res=1024)
    j = jsyn.burgers_dataset(2, 64, seed=3, gen_res=1024)
    assert sorted(t) == sorted(j) == ["a", "u"]
    for k in t:
        assert t[k].dtype == j[k].dtype and t[k].shape == (2, 64)
        np.testing.assert_array_equal(t[k], j[k])
    with pytest.raises(ValueError):
        tsyn.burgers_dataset(1, 48, gen_res=64)


def test_load_or_generate_burgers_caches(tmp_path):
    a = tdata.load_or_generate_burgers(2, 32, seed=1,
                                       cache_dir=str(tmp_path))
    assert (tmp_path / "burgers_n2_s32_nu0.01_seed1.npz").exists()
    b = jdata.load_or_generate_burgers(2, 32, seed=1,
                                       cache_dir=str(tmp_path))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def _both_arrays(fields, **kw):
    return (tdata.prepare_burgers(fields, n=3, **kw),
            jdata.prepare_burgers(fields, n=3, **kw))


def test_prepare_burgers_and_multipole_data_match(fields):
    """The normalizers' statistics are float32 reductions in another
    order, so the encoded fields agree to 1e-5 of their max-abs; from the
    same encoded arrays the multipole data is equal bit for bit."""
    ta, ja = _both_arrays(fields, r=2)
    assert ta.s == ja.s == 32
    for f in ("a", "u"):
        got, want = getattr(ta, f), np.asarray(getattr(ja, f))
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), f
    ja.a, ja.u = ta.a, ta.u
    tb, jb = tdata.burgers_multipole_data(ta), jdata.burgers_multipole_data(ja)
    np.testing.assert_array_equal(tb[0], jb[0])
    np.testing.assert_array_equal(tb[1], jb[1])
    for t_list, j_list in zip(tb[2:], jb[2:]):
        assert len(t_list) == len(j_list) == 5
        for a, b in zip(t_list, j_list):
            np.testing.assert_array_equal(a, b)


def test_burgers_gkn_graphs_match(fields):
    ta, ja = _both_arrays(fields)
    ja.a, ja.u = ta.a, ta.u   # the same encoded arrays on both sides
    tg = tdata.burgers_gkn_graphs(ta, m=24, k=2, radius=0.2, seed=4)
    jg = jdata.burgers_gkn_graphs(ja, m=24, k=2, radius=0.2, seed=4)
    assert tg.x.shape[:2] == (6, 24) and tg.x.shape[2] == 2
    for f in ("x", "senders", "receivers", "edge_attr", "n_node", "n_edge",
              "y", "sample_idx"):
        np.testing.assert_array_equal(np.asarray(getattr(tg, f)),
                                      np.asarray(getattr(jg, f)), err_msg=f)


def _neurips5_params(cfg):
    tm = trun._gkn_config(cfg)
    assert (tm.ker_in, tm.in_width) == (4, 2)
    jm = jgkn.GKNConfig(**dataclasses.asdict(tm))
    jp = jgkn.gkn_init(jax.random.PRNGKey(cfg.seed), jm)
    return tm, jm, jp, gkn_params_from_numpy(jax.tree.map(np.asarray, jp),
                                             "cpu")


def test_split_random_burgers_matches_jax():
    """The 1-d full-field evaluation from the same parameters and
    arrays: rel-L2 within 1e-5 relative."""
    cfg = treg.get("neurips5_gkn").smoke()
    jcfg = jreg.get("neurips5_gkn").smoke()
    tm, jm, jp, tp = _neurips5_params(cfg)
    fields = trun._load_burgers_fields(cfg, cfg.ntrain + cfg.ntest, None,
                                       cfg.data_seed)
    ta = tdata.prepare_burgers(fields, n=cfg.ntrain)
    ja = jdata.prepare_burgers(fields, n=cfg.ntrain)
    got = trun._eval_gkn_split_random_burgers(cfg, tm, tp, ta, "cpu")
    want = jrun._eval_gkn_split_random_burgers(jcfg, jm, jp, ja)
    assert np.isfinite(got)
    assert got == pytest.approx(want, rel=1e-5)


def test_neurips5_smoke_run_matches_jax(monkeypatch):
    """neurips5_gkn at smoke size on each side from JAX's initial
    parameters: train/test histories and the full-field rel-L2 within
    1e-4 relative (the port's Adam, StepLR and shuffle follow JAX's;
    float32 sums in another order drift over the steps), the same
    bundle payload."""
    cfg = treg.get("neurips5_gkn")
    _, _, _, tp = _neurips5_params(cfg.smoke())
    monkeypatch.setattr(trun, "gkn_init", lambda gen, c, device=None: tp)
    got = trun.run_experiment(cfg, smoke=True, device="cpu")
    want = jrun.run_experiment(jreg.get("neurips5_gkn"), smoke=True)
    for key in ("train_l2", "test_l2"):
        assert len(got[key]) == len(want[key]) == 2
        np.testing.assert_allclose(got[key], want[key], rtol=HIST_RTOL,
                                   atol=0, err_msg=key)
    assert got["full_field_l2"] == pytest.approx(want["full_field_l2"],
                                                 rel=HIST_RTOL)
    assert got["_bundle"]["extra"] == want["_bundle"]["extra"]
    assert sorted(got["_bundle"]["normalizers"]) == ["a", "u"]
    # the port's runner also fuses the kcached depth loop where the
    # one-hot gate would apply ('auto'); JAX's runner leaves it 'off'
    assert got["_bundle"]["model_cfg"].kcached_fused == "auto"
    assert dataclasses.asdict(dataclasses.replace(
        got["_bundle"]["model_cfg"], kcached_fused="off")) == \
        dataclasses.asdict(want["_bundle"]["model_cfg"])
