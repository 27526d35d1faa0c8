"""The port's command line (graph_pde_tpu_torch.cli) on the CPU, and
serving a JAX bundle with the port.

``run neurips1_gkn --smoke --bundle`` then ``predict --synthetic 2 --res
33`` (the smoke training grid: neurips1's unit u-normalizer serves only
there) must write what the port's GKNPredictor gives on the loaded
bundle. A bundle written by the JAX package, restored there and carried
over as numpy, must serve the same fields as JAX's GKNPredictor within
1e-5 of the output's max-abs, and a JAX general-MGKN bundle the same
fields as JAX's MGKNGeneralPredictor within 1e-4 (float32 sums through
two V-cycles in another order).
"""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from graph_pde_tpu import inference as jinf
from graph_pde_tpu.data import datasets as jdata
from graph_pde_tpu.data import synthetic as jsyn
from graph_pde_tpu.models import gkn as jgkn
from graph_pde_tpu.models import mgkn_general as jmg
from graph_pde_tpu.models import mgkn_orthogonal as jmo
from graph_pde_tpu.train import export as jexport
from graph_pde_tpu.utils import normalizers as jnorm

from graph_pde_tpu_torch import cli
from graph_pde_tpu_torch import train as ttrain
from graph_pde_tpu_torch.convert import (gkn_params_from_numpy,
                                         mgkn_general_params_from_numpy,
                                         mgkn_orthogonal_params_from_numpy)
from graph_pde_tpu_torch.data import (load_or_generate_burgers,
                                      load_or_generate_darcy)
from graph_pde_tpu_torch.experiments import names
from graph_pde_tpu_torch.inference import (GKNPredictor,
                                           MGKNGeneralPredictor,
                                           MGKNOrthogonalPredictor)
from graph_pde_tpu_torch.train import load_bundle, load_meta
from graph_pde_tpu_torch.utils.matio import MatReader

SERVE_TOL = 1e-5
MGKN_SERVE_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def own_data_cache(tmp_path_factory):
    """Both packages cache synthetic data under ./.data_cache; this
    module generates its own in a directory of its own, so no other test
    process reads a file while it is being written."""
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(tmp_path_factory.mktemp("cwd"))
        yield


def _last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One smoke run with a bundle, curves, results JSON and a passing
    --expect-l2 (tolerance wide enough for any finite rel-L2)."""
    d = tmp_path_factory.mktemp("run")
    args = ["run", "neurips1_gkn", "--smoke", "--device", "cpu",
            "--bundle", str(d / "bundle"), "--curves", str(d / "curves"),
            "--out", str(d / "result.json"), "--expect-l2", "0.5",
            "--tol", "10"]
    rc = cli.main(args)
    return d, rc


def test_run_writes_bundle_curves_and_passes(trained):
    d, rc = trained
    assert rc == 0
    result = json.load(open(d / "result.json"))
    assert np.isfinite(result["final_test_l2"])
    train = np.loadtxt(d / "curves" / "neurips1_gkn_train_l2.txt")
    test = np.loadtxt(d / "curves" / "neurips1_gkn_test_l2.txt")
    np.testing.assert_allclose(train[:, 1], result["train_l2"], rtol=1e-6)
    np.testing.assert_allclose(test[:, 1], result["test_l2"], rtol=1e-6)
    assert list(test[:, 0]) == result["test_epochs"]
    params, cfg, norms, extra = load_bundle(str(d / "bundle"))
    assert extra["experiment"] == "neurips1_gkn" and cfg.width == 16
    assert sorted(norms) == ["a", "a_gradx", "a_grady", "a_smooth", "u"]


def test_predict_equals_the_predictor(trained, capsys):
    d, _ = trained
    out = str(d / "pred.mat")
    rc = cli.main(["predict", str(d / "bundle"), "--synthetic", "2",
                   "--res", "33", "--output", out, "--device", "cpu"])
    assert rc == 0
    summary = _last_json(capsys.readouterr().out)
    assert summary["n"] == 2 and summary["s"] == 33
    assert np.isfinite(summary["rel_l2"]) and summary["output"] == out
    got = MatReader(out).read_field("pred")
    params, cfg, norms, extra = load_bundle(str(d / "bundle"))
    f = load_or_generate_darcy(2, 33)
    want = GKNPredictor(
        params, cfg, input_normalizers={k: norms[k] for k in
                                        ("a", "a_smooth", "a_gradx",
                                         "a_grady")},
        u_normalizer=norms["u"], radius=extra["radius"],
        device="cpu").predict(f["coeff"], f["Kcoeff"], f["Kcoeff_x"],
                              f["Kcoeff_y"])
    np.testing.assert_array_equal(got.reshape(2, -1), want)


def test_expect_l2_fail_exit_code(tmp_path, capsys):
    rc = cli.main(["run", "neurips1_gkn", "--smoke", "--device", "cpu",
                   "--set", "epochs=1", "--expect-l2", "5.0",
                   "--tol", "1e-3"])
    assert rc == 1
    assert "-> FAIL" in capsys.readouterr().out


def test_run_profile_writes_a_trace(tmp_path, capsys):
    prof = tmp_path / "prof"
    rc = cli.main(["run", "neurips1_gkn", "--smoke", "--device", "cpu",
                   "--set", "epochs=1", "--set", "ntrain=2",
                   "--profile", str(prof)])
    assert rc == 0
    assert _last_json(capsys.readouterr().out)["profile_dir"] == str(prof)
    assert json.load(open(prof / "trace.json"))["traceEvents"]


def test_predict_needs_an_input(trained):
    d, _ = trained
    assert cli.main(["predict", str(d / "bundle"), "--device", "cpu"]) == 2


def test_predict_mgkn_bundle_exits_2(tmp_path, capsys):
    """A GCN bundle loads and, as in the JAX package, has no serving
    path."""
    from graph_pde_tpu_torch.models.gcn import GCNConfig, gcn_init

    cfg = GCNConfig(width=8, ker_width=16)
    ttrain.save_bundle(str(tmp_path / "gcn"),
                       gcn_init(torch.Generator().manual_seed(0), cfg,
                                device="cpu"), cfg,
                       extra={"family": "gcn", "dataset": "darcy"})
    rc = cli.main(["predict", str(tmp_path / "gcn"), "--synthetic", "1",
                   "--res", "9", "--device", "cpu"])
    assert rc == 2
    assert capsys.readouterr().err.strip() == \
        "error: no serving path for family='gcn' dataset='darcy'"


def test_run_gcn_bundle_exits_2(tmp_path, capsys):
    """The GCN runner exports no bundle: `run --bundle` trains, then
    exits 2, as the JAX CLI does; without --bundle it exits 0."""
    args = ["run", "neurips4_gcn", "--smoke", "--device", "cpu", "--set",
            "epochs=1", "--set", "ntrain=2", "--set", "ntest=1"]
    rc = cli.main(args + ["--bundle", str(tmp_path / "b")])
    assert rc == 2
    assert capsys.readouterr().err.strip() == \
        "error: 'gcn' runner exports no bundle"
    assert not (tmp_path / "b").exists()
    assert cli.main(args) == 0
    assert np.isfinite(_last_json(capsys.readouterr().out)["final_test_l2"])


def test_run_figures_writes_the_triptychs(tmp_path):
    """`run --figures DIR` writes the worst, median and best test
    samples' triptychs and lists them under 'figures'."""
    figs, out = tmp_path / "figs", tmp_path / "r.json"
    rc = cli.main(["run", "neurips1_gkn", "--smoke", "--device", "cpu",
                   "--set", "epochs=1", "--set", "ntrain=2",
                   "--figures", str(figs), "--out", str(out)])
    assert rc == 0
    names = [f"neurips1_gkn_{t}.png" for t in ("best", "median", "worst")]
    assert json.load(open(out))["figures"] == [str(figs / n)
                                               for n in names]
    assert sorted(os.listdir(figs)) == sorted(names)


def test_list_prints_the_registry(capsys):
    assert cli.main(["list"]) == 0
    assert capsys.readouterr().out.split() == names()


@pytest.mark.parametrize("args", [
    ["run", "neurips1_gkn", "--smoke"],
    ["run", "mgkn_general_darcy2d", "--smoke"],
    ["sweep", "neurips1_gkn", "--smoke"],
    ["predict", "missing_bundle", "--synthetic", "1"],
])
def test_default_device_needs_cuda(monkeypatch, args):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(args)


def test_jax_bundle_served_by_the_port(tmp_path):
    """A JAX bundle: JAX restores its params (orbax), the port takes them
    as numpy and reads bundle.json itself; both predictors serve the
    same fields."""
    kw = dict(width=8, ker_width=16, depth=2, ker_in=6, in_width=6,
              kernel_layers=(6, 8, 16, 64), relu_last=False,
              impl="kcached")
    jcfg = jgkn.GKNConfig(**kw)
    f = load_or_generate_darcy(4, 17, seed=3)
    flat = {k: v.reshape(4, -1) for k, v in f.items()}
    norms = {"a": jnorm.GaussianNormalizer(flat["coeff"]),
             "a_smooth": jnorm.GaussianNormalizer(flat["Kcoeff"]),
             "a_gradx": jnorm.GaussianNormalizer(flat["Kcoeff_x"]),
             "a_grady": jnorm.GaussianNormalizer(flat["Kcoeff_y"]),
             "u": jnorm.GaussianNormalizer(flat["sol"])}
    d = str(tmp_path / "jax_bundle")
    jexport.save_bundle(d, jgkn.gkn_init(jax.random.PRNGKey(1), jcfg), jcfg,
                        normalizers=norms,
                        extra={"family": "gkn", "dataset": "darcy",
                               "radius": 0.3})
    jp, jc, jn, jx = jexport.load_bundle(d)
    want = jinf.GKNPredictor(
        params=jp, cfg=jc, input_normalizers={k: jn[k] for k in jn
                                              if k != "u"},
        u_normalizer=jn["u"], radius=jx["radius"]).predict(f["coeff"][:2])
    tcfg, tn, tx = load_meta(d)
    got = GKNPredictor(
        gkn_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"), tcfg,
        input_normalizers={k: tn[k] for k in tn if k != "u"},
        u_normalizer=tn["u"], radius=tx["radius"],
        device="cpu").predict(f["coeff"][:2])
    want = np.asarray(want)
    assert got.shape == want.shape == (2, 17 * 17)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= SERVE_TOL, err
    assert os.path.isdir(os.path.join(d, "params"))


def test_jax_mgkn_general_bundle_served_by_the_port(tmp_path):
    """A JAX general-MGKN bundle (width 8, ker_width 16, depth 2, three
    levels): the port reads its bundle.json, takes the params JAX
    restores as numpy, and serves the fields JAX's MGKNGeneralPredictor
    serves, through the same splitter windows."""
    jcfg = jmg.MGKNGeneralConfig(width=8, ker_width=16, depth=2,
                                 points=(40, 12, 6), impl="kcached")
    f = load_or_generate_darcy(4, 17, seed=4)
    flat = {k: v.reshape(4, -1) for k, v in f.items()}
    norms = {"a": jnorm.GaussianNormalizer(flat["coeff"]),
             "a_smooth": jnorm.GaussianNormalizer(flat["Kcoeff"]),
             "a_gradx": jnorm.GaussianNormalizer(flat["Kcoeff_x"]),
             "a_grady": jnorm.GaussianNormalizer(flat["Kcoeff_y"]),
             "u": jnorm.UnitGaussianNormalizer(flat["sol"])}
    d = str(tmp_path / "jax_mgkn")
    jexport.save_bundle(
        d, jmg.mgkn_general_init(jax.random.PRNGKey(2), jcfg), jcfg,
        normalizers=norms,
        extra={"family": "mgkn_general", "dataset": "darcy",
               "radius_inner": [0.25, 0.5, 1.0],
               "radius_inter": [0.125, 0.25], "train_s": 17})
    jp, jc, jn, jx = jexport.load_bundle(d)
    inputs = {k: jn[k] for k in jn if k != "u"}
    want = np.asarray(jinf.MGKNGeneralPredictor(
        jp, jc, input_normalizers=inputs, u_normalizer=jn["u"],
        radius_inner=tuple(jx["radius_inner"]),
        radius_inter=tuple(jx["radius_inter"])).predict(f["coeff"][:2]))
    tcfg, tn, tx = load_meta(d)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jc)
    got = MGKNGeneralPredictor(
        mgkn_general_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"),
        tcfg, input_normalizers={k: tn[k] for k in tn if k != "u"},
        u_normalizer=tn["u"], radius_inner=tuple(tx["radius_inner"]),
        radius_inter=tuple(tx["radius_inter"]),
        device="cpu").predict(f["coeff"][:2])
    assert got.shape == want.shape == (2, 17 * 17)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= MGKN_SERVE_TOL, err


# a seconds-scale orthogonal MGKN run: s=16 (three levels), one epoch
ORTHO_RUN = ["run", "mgkn_orthogonal_burgers1d", "--set", "source_res=16",
             "--set", "downsample=1", "--set", "ntrain=2", "--set",
             "ntest=1", "--set", "epochs=1", "--set", "width=8", "--set",
             "ker_width=32", "--set", "depth=1", "--device", "cpu"]


def test_predict_orthogonal_bundle_equals_the_predictor(tmp_path, capsys):
    """run --bundle on the orthogonal MGKN, then predict on synthetic
    Burgers fields at the bundle's s: the written predictions equal the
    predictor's, and another s is refused as the JAX predictor refuses
    it."""
    d = str(tmp_path / "ortho")
    assert cli.main(ORTHO_RUN + ["--bundle", d]) == 0
    capsys.readouterr()
    params, cfg, norms, extra = load_bundle(d)
    assert extra["family"] == "mgkn_orthogonal" and extra["train_s"] == 16
    assert cfg.s == 16 and cfg.impl == "kcached"
    out = str(tmp_path / "pred.mat")
    rc = cli.main(["predict", d, "--synthetic", "2", "--output", out,
                   "--device", "cpu"])
    assert rc == 0
    summary = _last_json(capsys.readouterr().out)
    assert summary["n"] == 2 and summary["s"] == 16
    assert np.isfinite(summary["rel_l2"])
    got = MatReader(out).read_field("pred")
    pred = MGKNOrthogonalPredictor(params, cfg, norms["a"], norms["u"],
                                   device="cpu")
    want = pred.predict(load_or_generate_burgers(2, 16)["a"])
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="training resolution s=16"):
        pred.predict(np.zeros((1, 8), np.float32))


def test_jax_orthogonal_bundle_served_by_the_port(tmp_path, monkeypatch,
                                                  capsys):
    """A JAX orthogonal-MGKN bundle through the port's ``cli predict``:
    JAX restores its params (orbax), the port reads bundle.json itself;
    the port's predictions within 1e-5 of the max-abs of the JAX
    predictor's on the same fields."""
    fields = jsyn.burgers_dataset(3, 16, seed=4, gen_res=256)
    arrays = jdata.prepare_burgers(fields, n=3)
    jcfg = jmo.MGKNOrthogonalConfig(width=8, ker_width=32, depth=2, s=16,
                                    impl="kcached")
    d = str(tmp_path / "jax_ortho")
    jexport.save_bundle(
        d, jmo.mgkn_orthogonal_init(jax.random.PRNGKey(2), jcfg), jcfg,
        normalizers={"a": arrays.a_normalizer, "u": arrays.u_normalizer},
        extra={"family": "mgkn_orthogonal", "experiment": "x",
               "dataset": "burgers", "train_s": 16})
    jp, jc, jn, _ = jexport.load_bundle(d)
    tp = mgkn_orthogonal_params_from_numpy(jax.tree.map(np.asarray, jp),
                                           "cpu")
    monkeypatch.setattr(ttrain, "load_bundle",
                        lambda path: (tp, *load_meta(path)))
    out = str(tmp_path / "pred.mat")
    rc = cli.main(["predict", d, "--synthetic", "2", "--output", out,
                   "--device", "cpu"])
    assert rc == 0
    assert _last_json(capsys.readouterr().out)["s"] == 16
    got = MatReader(out).read_field("pred")
    want = np.asarray(jinf.MGKNOrthogonalPredictor(
        jp, jc, jn["a"], jn["u"]).predict(
            load_or_generate_burgers(2, 16)["a"]))
    assert got.shape == want.shape == (2, 16)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= SERVE_TOL, err
