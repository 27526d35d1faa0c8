"""Port parity: .mat I/O, serving-bundle metadata, normalizer state,
Gaussian smoothing, DownsampleGridSplitter and repad_edges of
graph_pde_tpu_torch against graph_pde_tpu, on the CPU.

Host arrays built from the same inputs and seed must be equal; float32
smoothing within 1e-6 of the JAX filter and 1e-5 of scipy.ndimage
(which accumulates in float64); fitted normalizer statistics within
1e-6 relative (float32 means and deviations reduced in another order).
"""
import json
import os
import sys

import jax
import numpy as np
import pytest
import scipy.ndimage
import torch

from graph_pde_tpu.graph import graph as jgraph
from graph_pde_tpu.graph import splitters as jsplit
from graph_pde_tpu.graph.mesh import make_box_grid
from graph_pde_tpu.models import gkn as jgkn
from graph_pde_tpu.train import export as jexport
from graph_pde_tpu.utils import filters as jfilters
from graph_pde_tpu.utils import matio as jmatio
from graph_pde_tpu.utils import normalizers as jnorm

from graph_pde_tpu_torch.convert import (normalizer_from_state,
                                         normalizer_state)
from graph_pde_tpu_torch.graph import graph as tgraph
from graph_pde_tpu_torch.graph import splitters as tsplit
from graph_pde_tpu_torch.models import gkn as tgkn
from graph_pde_tpu_torch.train import export as texport
from graph_pde_tpu_torch.train.trainer import param_leaves
from graph_pde_tpu_torch.utils import filters as tfilters
from graph_pde_tpu_torch.utils import matio as tmatio
from graph_pde_tpu_torch.utils import normalizers as tnorm

GRAPH_FIELDS = ("x", "senders", "receivers", "edge_attr", "n_node",
                "n_edge", "y", "sample_idx", "sender_perm")


def _fields(seed=0):
    rng = np.random.default_rng(seed)
    return {"coeff": rng.normal(size=(3, 9, 9)).astype(np.float32),
            "sol": rng.normal(size=(3, 9, 9)),
            "idx": np.arange(12, dtype=np.int32).reshape(3, 4)}


@pytest.mark.parametrize("v73", [False, True])
@pytest.mark.parametrize("writer,reader", [
    ("port", "port"), ("port", "jax"), ("jax", "port")])
def test_mat_round_trip(tmp_path, v73, writer, reader):
    fields = _fields()
    path = str(tmp_path / "f.mat")
    (tmatio if writer == "port" else jmatio).write_mat(path, fields,
                                                       v73=v73)
    r = (tmatio if reader == "port" else jmatio).MatReader(path)
    assert sorted(r.keys()) == sorted(fields)
    for k, v in fields.items():
        got = r.read_field(k)
        assert got.dtype == np.float32 and got.shape == v.shape
        np.testing.assert_array_equal(got, v.astype(np.float32))


def test_mat_reader_keeps_dtype_without_to_float(tmp_path):
    path = str(tmp_path / "f.mat")
    tmatio.write_mat(path, _fields())
    got = tmatio.MatReader(path, to_float=False).read_field("idx")
    assert got.dtype == np.int32


def test_v73_without_h5py_names_it(tmp_path, monkeypatch):
    path = str(tmp_path / "f.mat")
    tmatio.write_mat(path, _fields(), v73=True)
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        tmatio.MatReader(path)
    with pytest.raises(ImportError, match="h5py"):
        tmatio.write_mat(path, _fields(), v73=True)
    tmatio.write_mat(str(tmp_path / "g.mat"), _fields())  # needs no h5py
    assert tmatio.MatReader(str(tmp_path / "g.mat")).keys()


def _norms(seed=0):
    rng = np.random.default_rng(seed)
    a = rng.normal(2.0, 3.0, size=(5, 16)).astype(np.float32)
    return {
        "a": (jnorm.GaussianNormalizer(a), tnorm.GaussianNormalizer(a)),
        "u": (jnorm.UnitGaussianNormalizer(a),
              tnorm.UnitGaussianNormalizer(a)),
        "r": (jnorm.RangeNormalizer(a), tnorm.RangeNormalizer(a)),
    }


def _close(got, want, path=""):
    """Nested JSON values: equal keys, types and strings; numbers within
    1e-6 relative."""
    assert type(got) is type(want), path
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert got == pytest.approx(want, rel=1e-6, abs=1e-7), path
    else:
        assert got == want, path


def test_bundle_json_matches_jax(tmp_path):
    kw = dict(width=8, ker_width=16, depth=2,
              kernel_layers=(6, 8, 16, 64), relu_last=False, impl="auto",
              compute_dtype="bfloat16")
    jcfg, tcfg = jgkn.GKNConfig(**kw), tgkn.GKNConfig(**kw)
    norms = _norms()
    extra = {"family": "gkn", "dataset": "darcy", "radius": 0.2,
             "experiment": "x"}
    jparams = jgkn.gkn_init(jax.random.PRNGKey(0), jcfg)
    tparams = tgkn.gkn_init(torch.Generator().manual_seed(0), tcfg,
                            device="cpu")
    jexport.save_bundle(str(tmp_path / "j"), jparams, jcfg,
                        normalizers={k: v[0] for k, v in norms.items()},
                        extra=extra)
    texport.save_bundle(str(tmp_path / "t"), tparams, tcfg,
                        normalizers={k: v[1] for k, v in norms.items()},
                        extra=extra)
    metas = [json.load(open(os.path.join(str(tmp_path / d), "bundle.json")))
             for d in ("j", "t")]
    _close(metas[1], metas[0])
    # the port loads the JAX bundle's metadata as its own
    cfg, loaded, ex = texport.load_meta(str(tmp_path / "j"))
    assert cfg == tcfg and ex == extra
    params, cfg2, _, _ = texport.load_bundle(str(tmp_path / "t"))
    assert cfg2 == tcfg
    for a, b in zip(param_leaves(params), param_leaves(tparams)):
        assert torch.equal(a, b)


def test_load_bundle_refuses_unported_models(tmp_path):
    """Every model config class of the JAX package loads (a GCN bundle
    too); a class the packages do not have is refused."""
    from graph_pde_tpu_torch.models.gcn import GCNConfig, gcn_init

    cfg = GCNConfig(width=8, ker_width=16)
    params = gcn_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    texport.save_bundle(str(tmp_path / "gcn"), params, cfg,
                        extra={"family": "gcn"})
    _, loaded, norms, extra = texport.load_bundle(str(tmp_path / "gcn"))
    assert loaded == cfg and norms == {} and extra == {"family": "gcn"}
    d = tmp_path / "b"
    d.mkdir()
    (d / "bundle.json").write_text(json.dumps({
        "model_config_class": "FNOConfig", "model_config": {},
        "normalizers": {}, "extra": {}}))
    with pytest.raises(KeyError, match="FNOConfig"):
        texport.load_bundle(str(d))


@pytest.mark.parametrize("kind", ["a", "u", "r"])
def test_normalizer_state_round_trip(kind):
    jn, tn = _norms()[kind]
    state = normalizer_state(tn)
    _close(json.loads(json.dumps(state)), jexport._normalizer_state(jn))
    back = normalizer_from_state(state)
    assert normalizer_state(back) == state
    x = np.random.default_rng(1).normal(size=(2, 16)).astype(np.float32)
    np.testing.assert_array_equal(back.encode(x).numpy(),
                                  tn.encode(x).numpy())


@pytest.mark.parametrize("mode", ["constant", "wrap"])
@pytest.mark.parametrize("sigma", [1.0, 0.6])
def test_gaussian_filter(mode, sigma):
    x = np.random.default_rng(2).normal(size=(13, 17)).astype(np.float32)
    got = tfilters.gaussian_filter(x, sigma=sigma, mode=mode)
    assert got.dtype == np.float32
    np.testing.assert_allclose(
        got, np.asarray(jfilters.gaussian_filter(x, sigma=sigma, mode=mode)),
        rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        got, scipy.ndimage.gaussian_filter(x, sigma=sigma, mode=mode),
        rtol=0, atol=1e-5)


def _assert_graphs_equal(tg, jg):
    for f in GRAPH_FIELDS:
        a, b = getattr(tg, f), getattr(jg, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=f)
    for f in ("sorted_span", "sender_span", "node_block"):
        assert int(getattr(tg, f)) == int(getattr(jg, f)), f


def _splitters(s=13, r=3, m=30, seed=4):
    grid = make_box_grid([[0, 1], [0, 1]], [s, s])
    return (tsplit.DownsampleGridSplitter(grid, s, r=r, m=m, radius=0.3,
                                          seed=seed),
            jsplit.DownsampleGridSplitter(grid, s, r=r, m=m, radius=0.3,
                                          seed=seed))


def test_downsample_splitter_matches_jax():
    s = 13
    rng = np.random.default_rng(3)
    theta = rng.normal(size=(s * s, 4)).astype(np.float32)
    y = rng.normal(size=(s * s,)).astype(np.float32)
    tsp, jsp = _splitters(s)
    tshards, jshards = tsp.get_data(theta), jsp.get_data(theta)
    assert len(tshards) == len(jshards) == 9
    for (tg, txy), (jg, jxy) in zip(tshards, jshards):
        assert txy == jxy
        _assert_graphs_equal(tg, jg)
    for _ in range(3):
        (tg, txy), (jg, jxy) = tsp.sample(theta, y), jsp.sample(theta, y)
        assert txy == jxy
        _assert_graphs_equal(tg, jg)
    preds = [rng.normal(size=int(g.n_node)).astype(np.float32)
             for g, _ in tshards]
    xys = [xy for _, xy in tshards]
    np.testing.assert_allclose(
        tsp.assemble(preds, xys, sigma=1.0),
        np.asarray(jsp.assemble(preds, xys, sigma=1.0)), rtol=0, atol=1e-6)


def test_repad_edges_matches_jax():
    rng = np.random.default_rng(5)
    n, e = 20, 300
    args = (rng.normal(size=(n, 3)), rng.integers(0, n, e),
            rng.integers(0, n, e), rng.normal(size=(e, 2)))
    y = rng.normal(size=n)
    tg = tgraph.build_graph(*args, y=y)
    jg = jgraph.build_graph(*args, y=y)
    for cap in (512, 1024, 2048):
        _assert_graphs_equal(tgraph.repad_edges(tg, cap),
                             jgraph.repad_edges(jg, cap))
    with pytest.raises(ValueError, match="capacity"):
        tgraph.repad_edges(tg, 256)
