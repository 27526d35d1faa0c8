"""Port parity: graph building, mesh generators, splitter, Darcy data and
normalizers of graph_pde_tpu_torch against graph_pde_tpu.

Host-side builders are numpy in both packages, so their arrays must be
bit-identical. Normalizers compute float32 statistics in different
reduction orders: they agree to float32 rounding (rtol 1e-6)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_pde_tpu.data import synthetic as jsyn
from graph_pde_tpu.graph import build as jbuild
from graph_pde_tpu.graph import graph as jgraph
from graph_pde_tpu.graph import mesh as jmesh
from graph_pde_tpu.graph import splitters as jsplit
from graph_pde_tpu.utils import normalizers as jnorm

from graph_pde_tpu_torch.data import synthetic as tsyn
from graph_pde_tpu_torch.graph import build as tbuild
from graph_pde_tpu_torch.graph import graph as tgraph
from graph_pde_tpu_torch.graph import mesh as tmesh
from graph_pde_tpu_torch.graph import splitters as tsplit
from graph_pde_tpu_torch.utils import normalizers as tnorm

_ARRAYS = ("x", "senders", "receivers", "edge_attr", "n_node", "n_edge",
           "y", "sample_idx", "edge_valid", "sender_perm")
_STATIC = ("node_block", "sorted_span", "sender_span")


def _assert_same_graph(jg, tg):
    for f in _ARRAYS:
        a, b = getattr(jg, f), getattr(tg, f)
        assert (a is None) == (b is None), f
        if a is not None:
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype, (f, a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b, err_msg=f)
    for f in _STATIC:
        assert getattr(jg, f) == getattr(tg, f), f


def _random_edges(seed, n=40, e=300):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 5)).astype(np.float32),
            rng.integers(0, n, e), rng.integers(0, n, e),
            rng.normal(size=(e, 6)).astype(np.float32),
            rng.normal(size=(n, 1)).astype(np.float32),
            rng.permutation(n))


@pytest.mark.parametrize("node_block", [0, 8])
def test_build_graph_bit_identical(node_block):
    x, s, r, a, y, idx = _random_edges(0)
    kw = dict(y=y, sample_idx=idx, node_block=node_block)
    _assert_same_graph(jgraph.build_graph(x, s, r, a, **kw),
                       tgraph.build_graph(x, s, r, a, **kw))


def test_stack_and_flatten_bit_identical():
    jgs, tgs = [], []
    for seed in range(3):
        x, s, r, a, y, idx = _random_edges(seed, e=200 + 50 * seed)
        kw = dict(y=y, sample_idx=idx, n_edge_pad=512)
        jgs.append(jgraph.build_graph(x, s, r, a, **kw))
        tgs.append(tgraph.build_graph(x, s, r, a, **kw))
    jst, tst = jgraph.stack_graphs(jgs), tgraph.stack_graphs(tgs)
    _assert_same_graph(jst, tst)

    jfl = jgraph.flatten_stacked(jax.tree_util.tree_map(jnp.asarray, jst))
    tfl = tgraph.flatten_stacked(tst.to("cpu"))
    for f in _ARRAYS:
        a, b = getattr(jfl, f), getattr(tfl, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                          err_msg=f)


def test_graph_to_converts_dtypes():
    x, s, r, a, y, idx = _random_edges(4)
    g = tgraph.build_graph(x, s, r, a, y=y, sample_idx=idx).to("cpu")
    assert g.x.dtype == torch.float32 and g.senders.dtype == torch.int64
    assert g.sender_perm.dtype == torch.int64
    mask = g.edge_mask()
    assert mask.dtype == torch.bool and int(mask.sum()) == 300


def test_graph_to_without_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, s, r, a, _, _ = _random_edges(5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgraph.build_graph(x, s, r, a).to()


@pytest.mark.parametrize("method", ["tree", "dense"])
def test_radius_connectivity_and_attributes(method):
    pts = np.random.default_rng(1).uniform(size=(150, 2))
    ei_j = jbuild.radius_connectivity(pts, 0.2, method=method)
    ei_t = tbuild.radius_connectivity(pts, 0.2, method=method)
    np.testing.assert_array_equal(ei_j, ei_t)
    theta = np.random.default_rng(2).normal(size=150)
    np.testing.assert_array_equal(
        jbuild.edge_attributes(pts, ei_j, theta=theta),
        tbuild.edge_attributes(pts, ei_t, theta=theta))
    np.testing.assert_array_equal(jbuild.forward_filter(ei_j),
                                  tbuild.forward_filter(ei_t))


def test_mesh_generators_identical():
    np.testing.assert_array_equal(
        jmesh.make_box_grid([[0, 1], [0, 1]], [7, 5]),
        tmesh.make_box_grid([[0, 1], [0, 1]], [7, 5]))
    jsq = jmesh.SquareMeshGenerator([[0, 1], [0, 1]], [9, 9])
    tsq = tmesh.SquareMeshGenerator([[0, 1], [0, 1]], [9, 9])
    np.testing.assert_array_equal(jsq.ball_connectivity(0.3),
                                  tsq.ball_connectivity(0.3))
    np.testing.assert_array_equal(jsq.get_grid(), tsq.get_grid())
    np.testing.assert_array_equal(jsq.attributes(), tsq.attributes())

    theta = np.random.default_rng(3).normal(size=(144,))
    jr = jmesh.RandomMeshGenerator([[0, 1], [0, 1]], [12, 12], 50, seed=7)
    tr = tmesh.RandomMeshGenerator([[0, 1], [0, 1]], [12, 12], 50, seed=7)
    np.testing.assert_array_equal(jr.sample(), tr.sample())
    np.testing.assert_array_equal(jr.ball_connectivity(0.25, True),
                                  tr.ball_connectivity(0.25, True))
    np.testing.assert_array_equal(jr.attributes(theta=theta),
                                  tr.attributes(theta=theta))


def test_random_grid_splitter_identical():
    s = 12
    grid = jmesh.make_box_grid([[0, 1], [0, 1]], [s, s])
    theta = np.random.default_rng(4).normal(size=(s * s, 4))
    jsp = jsplit.RandomGridSplitter(grid, s, m=36, l=2, radius=0.3, seed=3)
    tsp = tsplit.RandomGridSplitter(grid, s, m=36, l=2, radius=0.3, seed=3)
    jsh, tsh = jsp.get_data(theta), tsp.get_data(theta)
    assert len(jsh) == len(tsh) == 8
    for jg, tg in zip(jsh, tsh):
        _assert_same_graph(jg, tg)
    preds = [np.asarray(g.x)[:36, 2] for g in tsh]
    idxs = [g.sample_idx[:36] for g in tsh]
    np.testing.assert_array_equal(jsp.assemble(preds, idxs),
                                  tsp.assemble(preds, idxs))


def test_darcy_dataset_identical():
    jd, td = jsyn.darcy_dataset(2, 13, seed=5), tsyn.darcy_dataset(2, 13,
                                                                   seed=5)
    assert jd.keys() == td.keys()
    for k in jd:
        np.testing.assert_array_equal(jd[k], td[k], err_msg=k)


def test_normalizers_match():
    rng = np.random.default_rng(6)
    data = rng.normal(2.0, 3.0, size=(10, 25)).astype(np.float32)
    probe = rng.normal(size=(4, 25)).astype(np.float32)
    tol = dict(rtol=1e-6, atol=1e-6)
    for jcls, tcls in [(jnorm.UnitGaussianNormalizer,
                        tnorm.UnitGaussianNormalizer),
                       (jnorm.GaussianNormalizer, tnorm.GaussianNormalizer)]:
        jn, tn = jcls(data, eps=1e-3), tcls(data, eps=1e-3)
        np.testing.assert_allclose(np.asarray(jn.encode(probe)),
                                   tn.encode(probe).numpy(), **tol)
        np.testing.assert_allclose(np.asarray(jn.decode(probe)),
                                   tn.decode(probe).numpy(), **tol)
    jr, tr = jnorm.RangeNormalizer(data), tnorm.RangeNormalizer(data)
    np.testing.assert_allclose(np.asarray(jr.encode(probe)),
                               tr.encode(probe).numpy(), **tol)
    np.testing.assert_allclose(np.asarray(jr.decode(probe)),
                               tr.decode(probe).numpy(), **tol)

    # sample_idx decode: [n] stats gathered to [batch, m], and the
    # T x batch x n case with [T, n] stats
    ju, tu = (jnorm.UnitGaussianNormalizer(data),
              tnorm.UnitGaussianNormalizer(data))
    idx = rng.integers(0, 25, size=(4, 7))
    vals = rng.normal(size=(4, 7)).astype(np.float32)
    np.testing.assert_allclose(np.asarray(ju.decode(vals, sample_idx=idx)),
                               tu.decode(vals, sample_idx=idx).numpy(),
                               **tol)
    data_t = rng.normal(size=(10, 3, 25)).astype(np.float32)
    ju, tu = (jnorm.UnitGaussianNormalizer(data_t),
              tnorm.UnitGaussianNormalizer(data_t))
    vals = rng.normal(size=(3, 4, 7)).astype(np.float32)
    np.testing.assert_allclose(np.asarray(ju.decode(vals, sample_idx=idx)),
                               tu.decode(vals, sample_idx=idx).numpy(),
                               **tol)


@pytest.mark.parametrize("stats_shape", [(25,), (3, 25)])
def test_unit_normalizer_out_of_range_idx_matches_jax(stats_shape):
    """Out-of-range sample_idx decodes as jnp gathers: a negative index
    wraps once, then indices clamp into [0, n - 1]."""
    rng = np.random.default_rng(7)
    data = rng.normal(size=(10,) + stats_shape).astype(np.float32)
    ju, tu = (jnorm.UnitGaussianNormalizer(data),
              tnorm.UnitGaussianNormalizer(data))
    idx = np.array([[0, 24, 25, 26, 1000, -1, -25, -26, -1000]])
    vals = rng.normal(size=stats_shape[:-1] + idx.shape).astype(np.float32)
    want = np.asarray(ju.decode(vals, sample_idx=idx))
    got = tu.decode(vals, sample_idx=idx).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # the clamped and wrapped indices read the stats of these locations
    np.testing.assert_allclose(
        got, tu.decode(vals, sample_idx=[[0, 24, 24, 24, 24, 24, 0, 0, 0]])
        .numpy(), rtol=0, atol=0)


def test_graph_dataclass_fields_match_jax_graph():
    jfields = {f.name for f in dataclasses.fields(jgraph.Graph)}
    tfields = {f.name for f in dataclasses.fields(tgraph.Graph)}
    assert jfields == tfields
