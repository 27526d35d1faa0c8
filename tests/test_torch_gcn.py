"""Port parity, the GCN baseline: the lattice constructors, NodeBatch, the
GCN model, GCNTask on a shared template, gradients, train steps, the
runner and the GCN bundle of graph_pde_tpu_torch against graph_pde_tpu,
on the CPU (GCN reaches no Pallas kernel).

Small shapes: an s=8 lattice (64 nodes; node_block=16 for the blocked
layout), width 8, ker_width 16, depth 2. Parameters are JAX's, carried
over as numpy. The lattice constructors are numpy only and must equal
JAX's bit for bit; the model's tolerance is 1e-4 of the output's
max-abs (float32 sums in another order through 8 convs)."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_pde_tpu.experiments import registry as jreg
from graph_pde_tpu.experiments import runners as jrun
from graph_pde_tpu.graph import graph as jgraph
from graph_pde_tpu.graph import lattice as jlat
from graph_pde_tpu.models import gcn as jgcn
from graph_pde_tpu.train import export as jexport
from graph_pde_tpu.train import optim as joptim
from graph_pde_tpu.train import tasks as jtasks
from graph_pde_tpu.train import trainer as jtrainer
from graph_pde_tpu.utils import normalizers as jnorm

from graph_pde_tpu_torch.convert import gcn_params_from_numpy
from graph_pde_tpu_torch.experiments import registry as treg
from graph_pde_tpu_torch.experiments import runners as trun
from graph_pde_tpu_torch.graph import build_graph, NodeBatch
from graph_pde_tpu_torch.graph import lattice as tlat
from graph_pde_tpu_torch.models import gcn as tgcn
from graph_pde_tpu_torch.ops.segment import segment_degrees
from graph_pde_tpu_torch.train import (GCNTask, adam_steplr, load_bundle,
                                       make_train_step, param_leaves,
                                       save_bundle, trainable)
from graph_pde_tpu_torch.utils import normalizers as tnorm

S = 8
N = S * S
BASE = dict(width=8, ker_width=16, depth=2, in_width=6)
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


def _equal(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


_COEF = np.random.default_rng(0).uniform(1.0, 3.0, size=64)


@pytest.mark.parametrize("name,args", [
    ("simple_grid", (5, 7)),
    ("grid_edge", (5, 7)),
    ("grid_edge", (5, 7, _COEF[:35])),
    ("grid_edge1d", (9,)),
    ("grid_edge1d", (9, _COEF[:9])),
    ("grid_edge_aug", (5, 7, _COEF[:35])),
    ("grid_edge_aug_full", (5, 7, 0.3, _COEF[:35])),
    ("downsample_field", (_COEF.reshape(1, 64), 8, 2)),
    ("multi_grid", (3, 8, 8, "grid", _COEF)),
    ("multi_grid", (3, 8, 8, "grid_edge", _COEF)),
])
def test_lattice_graphs_equal_jax(name, args):
    """Every output array equal to JAX's, dtype included."""
    got, want = getattr(tlat, name)(*args), getattr(jlat, name)(*args)
    if not isinstance(want, tuple):
        got, want = (got,), (want,)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if isinstance(b, int):
            assert a == b
        else:
            _equal(a, b)


def _lattice(node_block=0, x=None):
    """(port host graph, JAX graph) of the s=8 lattice with node
    features ``x`` (zeros by default)."""
    _, ei, _ = tlat.grid_edge(S, S)
    x = np.zeros((N, 6), np.float32) if x is None else x
    args = (x, ei[0], ei[1], np.zeros((ei.shape[1], 1), np.float32))
    return (build_graph(*args, node_block=node_block),
            jgraph.build_graph(*args, node_block=node_block))


def _params(seed=0):
    jcfg = jgcn.GCNConfig(**BASE)
    jp = jgcn.gcn_init(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tgcn.GCNConfig(**BASE), jp, gcn_params_from_numpy(
        jax.tree.map(np.asarray, jp), "cpu")


def _jleaves(tree):
    return jax.tree_util.tree_leaves(jax.tree.map(np.asarray, tree))


def test_gcn_conv_matches_jax_and_dense_math():
    """One GCNConv on a random symmetric graph: against JAX's gcn_conv
    and the dense D^-1/2 (A+I) D^-1/2 X W + b (float64), as
    tests/test_models.py checks JAX's; the degrees against JAX's
    segment_degrees."""
    from graph_pde_tpu.ops.segment import segment_degrees as jdeg

    rng = np.random.default_rng(8)
    n = 7
    adj = rng.uniform(size=(n, n)) < 0.4
    adj = adj | adj.T
    np.fill_diagonal(adj, False)
    src, dst = np.where(adj)
    order = np.lexsort((src, dst))
    src, dst = src[order], dst[order]
    x = rng.normal(size=(n, 5)).astype(np.float32)
    w = rng.normal(size=(5, 4)).astype(np.float32)
    b = rng.normal(size=(4,)).astype(np.float32)
    mask = np.ones(src.size, bool)
    got = tgcn.gcn_conv(torch.from_numpy(x), torch.from_numpy(src),
                        torch.from_numpy(dst), torch.from_numpy(mask),
                        {"w": torch.from_numpy(w), "b": torch.from_numpy(b)})
    want = jgcn.gcn_conv(jnp.asarray(x), jnp.asarray(src, jnp.int32),
                         jnp.asarray(dst, jnp.int32), jnp.asarray(mask),
                         {"w": w, "b": b}, n)
    _close(got.numpy(), want)
    a_hat = adj.astype(np.float64) + np.eye(n)
    d_inv = np.diag(1.0 / np.sqrt(a_hat.sum(1)))
    ref = d_inv @ a_hat @ d_inv @ (x @ w) + b
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(
        segment_degrees(torch.from_numpy(dst), torch.from_numpy(mask),
                        n).numpy(),
        np.asarray(jdeg(jnp.asarray(dst), jnp.asarray(mask), n)))


@pytest.mark.parametrize("node_block", [0, 16])
def test_gcn_apply_matches_jax(node_block):
    """The forward on the flat and the blocked layout (its padding edges
    aggregated by the same masked index_add_): rows [:n] within 1e-4 of
    the max-abs of JAX's."""
    x = np.random.default_rng(1).normal(size=(N, 6)).astype(np.float32)
    tg, jg = _lattice(node_block, x)
    if node_block:
        assert tg.node_block == node_block and tg.edge_valid is not None
    jcfg, tcfg, jp, tp = _params()
    got = tgcn.gcn_apply(tp, tcfg, tg.to("cpu"))
    want = jgcn.gcn_apply(jp, jcfg, jax.tree.map(jnp.asarray, jg))
    assert got.shape == (tg.num_nodes_padded, 1)
    _close(got.detach().numpy()[:N], np.asarray(want)[:N])


def _batch(count=2, seed=2):
    """(port NodeBatch, JAX NodeBatch, templates, u-normalizers) of
    ``count`` samples on the blocked s=8 lattice: padded node rows of x
    and y are zero, the normalizer covers N_pad nodes."""
    tg, jg = _lattice(node_block=16)
    n_pad = tg.num_nodes_padded
    rng = np.random.default_rng(seed)
    xs = np.zeros((count, n_pad, 6), np.float32)
    ys = np.zeros((count, n_pad, 1), np.float32)
    xs[:, :N] = rng.normal(size=(count, N, 6))
    ys[:, :N, 0] = rng.normal(size=(count, N))
    u = rng.normal(size=(4, n_pad)).astype(np.float32) + 3.0
    nn = np.full((count,), N, np.int32)
    tb = NodeBatch(x=torch.from_numpy(xs), y=torch.from_numpy(ys),
                   n_node=torch.from_numpy(nn))
    jb = jgraph.NodeBatch(x=jnp.asarray(xs), y=jnp.asarray(ys),
                          n_node=jnp.asarray(nn))
    jtpl = jax.tree.map(jnp.asarray, jg)
    return tb, jb, (tg.to("cpu"), jtpl), (tnorm.UnitGaussianNormalizer(u),
                                          jnorm.UnitGaussianNormalizer(u))


def test_template_task_matches_jax():
    """GCNTask on a shared template with a 2-sample NodeBatch (the
    neurips4 layout) against JAX's GCNTask, each sample's rows [:n]
    within 1e-4; the node mask equal."""
    tb, jb, (ttpl, jtpl), _ = _batch()
    jcfg, tcfg, jp, tp = _params(seed=1)
    got = GCNTask(tcfg, template=ttpl).forward(tp, tb)
    jtask = jtasks.GCNTask(jcfg, template=jtpl)
    want = np.asarray(jtask.forward(jp, jb))
    assert got.shape == want.shape == (2, ttpl.num_nodes_padded, 1)
    for j in range(2):
        _close(got[j].detach().numpy()[:N], want[j][:N])
    np.testing.assert_array_equal(
        GCNTask(tcfg, template=ttpl).mask(tb).numpy(),
        np.asarray(jtask.mask(jb)))


def test_grads_match_jax():
    """Gradients of sum(out^2) over the template batch in every parameter
    leaf against jax.grad: 1e-4 of each leaf's max-abs."""
    tb, jb, (ttpl, jtpl), _ = _batch()
    jcfg, tcfg, jp, tp = _params(seed=2)
    p = trainable(tp, "cpu")
    (GCNTask(tcfg, template=ttpl).forward(p, tb) ** 2).sum().backward()
    jtask = jtasks.GCNTask(jcfg, template=jtpl)
    want = _jleaves(jax.grad(
        lambda q: jnp.sum(jtask.forward(q, jb) ** 2))(jp))
    got = [t.grad for t in param_leaves(p)]
    assert len(got) == len(want) == 2 * 7
    for a, b in zip(got, want):
        _close(a.numpy(), b)


def test_train_steps_match_jax():
    """Two Adam steps (weight decay 5e-4) at batch 2 under the decoded
    rel-L2 loss with a unit u-normalizer over the padded nodes: losses
    within 1e-5 relative, parameters within 1e-4 of each leaf's
    max-abs."""
    tb, jb, (ttpl, jtpl), (tn, jn) = _batch(count=4, seed=3)
    jcfg, tcfg, jp, tp = _params(seed=3)
    jtask = jtasks.GCNTask(jcfg, u_normalizer=jn, loss_type="rel2",
                           use_sample_idx=False, template=jtpl)
    ttask = GCNTask(tcfg, u_normalizer=tn, loss_type="rel2",
                    use_sample_idx=False, template=ttpl)
    jtx = joptim.adam_steplr(1e-3, weight_decay=5e-4, steps_per_epoch=2,
                             step_size_epochs=50, gamma=0.5)
    jstep = jtrainer.make_train_step(jtask, jtx)
    jstate = jtx.init(jp)
    params = trainable(tp, "cpu")
    opt, _ = adam_steplr(param_leaves(params), 1e-3, weight_decay=5e-4)
    tstep = make_train_step(ttask, opt)
    for j in (0, 2):
        jp, jstate, jm = jstep(jp, jstate, jax.tree.map(
            lambda a: a[j:j + 2], jb))
        tm = tstep(params, NodeBatch(*(a[j:j + 2] for a in (
            tb.x, tb.y, tb.n_node))))
        for k in ("loss", "l2_sum", "mse"):
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-5), k
    for a, b in zip(param_leaves(params), _jleaves(jp)):
        _close(a.detach().numpy(), b)


def test_smoke_run_matches_jax(monkeypatch):
    """neurips4_gcn's smoke run on each side from JAX's initial
    parameters (s=33 lattice, flat layout): the train and test histories
    within 1e-4 relative, the same result keys and extra; no bundle on
    either side."""
    cfg, jcfg = treg.get("neurips4_gcn"), jreg.get("neurips4_gcn")
    seen = {}

    def init(gen, c, device=None):
        seen["cfg"] = c
        jp = jgcn.gcn_init(jax.random.PRNGKey(cfg.seed),
                           jgcn.GCNConfig(**dataclasses.asdict(c)))
        return gcn_params_from_numpy(jax.tree.map(np.asarray, jp), device)

    monkeypatch.setattr(trun, "gcn_init", init)
    got = trun.run_experiment(cfg, smoke=True, device="cpu")
    want = jrun.run_experiment(jcfg, smoke=True)
    assert seen["cfg"] == tgcn.GCNConfig(width=16, ker_width=32, depth=2)
    for key in ("train_l2", "test_l2"):
        assert len(got[key]) == len(want[key]) == 2
        np.testing.assert_allclose(got[key], want[key], rtol=HIST_RTOL,
                                   atol=0, err_msg=key)
    assert got["test_epochs"] == want["test_epochs"]
    assert sorted(got) == sorted(want)
    assert got["extra"] == want["extra"] == {"family": "gcn", "s": 33,
                                             "node_block": 0}


def test_gcn_data_layout():
    """gcn_data at the smoke size: the template's N_pad and edges as JAX's
    build_graph gives them, node features [x, y, a, a_smooth, a_gradx,
    a_grady] on the first n rows, and the padded normalizer."""
    cfg = treg.get("neurips4_gcn").smoke()
    tpl, train_b, test_b, u_norm = trun.gcn_data(cfg)
    n = 33 * 33
    _, ei, _ = jlat.grid_edge(33, 33)
    jtpl = jgraph.build_graph(np.zeros((n, 6), np.float32), ei[0], ei[1],
                              np.zeros((ei.shape[1], 1), np.float32))
    for f in ("senders", "receivers", "n_node", "n_edge"):
        _equal(getattr(tpl, f), getattr(jtpl, f))
    n_pad = tpl.num_nodes_padded
    assert n_pad == jtpl.num_nodes_padded == 1096
    assert train_b.x.shape == (cfg.ntrain, n_pad, 6)
    assert test_b.y.shape == (cfg.ntest, n_pad, 1)
    assert (train_b.n_node == n).all() and not train_b.x[:, n:].any()
    np.testing.assert_array_equal(train_b.x[0, :n, :2],
                                  jlat.grid_edge(33, 33)[0])
    assert u_norm.mean.shape == (n_pad,)
    assert not u_norm.mean[n:].any() and (u_norm.std[n:] == 1).all()


def test_gcn_bundle_round_trip(tmp_path):
    """A GCN bundle (no normalizers, as the JAX runner exports none)
    saved by the port and by JAX: bundle.json alike, and load_bundle
    returns the port's params bit for bit and the config."""
    jcfg, tcfg, jp, tp = _params()
    extra = {"family": "gcn", "dataset": "darcy"}
    save_bundle(str(tmp_path / "t"), tp, tcfg, extra=extra)
    jexport.save_bundle(str(tmp_path / "j"), jp, jcfg, extra=extra)
    metas = [json.load(open(tmp_path / d / "bundle.json"))
             for d in ("t", "j")]
    assert metas[0] == metas[1]
    assert metas[0]["model_config_class"] == "GCNConfig"
    params, cfg, norms, ex = load_bundle(str(tmp_path / "t"))
    assert cfg == tcfg and norms == {} and ex == extra
    assert isinstance(params["convs"], list) and len(params["convs"]) == 4
    for a, b in zip(param_leaves(params), param_leaves(tp)):
        assert torch.equal(a, b)
