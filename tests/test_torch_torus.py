"""Port parity: the torus family and the last single-device modules of
graph_pde_tpu_torch against graph_pde_tpu, on the CPU.

Bit for bit (host numpy on both sides): the torus1d, torus2d and
Gaussian builders, the mesh methods (the boundary trio too), the
compiled cell-list builder through both packages' loaders,
TorusGridSplitter (sampleT, get_data, assemble, assembleT) from one
seed, Graph.node_mask and prefetch_to_device's batches. Within 1e-5 of
the output's max-abs: dense_sin_apply and edge_conv_gaussian (forward and
gradients). Within 1e-4: kcached_depth_loop's forward and every
gradient in float32 (1e-2 with a bf16 K, one bf16 rounding of dK in
another summation order). The torus runner's smoke run on both sides
from JAX's initial parameters: the train and per-step test histories
within 1e-4 relative."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_pde_tpu.data import datasets as jdata
from graph_pde_tpu.experiments import registry as jreg
from graph_pde_tpu.experiments import runners as jrun
from graph_pde_tpu.graph import build as jbuild
from graph_pde_tpu.graph import graph as jgraph
from graph_pde_tpu.graph import mesh as jmesh
from graph_pde_tpu.graph import native as jnative
from graph_pde_tpu.graph import splitters as jsplit
from graph_pde_tpu.models import gkn as jgkn
from graph_pde_tpu.ops import dense as jdense
from graph_pde_tpu.ops import edge_conv as jconv
from graph_pde_tpu.ops import kcached_loop as jloop

from graph_pde_tpu_torch import cli as tcli
from graph_pde_tpu_torch.convert import gkn_params_from_numpy
from graph_pde_tpu_torch.data import datasets as tdata
from graph_pde_tpu_torch.experiments import registry as treg
from graph_pde_tpu_torch.experiments import runners as trun
from graph_pde_tpu_torch.graph import build as tbuild
from graph_pde_tpu_torch.graph import graph as tgraph
from graph_pde_tpu_torch.graph import mesh as tmesh
from graph_pde_tpu_torch.graph import native as tnative
from graph_pde_tpu_torch.graph import splitters as tsplit
from graph_pde_tpu_torch.ops import dense as tdense
from graph_pde_tpu_torch.ops import edge_conv as tconv
from graph_pde_tpu_torch.ops import kcached_loop as tloop

GRAPH_FIELDS = ("x", "senders", "receivers", "edge_attr", "n_node",
                "n_edge", "y", "sample_idx", "sender_perm")


def _eq(*pairs):
    for a, b in pairs:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _close(got, want, tol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"max-abs error {err:.3g} > {tol:g} of max-abs"


def _torus_points(n=120, seed=0):
    return np.random.default_rng(seed).uniform(size=(n, 2))


@pytest.fixture
def jax_dense_torus(monkeypatch):
    """The JAX package's torus2d builder on its dense numpy path."""
    def unavailable(*a, **k):
        raise RuntimeError("native graph builder unavailable")
    monkeypatch.setattr(jnative, "native_torus2d", unavailable)


@pytest.fixture(scope="module")
def native_ok():
    if not (tnative.available() and jnative.available()):
        pytest.skip("no C++ toolchain: the compiled builder is unavailable")


def test_torus_and_gaussian_builders_match_jax(jax_dense_torus):
    pts = _torus_points()
    _eq((tbuild.torus1d_connectivity(pts[:, 0], 0.07),
         jbuild.torus1d_connectivity(pts[:, 0], 0.07)))
    _eq(*zip(tbuild._dense_torus2d(pts, 0.2),
             jbuild.torus2d_connectivity(pts, 0.2)))
    _eq((tbuild.gaussian_connectivity(pts, 0.1, np.random.default_rng(3)),
         jbuild.gaussian_connectivity(pts, 0.1, np.random.default_rng(3))))


def test_mesh_methods_match_jax():
    args = ([[0, 1], [0, 1]], [7, 7])
    t, j = tmesh.SquareMeshGenerator(*args), jmesh.SquareMeshGenerator(*args)
    _eq((t.gaussian_connectivity(0.2, np.random.default_rng(1)),
         j.gaussian_connectivity(0.2, np.random.default_rng(1))))
    theta = np.random.default_rng(2).normal(size=(49, 2))
    _eq((t.attributes(theta=theta), j.attributes(theta=theta)),
        (t.get_boundary(), j.get_boundary()))
    for stride in (1, 3):
        _eq((t.boundary_connectivity2d(stride),
             j.boundary_connectivity2d(stride)),
            (t.attributes_boundary(theta=theta),
             j.attributes_boundary(theta=theta)))
    assert t.n_edges_boundary == j.n_edges_boundary
    args = ([[0, 1]], [40], 25)
    t = tmesh.RandomMeshGenerator(*args, seed=5)
    j = jmesh.RandomMeshGenerator(*args, seed=5)
    _eq((t.sample(), j.sample()),
        (t.torus1d_connectivity(0.1), j.torus1d_connectivity(0.1)),
        (t.attributes(), j.attributes()),
        (t.gaussian_connectivity(0.05), j.gaussian_connectivity(0.05)),
        (t.sample(), j.sample()))
    assert t.n_edges == j.n_edges


def test_native_loader_matches_jax(native_ok):
    """The port's library (built into its own _build/) against the JAX
    package's, and the sorted edges against cKDTree and dense numpy."""
    assert tnative.library_path().parent.name == "_build"
    rng = np.random.default_rng(6)
    for d in (1, 2, 3):
        pts = rng.uniform(size=(150, d))
        _eq(*zip(tnative.native_radius(pts, None, 0.15),
                 jnative.native_radius(pts, None, 0.15)))
        got = tbuild.radius_connectivity(pts, 0.15)
        _eq((got, tbuild.radius_connectivity(pts, 0.15, method="dense")),
            (got, jbuild.radius_connectivity(pts, 0.15)))
        src, dst = tbuild._tree_radius(pts, None, 0.15)
        order = np.lexsort((dst, src))
        _eq((got, np.stack([src[order], dst[order]])))
    a, b = rng.uniform(size=(80, 2)), rng.uniform(size=(50, 2))
    _eq(*zip(tnative.native_radius(a, b, 0.3),
             jnative.native_radius(a, b, 0.3)))
    _eq((tbuild.radius_connectivity(a, 0.3, points_b=b),
         jbuild.radius_connectivity(a, 0.3, points_b=b, method="dense")))
    pts = _torus_points(200, 7)
    _eq(*zip(tnative.native_torus2d(pts, 0.15),
             jnative.native_torus2d(pts, 0.15)))
    _eq(*zip(tbuild.torus2d_connectivity(pts, 0.15),
             tbuild._dense_torus2d(pts, 0.15)))


def test_native_build_is_atomic(native_ok, tmp_path, monkeypatch):
    """A build into an empty directory leaves only the hashed library
    (the temporary file renamed into place), and reuses it after."""
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path)
    path = tnative.build()
    assert path.parent == tmp_path and path.exists()
    assert [p.name for p in tmp_path.iterdir()] == [path.name]
    mtime = path.stat().st_mtime_ns
    assert tnative.build() == path and path.stat().st_mtime_ns == mtime


def _torus_splitters(res=12, r=2, radius=0.25, T=3, seed=4):
    grid = jmesh.make_box_grid([[0, 1], [0, 1]], [res, res]) * (res - 1) / res
    kw = dict(r=r, m=(-(-res // r)) ** 2, radius=radius, T=T, seed=seed)
    return (tsplit.TorusGridSplitter(grid, res, **kw),
            jsplit.TorusGridSplitter(grid, res, **kw))


def _same_graph(tg, jg):
    _eq(*((getattr(tg, f), getattr(jg, f)) for f in GRAPH_FIELDS))


def test_torus_splitter_matches_jax():
    res, T = 12, 3
    tsp, jsp = _torus_splitters(res, T=T)
    rng = np.random.default_rng(8)
    theta = rng.normal(size=(res * res, 1)).astype(np.float32)
    y = rng.normal(size=(T, res * res)).astype(np.float32)
    for _ in range(3):
        (tg, txy), (jg, jxy) = tsp.sampleT(theta, y), jsp.sampleT(theta, y)
        assert txy == jxy and tg.y.shape[1] == T
        _same_graph(tg, jg)
    tshards, jshards = tsp.get_data(theta), jsp.get_data(theta)
    assert len(tshards) == 4
    for (tg, txy), (jg, jxy) in zip(tshards, jshards):
        assert txy == jxy
        _same_graph(tg, jg)
    xys = [xy for _, xy in tshards]
    preds = [rng.normal(size=(int(g.n_node), T)).astype(np.float32)
             for g, _ in tshards]
    _eq((tsp.assembleT(preds, xys, sigma=0.5),
         jsp.assembleT(preds, xys, sigma=0.5)),
        (tsp.assemble([p[:, 0] for p in preds], xys),
         jsp.assemble([p[:, 0] for p in preds], xys)))


def test_node_mask_matches_jax():
    rng = np.random.default_rng(9)
    graphs = []
    for n in (10, 17):
        e = 40
        graphs.append(((rng.normal(size=(n, 3)), rng.integers(0, n, e),
                        rng.integers(0, n, e), rng.normal(size=(e, 2))),
                       dict(n_node_pad=24)))
    tgs = [tgraph.build_graph(*a, **k) for a, k in graphs]
    jgs = [jgraph.build_graph(*a, **k) for a, k in graphs]
    _eq((tgs[0].to("cpu").node_mask().numpy(), jgs[0].node_mask()))
    jstack = jgraph.stack_graphs(jgs)
    _eq((tgraph.stack_graphs(tgs).to("cpu").node_mask().numpy(),
         jax.vmap(lambda g: g.node_mask())(jstack)))


def test_prefetch_to_device_matches_jax():
    rng = np.random.default_rng(10)
    stacked = {"a": rng.normal(size=(7, 3)).astype(np.float32),
               "b": rng.integers(0, 9, size=(7, 2))}
    order = np.random.default_rng(1)
    tb = list(tdata.prefetch_to_device(
        tdata.batch_iterator(stacked, 2, order), size=2, device="cpu"))
    order = np.random.default_rng(1)
    jb = list(jdata.prefetch_to_device(
        jdata.batch_iterator(stacked, 2, order), size=2))
    assert len(tb) == len(jb) == 3
    for t, j in zip(tb, jb):
        assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu"
                   for v in t.values())
        # jax.device_put narrows int64 to int32 (x64 off); the values
        # are the same
        for k in ("a", "b"):
            np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]))
        assert t["a"].dtype == torch.float32
    with pytest.raises(RuntimeError, match="no CUDA"):
        next(tdata.prefetch_to_device(iter([stacked])))
    # with a sharding (a function from a batch to this rank's part, as
    # functools.partial(parallel.batch_sharding, mesh) is), each batch is
    # cut on the host before its copy: the second half of each batch
    order = np.random.default_rng(1)
    part = list(tdata.prefetch_to_device(
        tdata.batch_iterator(stacked, 2, order), size=2, device="cpu",
        sharding=lambda b: tdata.map_arrays(lambda a: a[a.shape[0] // 2:],
                                            b)))
    assert len(part) == len(tb)
    for p, t in zip(part, tb):
        for k in ("a", "b"):
            n = t[k].shape[0]
            np.testing.assert_array_equal(p[k].numpy(),
                                          t[k][n // 2:].numpy())


def _dense_params(layers, seed):
    jp = jdense.dense_init(jax.random.PRNGKey(seed), layers)
    return jp, gkn_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def test_dense_sin_apply_matches_jax():
    jp, tp = _dense_params((3, 16, 16, 2), 11)
    x = np.random.default_rng(11).normal(size=(50, 3)).astype(np.float32)
    _close(tdense.dense_sin_apply(tp, torch.as_tensor(x)).numpy(),
           jdense.dense_sin_apply(jp, jnp.asarray(x)), 1e-5)


@pytest.mark.parametrize("aggr,with_root", [("mean", True), ("add", False)])
def test_edge_conv_gaussian_matches_jax(aggr, with_root):
    rng = np.random.default_rng(12)
    n, e, w = 30, 200, 8
    args = (rng.normal(size=(n, w)), rng.integers(0, n, e),
            rng.integers(0, n, e), rng.uniform(0.1, 1.0, size=(e, 3)))
    jg, tg = jgraph.build_graph(*args), tgraph.build_graph(*args).to("cpu")
    jell, tell = _dense_params((1, 8, w), 12)
    root = 0.3 * rng.normal(size=(w, w)).astype(np.float32)
    bias = rng.normal(size=(w,)).astype(np.float32)
    cot = rng.normal(size=(tg.num_nodes_padded, w)).astype(np.float32)

    def jf(x, ell, root, bias):
        out = jconv.edge_conv_gaussian(
            x, jg.senders, jg.receivers, jg.edge_attr, jg.edge_mask(), ell,
            aggr=aggr, root=root if with_root else None, bias=bias)
        return jnp.sum(out * cot), out

    (_, jout), jgr = jax.value_and_grad(jf, argnums=(0, 1, 2, 3),
                                        has_aux=True)(
        jnp.asarray(jg.x), jell, jnp.asarray(root), jnp.asarray(bias))
    x = torch.as_tensor(np.asarray(jg.x)).requires_grad_(True)
    tr = torch.as_tensor(root).requires_grad_(True)
    tb = torch.as_tensor(bias).requires_grad_(True)
    tell = [{k: v.requires_grad_(True) for k, v in p.items()} for p in tell]
    out = tconv.edge_conv_gaussian(
        x, tg.senders, tg.receivers, tg.edge_attr, tg.edge_mask(), tell,
        aggr=aggr, root=tr if with_root else None, bias=tb)
    (out * torch.as_tensor(cot)).sum().backward()
    _close(out.detach().numpy(), jout, 1e-5)
    _close(x.grad.numpy(), jgr[0], 1e-5)
    for tp, jp in zip(tell, jgr[1]):
        _close(tp["w"].grad.numpy(), jp["w"], 1e-5)
        _close(tp["b"].grad.numpy(), jp["b"], 1e-5)
    if with_root:
        _close(tr.grad.numpy(), jgr[2], 1e-5)
    _close(tb.grad.numpy(), jgr[3], 1e-5)


@pytest.mark.parametrize("aggr,root,bias,relu_last,k_dtype", [
    ("mean", True, True, True, "float32"),
    ("mean", False, False, False, "float32"),
    ("add", True, False, True, "float32"),
    ("add", False, True, False, "float32"),
    ("mean", True, True, False, "bfloat16"),
])
def test_kcached_depth_loop_matches_jax(aggr, root, bias, relu_last,
                                        k_dtype):
    rng = np.random.default_rng(13)
    n, e, w, depth = 40, 600, 8, 3
    jg = jgraph.build_graph(rng.normal(size=(n, 2)), rng.integers(0, n, e),
                            rng.integers(0, n, e), rng.normal(size=(e, 2)))
    x = rng.normal(size=(jg.x.shape[0], w)).astype(np.float32)
    kk = (0.3 * rng.normal(size=(jg.senders.shape[0], w * w))
          ).astype(np.float32)
    rt = (0.3 * rng.normal(size=(w, w))).astype(np.float32)
    bs = rng.normal(size=(w,)).astype(np.float32)
    cot = rng.normal(size=x.shape).astype(np.float32)
    kw = dict(depth=depth, width=w, aggr=aggr, relu_last=relu_last)
    tol = 1e-4 if k_dtype == "float32" else 1e-2
    jdt = jnp.bfloat16 if k_dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if k_dtype == "bfloat16" else torch.float32
    mask = np.array(jg.edge_mask())

    def jf(x, kk, rt, bs):
        return jloop.kcached_depth_loop(
            x, kk, rt if root else None, bs if bias else None, jg.senders,
            jg.receivers, jnp.asarray(mask), **kw)

    jout, vjp = jax.vjp(jf, jnp.asarray(x), jnp.asarray(kk).astype(jdt),
                        jnp.asarray(rt), jnp.asarray(bs))
    jgr = vjp(jnp.asarray(cot))
    tx = torch.as_tensor(x).requires_grad_(True)
    tk = torch.as_tensor(kk).to(tdt).requires_grad_(True)
    tr = torch.as_tensor(rt).requires_grad_(True)
    tb = torch.as_tensor(bs).requires_grad_(True)
    out = tloop.kcached_depth_loop(
        tx, tk, tr if root else None, tb if bias else None,
        torch.as_tensor(np.asarray(jg.senders)).long(),
        torch.as_tensor(np.asarray(jg.receivers)).long(),
        torch.as_tensor(mask), **kw)
    out.backward(torch.as_tensor(cot))
    assert tk.grad.dtype == tdt
    _close(out.detach().numpy(), jout, 1e-4)
    _close(tx.grad.numpy(), jgr[0], tol)
    _close(tk.grad.float().numpy(), np.asarray(jgr[1], np.float32), tol)
    if root:
        _close(tr.grad.numpy(), jgr[2], tol)
    if bias:
        _close(tb.grad.numpy(), jgr[3], tol)


def test_torus_smoke_run_matches_jax(monkeypatch):
    """The port's runner from JAX's initial parameters: the data, shard,
    shuffle and evaluation streams are the JAX runner's, so the
    histories agree to float32 sums in another order."""
    cfg = treg.get("grain_torus_timeseries")
    tm = trun.torus_model_config(cfg.smoke())
    jp = jgkn.gkn_init(jax.random.PRNGKey(cfg.seed),
                       jgkn.GKNConfig(**dataclasses.asdict(tm)))
    tp = gkn_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    monkeypatch.setattr(trun, "gkn_init", lambda gen, c, device=None: tp)
    got = trun.run_experiment(cfg, smoke=True, device="cpu")
    want = jrun.run_experiment(jreg.get("grain_torus_timeseries"),
                               smoke=True)
    assert sorted(got) == sorted(want)
    for key in ("train_l2", "test_l2_per_step"):
        assert len(got[key]) == len(want[key])
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=0,
                                   err_msg=key)
    assert got["final_test_l2"] == pytest.approx(want["final_test_l2"],
                                                 rel=1e-4)


def test_torus_cli_smoke_run(tmp_path, capsys):
    assert tcli.main(["run", "grain_torus_timeseries", "--smoke",
                      "--device", "cpu"]) == 0
    assert '"final_test_l2"' in capsys.readouterr().out
    # the runner exports no bundle: JAX's exit code and message
    assert tcli.main(["run", "grain_torus_timeseries", "--smoke",
                      "--device", "cpu", "--set", "epochs=1",
                      "--bundle", str(tmp_path / "b")]) == 2
    assert "'torus_t' runner exports no bundle" in capsys.readouterr().err
