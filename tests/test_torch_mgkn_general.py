"""Port parity, the general MGKN: the multilevel graph, the multi-mesh
generators and splitter, the Darcy MGKN data, the model in its three
variants, gradients, train steps, the predictor, bundle.json and the
runner of graph_pde_tpu_torch against graph_pde_tpu, on the CPU (the
port's kernel wrappers take their plain versions; JAX's impl='pallas'
runs its Pallas kernels in interpret mode).

Small shapes (as the JAX package's own tests/test_models.py): s=16,
points (24, 12, 6) (three levels), width 8, ker_width 16, depth 2, on
synthetic Darcy data. Parameters are JAX's, carried over as numpy.
Host arrays (graphs, generators, splitter, datasets) must be equal to
JAX's bit for bit; model tolerances are stated where they are used."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_pde_tpu import inference as jinf
from graph_pde_tpu.data import datasets as jdata
from graph_pde_tpu.experiments import registry as jreg
from graph_pde_tpu.experiments import runners as jrun
from graph_pde_tpu.graph import graph as jgraph
from graph_pde_tpu.graph import mesh as jmesh
from graph_pde_tpu.graph import splitters as jsplit
from graph_pde_tpu.models import mgkn_general as jmg
from graph_pde_tpu.train import export as jexport
from graph_pde_tpu.train import optim as joptim
from graph_pde_tpu.train import tasks as jtasks
from graph_pde_tpu.train import trainer as jtrainer

from graph_pde_tpu_torch.convert import mgkn_general_params_from_numpy
from graph_pde_tpu_torch.data import datasets as tdata
from graph_pde_tpu_torch.data import synthetic as tsyn
from graph_pde_tpu_torch.experiments import registry as treg
from graph_pde_tpu_torch.experiments import runners as trun
from graph_pde_tpu_torch.graph import graph as tgraph
from graph_pde_tpu_torch.graph import mesh as tmesh
from graph_pde_tpu_torch.graph import splitters as tsplit
from graph_pde_tpu_torch.inference import MGKNGeneralPredictor
from graph_pde_tpu_torch.models import mgkn_general as tmg
from graph_pde_tpu_torch.ops.fused_edge_conv import (fused_edge_messages,
                                                     fused_edge_messages_bwd)
from graph_pde_tpu_torch.train import (MGKNGeneralTask, adam_steplr,
                                       load_bundle, load_meta,
                                       make_train_step, param_leaves,
                                       save_bundle, trainable)

S = 16
POINTS = (24, 12, 6)
R_INNER = (0.25, 0.5, 1.0)
R_INTER = (0.125, 0.25)
BASE = dict(width=8, ker_width=16, depth=2, points=POINTS)
# float32 through two V-cycles' sums in other orders: 1e-4 of the
# output's max-abs, and 1e-5 absolute plus 1e-4 relative elementwise
MODEL_TOL = 1e-4
# bf16 kappa and K, or fp8 K: the same roundings on both sides, float32
# sums in other orders (an ulp flip where a value lands on a rounding
# boundary), as the orthogonal and GKN fp8 tests
LOW_TOL = 5e-3
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


def _equal_graphs(t, j):
    """Every field of a port host MultiLevelGraph equal to JAX's, dtype
    included; the static tuples equal."""
    for f in dataclasses.fields(t):
        a, b = getattr(t, f.name), getattr(j, f.name)
        if f.name in ("points", "mid_ranges", "down_ranges", "up_ranges"):
            assert tuple(a) == tuple(b), f.name
        elif b is None:
            assert a is None, f.name
        else:
            b = np.asarray(b)
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name


@pytest.fixture(scope="module")
def arrays():
    fields = tsyn.darcy_dataset(4, S, seed=7)
    ta, norms = tdata.prepare_darcy(fields, n=4)
    ja, _ = jdata.prepare_darcy(fields, n=4)
    for k in ("a", "a_smooth", "a_gradx", "a_grady", "u"):
        setattr(ja, k, getattr(ta, k))   # the same encoded arrays
    return ta, ja, norms


@pytest.fixture(scope="module")
def graphs(arrays):
    """(port host graphs, JAX graphs) of the four samples."""
    ta, ja, _ = arrays
    kw = dict(points=POINTS, radius_inner=R_INNER, radius_inter=R_INTER,
              seed=3)
    tg, tcaps = tdata.darcy_mgkn_graphs(ta, **kw)
    jg, jcaps = jdata.darcy_mgkn_graphs(ja, **kw)
    assert tcaps == jcaps
    return tg, jax.tree_util.tree_map(jnp.asarray, jg)


def _gen_pair(cls_name, *args, **kw):
    return (getattr(tmesh, cls_name)(*args, **kw),
            getattr(jmesh, cls_name)(*args, **kw))


def _multi_edges(gen, level):
    idx, _ = gen.sample()
    gen.ball_connectivity(R_INNER[:level], R_INTER[:level - 1])
    attr, attr_down, attr_up = gen.attributes(
        theta=np.linspace(0.0, 1.0, gen.n))
    rm, rd, ru = gen.get_edge_index_range()
    return (idx, [attr[a:b] for a, b in rm], [attr_down[a:b] for a, b in rd],
            [attr_up[a:b] for a, b in ru])


@pytest.mark.parametrize("level", [3, 1])
def test_build_multilevel_graph_matches_jax(level):
    """A three-level graph (default capacities, and capacities grown by
    256 per level) and a single-level one (zero-size down and up
    placeholders), built from the generator's edges on both sides."""
    pts = POINTS[:level]
    tgen, jgen = _gen_pair("RandomMultiMeshGenerator", [[0, 1], [0, 1]],
                           [S, S], level=level, sample_sizes=list(pts),
                           seed=1)
    idx, mid_a, down_a, up_a = _multi_edges(tgen, level)
    _multi_edges(jgen, level)
    x = np.random.default_rng(0).normal(size=(sum(pts), 3))
    args = (x, pts, tgen.edge_index, mid_a, tgen.edge_index_down, down_a,
            tgen.edge_index_up, up_a)
    kw = dict(y=np.arange(pts[0], dtype=np.float32), sample_idx=idx[0])
    _equal_graphs(tgraph.build_multilevel_graph(*args, **kw),
                  jgraph.build_multilevel_graph(*args, **kw))
    if level == 1:
        g = tgraph.build_multilevel_graph(*args)
        assert g.down_senders.shape == (0,) and g.down_attr.shape == (0, 6)
        assert g.down_ranges == g.up_ranges == ()
        return
    g = tgraph.build_multilevel_graph(*args)
    caps = tuple(tuple(r1 - r0 + 256 for r0, r1 in rs)
                 for rs in (g.mid_ranges, g.down_ranges, g.up_ranges))
    ckw = dict(kw, mid_caps=caps[0], down_caps=caps[1], up_caps=caps[2])
    big = tgraph.build_multilevel_graph(*args, **ckw)
    _equal_graphs(big, jgraph.build_multilevel_graph(*args, **ckw))
    # padding parks on the level's last local node (mid) or the last
    # global node (down, up), masked out
    r0, r1 = big.mid_ranges[1]
    e1 = int(big.mid_mask[r0:r1].sum())
    assert (big.mid_receivers[r0 + e1:r1] == POINTS[1] - 1).all()
    r0, r1 = big.up_ranges[0]
    e0 = int(big.up_mask[r0:r1].sum())
    assert (big.up_receivers[r0 + e0:r1] == sum(POINTS) - 1).all()
    assert tgraph.pad_capacities([(3, 9), (5, 2)]) == \
        jgraph.pad_capacities([(3, 9), (5, 2)]) == (5, 9)


def test_generators_match_jax():
    """RandomTwoMeshGenerator and RandomMultiMeshGenerator: the same
    seed gives the same permutations, edges, ranges and attributes, over
    two draws."""
    tgen, jgen = _gen_pair("RandomTwoMeshGenerator", [[0, 1], [0, 1]],
                           [S, S], sample_size=30, induced_point=10, seed=2)
    theta = np.linspace(0.0, 1.0, S * S)
    for _ in range(2):
        for a, b in zip(tgen.sample(), jgen.sample()):
            assert np.array_equal(a, b)
        for a, b in zip(tgen.get_grid(), jgen.get_grid()):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        for a, b in zip(tgen.ball_connectivity(0.2, 0.3, 0.4),
                        jgen.ball_connectivity(0.2, 0.3, 0.4)):
            assert np.array_equal(a, b)
        for a, b in zip(tgen.attributes(theta), jgen.attributes(theta)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    tgen, jgen = _gen_pair("RandomMultiMeshGenerator", [[0, 1], [0, 1]],
                           [S, S], level=3, sample_sizes=list(POINTS),
                           seed=4)
    for _ in range(2):
        (ti, tall), (ji, jall) = tgen.sample(), jgen.sample()
        assert np.array_equal(tall, jall)
        assert all(np.array_equal(a, b) for a, b in zip(ti, ji))
        for a, b in zip(tgen.ball_connectivity(R_INNER, R_INTER),
                        jgen.ball_connectivity(R_INNER, R_INTER)):
            assert np.array_equal(a, b)
        for a, b in zip(tgen.get_edge_index_range(),
                        jgen.get_edge_index_range()):
            assert np.array_equal(a, b)
        for a, b in zip(tgen.attributes(theta), jgen.attributes(theta)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert tgen.n_edges_inner == jgen.n_edges_inner
        assert tgen.n_edges_inter == jgen.n_edges_inter


def test_splitter_matches_jax():
    """RandomMultiMeshSplitter: the ring windows (wrapping, a whole
    turn, two turns), the split graphs field by field, caps treated as
    minimums, and the assembler."""
    kw = dict(real_space=[[0, 1], [0, 1]], mesh_size=[S, S], level=3,
              sample_sizes=list(POINTS), seed=5)
    tsp, jsp = tsplit.RandomMultiMeshSplitter(**kw), \
        jsplit.RandomMultiMeshSplitter(**kw)
    assert tsp.splits == jsp.splits == -(-S * S // POINTS[0])
    tsp.sample()
    jsp.sample()
    n = S * S
    for start, count in ((250, 20), (0, n), (7, 2 * n), (n - 3, 3), (5, 0)):
        assert np.array_equal(tsp._ring_window(start, count),
                              jsp._ring_window(start, count))
    assert np.array_equal(np.sort(tsp._ring_window(7, 2 * n)), np.arange(n))
    rng = np.random.default_rng(1)
    theta_a = rng.normal(size=n)
    theta_all = rng.normal(size=(n, 4))
    caps = None
    for big in (None, ((4096, 256, 256), (256, 256), (256, 256))):
        tgs, tcaps = tsp.splitter(R_INNER, R_INTER, theta_a, theta_all,
                                  caps=big or caps)
        jgs, jcaps = jsp.splitter(R_INNER, R_INTER, theta_a, theta_all,
                                  caps=big or caps)
        assert tcaps == jcaps and len(tgs) == len(jgs) == tsp.splits
        for t, j in zip(tgs, jgs):
            _equal_graphs(t, j)
        caps = tcaps
    assert tcaps[0][0] == 4096 and tcaps[0][1] >= 256
    small = ((256,) * 3, (256,) * 2, (256,) * 2)
    tgs, grown = tsp.splitter(R_INNER, R_INTER, theta_a, theta_all,
                              caps=small)
    assert all(g >= s for a, b in zip(grown, small) for g, s in zip(a, b))
    assert grown == jsp.splitter(R_INNER, R_INTER, theta_a, theta_all,
                                 caps=small)[1]
    outs = [rng.normal(size=POINTS[0]) for _ in tgs]
    idxs = [g.sample_idx for g in tgs]
    full = tsp.assembler(outs, idxs)
    assert np.array_equal(full, jsp.assembler(outs, idxs))
    # the finest levels tile every grid node
    assert np.array_equal(np.unique(np.concatenate(idxs)), np.arange(n))


def test_darcy_mgkn_graphs_matches_jax(arrays, graphs):
    """The stacked training graphs field by field, and caps treated as
    minimums for a second sample set (k=2 draws per sample)."""
    ta, ja, _ = arrays
    tg, _ = graphs
    jg, _ = jdata.darcy_mgkn_graphs(ja, points=POINTS, radius_inner=R_INNER,
                                    radius_inter=R_INTER, seed=3)
    _equal_graphs(tg, jg)
    assert tg.x.shape == (4, sum(POINTS), 6) and tg.y.shape == (4, 24, 1)
    caps = ((1024, 256, 256), (256, 256), (256, 256))
    kw = dict(points=POINTS, radius_inner=R_INNER, radius_inter=R_INTER,
              k=2, seed=6, caps=caps)
    t2, tcaps = tdata.darcy_mgkn_graphs(ta, **kw)
    j2, jcaps = jdata.darcy_mgkn_graphs(ja, **kw)
    assert tcaps == jcaps and tcaps[0][0] == 1024
    assert t2.x.shape[0] == 8
    _equal_graphs(t2, j2)


def _cfgs(**kw):
    base = dict(BASE, **kw)
    return jmg.MGKNGeneralConfig(**base), tmg.MGKNGeneralConfig(**base)


def _params(jcfg, seed=0):
    jp = jmg.mgkn_general_init(jax.random.PRNGKey(seed), jcfg)
    return jp, mgkn_general_params_from_numpy(jax.tree.map(np.asarray, jp),
                                              "cpu")


def _jleaves(tree):
    return jax.tree_util.tree_leaves(jax.tree.map(np.asarray, tree))


@pytest.mark.parametrize("variant", ["mkgn", "induced", "single"])
def test_config_and_init_match_jax(variant):
    jcfg, tcfg = _cfgs(variant=variant)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert dataclasses.asdict(jmg.MGKNGeneralConfig()) == \
        dataclasses.asdict(tmg.MGKNGeneralConfig())
    assert tcfg.level == jcfg.level == 3
    assert tcfg.offsets() == jcfg.offsets() == (0, 24, 36, 42)
    jp = jmg.mgkn_general_init(jax.random.PRNGKey(0), jcfg)
    tp = tmg.mgkn_general_init(torch.Generator().manual_seed(0), tcfg,
                               device="cpu")
    tshapes = jax.tree.map(lambda t: tuple(t.shape), tp)
    jshapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    assert jax.tree_util.tree_structure(tshapes) == \
        jax.tree_util.tree_structure(jshapes)
    assert jax.tree_util.tree_leaves(tshapes) == \
        jax.tree_util.tree_leaves(jshapes)
    # mid kappas two hidden layers, down/up one; widths halve per level
    assert [len(c["kernel"]) for c in tp["conv_mid"]] == [3, 3, 3]
    assert [len(c["kernel"]) for c in tp["conv_down"]] == [2, 2]
    assert [c["kernel"][0]["w"].shape[1] for c in tp["conv_mid"]] == \
        [16, 8, 4]
    assert [c["kernel"][0]["w"].shape[1] for c in tp["conv_up"]] == [8, 4]
    assert all(("root" in c) == (variant == "mkgn") for c in tp["conv_mid"])
    assert float(tp["fc_in"]["w"].abs().max()) <= 1 / np.sqrt(6)


def test_init_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmg.mgkn_general_init(torch.Generator(), _cfgs()[1])


@pytest.mark.parametrize("impl", ["reference", "pallas", "kcached"])
@pytest.mark.parametrize("variant", ["mkgn", "induced", "single"])
def test_apply_matches_jax(graphs, variant, impl):
    """Batched and single-graph forwards of each variant on
    impl='reference', 'pallas' (JAX: the Pallas kernels in interpret
    mode; the port: K1's plain version) and 'kcached' (float32 K)."""
    jcfg, tcfg = _cfgs(variant=variant, impl=impl)
    jp, tp = _params(jcfg)
    tg, jg = graphs
    before = fused_edge_messages.launches
    got = tmg.mgkn_general_apply_batched(tp, tcfg, tg.to("cpu"))
    want = jax.jit(lambda q, g: jmg.mgkn_general_apply_batched(
        q, jcfg, g))(jp, jg)
    assert got.shape == (4, POINTS[0], 1)
    _close(got.detach().numpy(), want)
    one = tmg.mgkn_general_apply(
        tp, tcfg, tdata.map_arrays(lambda a: a[2], tg).to("cpu"))
    _close(one.detach().numpy(), np.asarray(want)[2])
    assert fused_edge_messages.launches == before   # CPU: plain versions


@pytest.mark.parametrize("dtype,k_storage", [("bfloat16", None),
                                             (None, "float8_e4m3"),
                                             ("bfloat16", "float8_e4m3")])
def test_kcached_bf16_and_fp8_match_jax(graphs, dtype, k_storage):
    """kcached with bf16 kappa and K, fp8 e4m3 storage of K, and both:
    within LOW_TOL of the max-abs."""
    jcfg, tcfg = _cfgs(impl="kcached", compute_dtype=dtype,
                       k_storage=k_storage)
    jp, tp = _params(jcfg, seed=1)
    tg, jg = graphs
    got = tmg.mgkn_general_apply_batched(tp, tcfg, tg.to("cpu"))
    want = jax.jit(lambda q, g: jmg.mgkn_general_apply_batched(
        q, jcfg, g))(jp, jg)
    _close(got.detach().numpy(), want, LOW_TOL)


@pytest.mark.parametrize("variant", ["mkgn", "induced"])
def test_grads_match_jax(graphs, variant):
    """Gradients of sum(out^2) in every parameter leaf under
    impl='pallas' (the port's K1 and B1-bwd plain versions against JAX's
    Pallas custom_vjp in interpret mode): 1e-4 of each leaf's max-abs.
    The slice updates must leave every saved tensor intact. One V-cycle
    (depth 1) runs every conv and slice update once; interpret mode
    makes each more costly."""
    jcfg, tcfg = _cfgs(variant=variant, impl="pallas", depth=1)
    jp, tp = _params(jcfg, seed=2)
    tg, jg = graphs
    p = trainable(tp, "cpu")
    before = fused_edge_messages_bwd.launches
    (tmg.mgkn_general_apply_batched(p, tcfg, tg.to("cpu")) ** 2).sum() \
        .backward()
    assert fused_edge_messages_bwd.launches == before
    jgr = jax.jit(jax.grad(lambda q: jnp.sum(
        jmg.mgkn_general_apply_batched(q, jcfg, jg) ** 2)))(jp)
    want = _jleaves(jgr)
    got = [t.grad for t in param_leaves(p)]
    n_root = 3 if variant == "mkgn" else 0
    assert len(got) == len(want) == 2 + 2 * 4 * 2 + 6 * 3 + n_root + 4
    for a, b in zip(got, want):
        _close(a.numpy(), b)


@pytest.mark.parametrize("variant", ["mkgn", "single"])
def test_train_steps_match_jax(arrays, graphs, variant):
    """Two Adam steps at batch 2 under the decoded rel-L2 loss from the
    same parameters: losses within 1e-5 relative, parameters within 1e-4
    of each leaf's max-abs (tests/test_torch_train.py says why Adam keeps
    that bound). Under 'single' the forward reaches only K_00: the other
    leaves get zero gradients in JAX, and weight decay and Adam still
    move them, in both packages."""
    ta, ja, _ = arrays
    jcfg, tcfg = _cfgs(impl="reference", variant=variant)
    jp, tp = _params(jcfg, seed=3)
    tg, jg = graphs
    tg = tg.to("cpu")
    jtask = jtasks.MGKNGeneralTask(jcfg, u_normalizer=ja.u_normalizer)
    ttask = MGKNGeneralTask(tcfg, u_normalizer=ta.u_normalizer)
    jtx = joptim.adam_steplr(1e-3, weight_decay=5e-4, steps_per_epoch=2,
                             step_size_epochs=50, gamma=0.5)
    jstep = jtrainer.make_train_step(jtask, jtx)
    jstate = jtx.init(jp)
    params = trainable(tp, "cpu")
    opt, _ = adam_steplr(param_leaves(params), 1e-3, weight_decay=5e-4)
    tstep = make_train_step(ttask, opt)
    for j in (0, 2):
        jb = jax.tree_util.tree_map(lambda a: a[j:j + 2], jg)
        tb = tdata.map_arrays(lambda a: a[j:j + 2], tg)
        jp, jstate, jm = jstep(jp, jstate, jb)
        tm = tstep(params, tb)
        assert float(tm["batch"]) == 2.0
        for k in ("loss", "l2_sum", "mse"):
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-5), k
    for a, b in zip(param_leaves(params), _jleaves(jp)):
        _close(a.detach().numpy(), b)


def test_predictor_matches_jax(arrays):
    """MGKNGeneralPredictor on fresh fields at the training s: the
    splitter windows, each window's forward, the per-window decode with
    its points' unit stats and the assembler, against JAX's; another
    resolution refused for the unit u-normalizer."""
    ta, ja, norms = arrays
    jcfg, tcfg = _cfgs(impl="kcached")
    jp, tp = _params(jcfg, seed=4)
    inputs = {k: norms[k] for k in ("a", "a_smooth", "a_gradx", "a_grady")}
    jnorms = jdata.prepare_darcy(tsyn.darcy_dataset(4, S, seed=7), n=4)[1]
    kw = dict(radius_inner=R_INNER, radius_inter=R_INTER)
    jpred = jinf.MGKNGeneralPredictor(jp, jcfg, input_normalizers=jnorms,
                                      u_normalizer=ja.u_normalizer, **kw)
    tpred = MGKNGeneralPredictor(tp, tcfg, input_normalizers=inputs,
                                 u_normalizer=ta.u_normalizer, device="cpu",
                                 **kw)
    coeff = tsyn.darcy_dataset(2, S, seed=9)["coeff"]
    got, want = tpred.predict(coeff), np.asarray(jpred.predict(coeff))
    assert got.shape == (2, S * S)
    _close(got, want)
    with pytest.raises(ValueError, match="per-node stats"):
        tpred.predict(np.ones((1, 9, 9), np.float32))


def test_bundle_json_matches_jax(arrays, tmp_path):
    ta, ja, norms = arrays
    jcfg, tcfg = _cfgs(variant="induced", compute_dtype="bfloat16",
                       k_storage="float8_e4m3")
    jp, tp = _params(jcfg)
    extra = {"family": "mgkn_general", "experiment": "x",
             "dataset": "darcy", "radius_inner": list(R_INNER),
             "radius_inter": list(R_INTER), "train_s": S}
    jexport.save_bundle(str(tmp_path / "j"), jp, jcfg,
                        normalizers={"u": ja.u_normalizer}, extra=extra)
    save_bundle(str(tmp_path / "t"), tp, tcfg,
                normalizers={"u": ta.u_normalizer}, extra=extra)
    metas = [json.load(open(tmp_path / d / "bundle.json"))
             for d in ("j", "t")]
    assert metas[0]["model_config_class"] == metas[1]["model_config_class"] \
        == "MGKNGeneralConfig"
    assert metas[0]["model_config"] == metas[1]["model_config"]
    assert metas[0]["extra"] == metas[1]["extra"] == extra
    jn, tn = metas[0]["normalizers"]["u"], metas[1]["normalizers"]["u"]
    assert jn["kind"] == tn["kind"] == "unit"
    np.testing.assert_allclose(tn["mean"], jn["mean"], rtol=1e-5)
    np.testing.assert_allclose(tn["std"], jn["std"], rtol=1e-5)
    cfg, _, ex = load_meta(str(tmp_path / "j"))
    assert cfg == tcfg and ex == extra
    params, cfg2, _, _ = load_bundle(str(tmp_path / "t"))
    assert cfg2 == tcfg and isinstance(params["conv_mid"], list)
    for a, b in zip(param_leaves(params), param_leaves(tp)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name,metric", [
    ("mgkn_general_darcy2d", "full_field_l2"),
    ("neurips3_mgkn", "multires")])
def test_smoke_run_matches_jax(monkeypatch, name, metric):
    """The registry's smoke runs on each side from JAX's initial
    parameters: mgkn_general_darcy2d (mkgn, split_random evaluation) and
    neurips3_mgkn (induced, multires). Train/test histories and the
    protocol's rel-L2s within 1e-4 relative (the port's Adam, StepLR and
    shuffle follow JAX's; float32 sums in another order drift over the
    steps), the same bundle payload."""
    cfg, jcfg = treg.get(name), jreg.get(name)
    seen = {}

    def init(gen, c, device=None):
        jm = jmg.MGKNGeneralConfig(**dataclasses.asdict(c))
        seen["cfg"] = jm
        return _params(jm, seed=cfg.seed)[1]

    monkeypatch.setattr(trun, "mgkn_general_init", init)
    got = trun.run_experiment(cfg, smoke=True, device="cpu")
    want = jrun.run_experiment(jcfg, smoke=True)
    assert seen["cfg"].impl == "kcached"
    assert seen["cfg"].variant == jcfg.mgkn_variant
    for key in ("train_l2", "test_l2"):
        assert len(got[key]) == len(want[key]) == 2
        np.testing.assert_allclose(got[key], want[key], rtol=HIST_RTOL,
                                   atol=0, err_msg=key)
    if metric == "multires":
        assert sorted(got[metric]) == sorted(want[metric]) == [17, 33]
        for s in got[metric]:
            np.testing.assert_allclose(got[metric][s], want[metric][s],
                                       rtol=HIST_RTOL)
        assert got["multires_fresh_fields"] == want["multires_fresh_fields"]
    else:
        np.testing.assert_allclose(got[metric], want[metric],
                                   rtol=HIST_RTOL)
    assert got["_bundle"]["extra"] == want["_bundle"]["extra"]
    assert dataclasses.asdict(got["_bundle"]["model_cfg"]) == \
        dataclasses.asdict(want["_bundle"]["model_cfg"])
