"""Port parity, parallel/: graph_pde_tpu_torch.parallel against
graph_pde_tpu.parallel on the CPU.

The host partitions are held bit for bit against JAX's. The sharded
paths run once, in one 4-rank gloo cluster of fresh interpreters that
import torch and the port only (``_WORKER``, spawned as
tests/test_distributed.py spawns its cluster); each rank writes its
results and the tests compare them with the JAX package's, computed
meanwhile in this process: its sharded function at impl='reference' on
a 4-device sub-mesh of conftest's 8 virtual devices (the general MGKN,
whose sharded forward runs 'single' as 'induced'), else its
single-device forward, gradients or train step. The port's
impl='pallas' runs K1's and B1-bwd's plain versions here.

Sizes are those of tests/test_parallel.py (Darcy s=16, width 16,
ker_width 32, depth 2; MGKN points (48, 16, 8); Burgers s=256).
Tolerance: 1e-4 of the reference's max-abs (float32 sums in other
orders); every rank must hold the same output."""
import dataclasses
import json
import os
import pickle
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_pde_tpu.data import datasets as jdata
from graph_pde_tpu.data import synthetic as jsyn
from graph_pde_tpu.models import gkn as jgkn
from graph_pde_tpu.models import mgkn_general as jmg
from graph_pde_tpu.models import mgkn_orthogonal as jmo
from graph_pde_tpu import parallel as jpar
from graph_pde_tpu.train import optim as joptim
from graph_pde_tpu.train import tasks as jtasks
from graph_pde_tpu.train import trainer as jtrainer

from graph_pde_tpu_torch import parallel as tpar
from graph_pde_tpu_torch.data import datasets as tdata
from graph_pde_tpu_torch.graph import graph as tgraph
from graph_pde_tpu_torch.models import mgkn_orthogonal as tmo

S_SHARDS = 4
TOL = 1e-4
GKN = dict(width=16, ker_width=32, depth=2, ker_in=6, in_width=6,
           impl="reference")
MGKN = dict(width=16, ker_width=32, depth=2, ker_in=6, in_width=6,
            points=(48, 16, 8), impl="reference")
ORTHO = dict(width=16, ker_width=32, depth=2, ker_in=4, in_width=2, s=256,
             impl="reference")
VARIANTS = ("mkgn", "induced", "single")
LOSSES = ("mse", "l1")
N_DP = 4   # graphs of the DP+TP step's batch, two a data rank


# ------------------------------------------------------------- inputs

def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _port(obj, cls):
    """A JAX graph dataclass as the port's, on the same host arrays."""
    def conv(v):
        return np.asarray(v) if hasattr(v, "shape") else v
    return cls(**{f.name: conv(getattr(obj, f.name))
                  for f in dataclasses.fields(cls)})


def _first(tree):
    return jax.tree_util.tree_map(lambda a: a[0], tree)


@pytest.fixture(scope="module")
def inputs():
    fields = jsyn.darcy_dataset(8, 16, seed=0)
    arrays, _ = jdata.prepare_darcy(fields, n=8)
    graphs = jdata.darcy_gkn_graphs(arrays, radius=0.25, seed=0)
    gcfg = jgkn.GKNConfig(**GKN)
    mfields = jsyn.darcy_dataset(2, 17, seed=0)
    marrays, _ = jdata.prepare_darcy(mfields, n=2)
    mgraphs, _ = jdata.darcy_mgkn_graphs(
        marrays, points=MGKN["points"], radius_inner=(0.25, 0.5, 1.0),
        radius_inter=(0.2, 0.4), seed=0, edge_multiple=16)
    bfields = jsyn.burgers_dataset(1, ORTHO["s"], seed=0, gen_res=256)
    barrays = jdata.prepare_burgers(bfields, n=1)
    xs, ys, se, re, at = jdata.burgers_multipole_data(barrays)
    og = jmo.MultipoleGraph1D(
        x=jnp.asarray(xs[0]), senders=[jnp.asarray(v) for v in se],
        receivers=[jnp.asarray(v) for v in re],
        attrs=[jnp.asarray(a[0]) for a in at], y=jnp.asarray(ys[0]))
    g4 = jax.tree_util.tree_map(lambda a: a[:N_DP], graphs)
    return {
        "u_normalizer": tdata.prepare_darcy(fields, n=8)[0].u_normalizer,
        "u_normalizer_jax": arrays.u_normalizer,
        "gkn_params": jgkn.gkn_init(jax.random.PRNGKey(0), gcfg),
        "graphs": g4,
        "g0": _first(graphs),
        "mgkn_params": {v: jmg.mgkn_general_init(
            jax.random.PRNGKey(0), jmg.MGKNGeneralConfig(**MGKN, variant=v))
            for v in VARIANTS},
        "mg0": _first(mgraphs),
        "ortho_params": jmo.mgkn_orthogonal_init(
            jax.random.PRNGKey(0), jmo.MGKNOrthogonalConfig(**ORTHO)),
        "og0": og,
    }


def _port_inputs(inp) -> dict:
    """What the cluster gets: the same host arrays in the port's
    classes, and the parameters as numpy trees."""
    og = inp["og0"]
    return {
        "u_normalizer": inp["u_normalizer"],
        "gkn_params": _np_tree(inp["gkn_params"]),
        "graphs": _port(inp["graphs"], tgraph.Graph),
        "g0": _port(inp["g0"], tgraph.Graph),
        "mgkn_params": {v: _np_tree(p)
                        for v, p in inp["mgkn_params"].items()},
        "mg0": _port(inp["mg0"], tgraph.MultiLevelGraph),
        "ortho_params": _np_tree(inp["ortho_params"]),
        "og0": tmo.MultipoleGraph1D(
            x=np.asarray(og.x), senders=[np.asarray(v) for v in og.senders],
            receivers=[np.asarray(v) for v in og.receivers],
            attrs=[np.asarray(v) for v in og.attrs]),
        "gkn_cfg": GKN, "mgkn_cfg": MGKN, "ortho_cfg": ORTHO,
    }


# ------------------------------------------------------ the 4-rank cluster

_WORKER = r'''
import json, pickle, sys
import numpy as np
import torch

rank, world, port, inp_path, out_dir = sys.argv[1:6]
rank, world = int(rank), int(world)
import dataclasses
torch.set_num_threads(1)
from graph_pde_tpu_torch import parallel as par
from graph_pde_tpu_torch.convert import (
    gkn_params_from_numpy, mgkn_general_params_from_numpy,
    mgkn_orthogonal_params_from_numpy)
from graph_pde_tpu_torch.models import (
    GKNConfig, MGKNGeneralConfig, MGKNOrthogonalConfig, gkn_apply_batched,
    mgkn_general_apply)
from graph_pde_tpu_torch.train import (
    GKNTask, adam_steplr, make_train_step, param_leaves, trainable)

with open(inp_path, "rb") as f:
    d = pickle.load(f)
par.initialize(f"localhost:{port}", world, rank)
res, meta = {}, {}


def flat(tree, prefix, out, grad=False):
    if isinstance(tree, dict):
        for k, v in tree.items():
            flat(v, f"{prefix}/{k}", out, grad)
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            flat(v, f"{prefix}/{i}", out, grad)
    else:
        t = tree.grad if grad else tree
        out[prefix] = t.detach().cpu().numpy()


cfg = GKNConfig(**d["gkn_cfg"])
graphs = d["graphs"].to("cpu")

# DP + TP on a (2, 2) mesh: a train step under each loss (the MSE's also
# through K1's plain version), TP forwards of the GKN (column-parallel
# last kappa layer) and the general MGKN (row-parallel down/up kappas)
mesh2 = par.make_mesh((2, 2), device_type="cpu")
for loss, impl in (("mse", "reference"), ("l1", "reference"),
                   ("mse", "pallas")):
    params = trainable(gkn_params_from_numpy(d["gkn_params"], "cpu"), "cpu")
    p_tp = par.param_sharding(mesh2, params)
    meta["tp_kernel_shapes"] = [list(l["w"].shape) for l in p_tp["kernel"]]
    opt, _ = adam_steplr(param_leaves(p_tp), 1e-3, weight_decay=5e-4)
    task = GKNTask(dataclasses.replace(cfg, impl=impl),
                   u_normalizer=d["u_normalizer"], loss_type=loss,
                   use_sample_idx=False)
    step = make_train_step(task, opt, data_group=mesh2.get_group("data"))
    m = step(p_tp, par.batch_sharding(mesh2, graphs))
    flat(par.gather_params(p_tp), f"dp_{loss}_{impl}", res)
    meta[f"dp_{loss}_{impl}"] = {k: float(v) for k, v in m.items()}
with torch.no_grad():
    for impl in ("reference", "pallas"):
        p_tp = par.param_sharding(
            mesh2, gkn_params_from_numpy(d["gkn_params"], "cpu"))
        res[f"tp_forward_{impl}"] = gkn_apply_batched(
            p_tp, dataclasses.replace(cfg, impl=impl), graphs).numpy()
        mp = par.param_sharding(mesh2, mgkn_general_params_from_numpy(
            d["mgkn_params"]["mkgn"], "cpu"))
        mcfg = MGKNGeneralConfig(**{**d["mgkn_cfg"], "impl": impl},
                                 variant="mkgn")
        res[f"tp_mgkn_{impl}"] = mgkn_general_apply(
            mp, mcfg, d["mg0"].to("cpu")).numpy()
rep = par.replicated_sharding(
    mesh2, {"a": torch.full((3,), float(rank)), "b": (torch.ones(2) * rank,)})
res["replicated"] = np.concatenate([rep["a"].numpy(), rep["b"][0].numpy()])

# node-sharded GKN, all-gather and ring
mesh1 = par.make_mesh((world,), ("data",), device_type="cpu")
group = mesh1.get_group("data")
parts = par.partition_graph(d["g0"], world)
ring = par.partition_graph_ring(d["g0"], world)
n = int(d["g0"].n_node)
runs = {
    "gkn_reference": lambda p: par.gkn_apply_node_sharded(
        p, cfg, parts, mesh1, impl="reference", device="cpu"),
    "gkn_pallas": lambda p: par.gkn_apply_node_sharded(
        p, cfg, parts, mesh1, impl="pallas", device="cpu"),
    "ring": lambda p: par.gkn_apply_node_sharded_ring(
        p, cfg, ring, mesh1, device="cpu"),
}
for name, fn in runs.items():
    with torch.no_grad():
        res[name] = fn(gkn_params_from_numpy(d["gkn_params"], "cpu")).numpy()
for name in ("gkn_pallas", "ring"):
    p = trainable(gkn_params_from_numpy(d["gkn_params"], "cpu"), "cpu")
    (runs[name](p)[:n] ** 2).sum().backward()
    par.allreduce_grads(p, group)
    flat(p, f"grad_{name}", res, grad=True)

# node-sharded general MGKN
mparts, mmeta = par.partition_multilevel_graph(d["mg0"], world)
for variant in ("mkgn", "induced", "single"):
    mcfg = MGKNGeneralConfig(**d["mgkn_cfg"], variant=variant)
    mp = mgkn_general_params_from_numpy(d["mgkn_params"][variant], "cpu")
    impls = ("reference", "pallas") if variant == "mkgn" else ("reference",)
    for impl in impls:
        with torch.no_grad():
            res[f"mgkn_{variant}_{impl}"] = par.mgkn_general_apply_node_sharded(
                mp, mcfg, mparts, mmeta, mesh1, impl=impl,
                device="cpu").numpy()
mcfg = MGKNGeneralConfig(**d["mgkn_cfg"], variant="mkgn")
p = trainable(mgkn_general_params_from_numpy(d["mgkn_params"]["mkgn"], "cpu"),
              "cpu")
out = par.mgkn_general_apply_node_sharded(p, mcfg, mparts, mmeta, mesh1,
                                          impl="pallas", device="cpu")
(out[:mcfg.points[0]] ** 2).sum().backward()
par.allreduce_grads(p, group)
flat(p, "grad_mgkn", res, grad=True)

# node-sharded orthogonal MGKN
ocfg = MGKNOrthogonalConfig(**d["ortho_cfg"])
oparts, ometa = par.partition_multipole1d(d["og0"], world)
meta["ortho_lvl_sharded"] = list(ometa["lvl_sharded"])
op = mgkn_orthogonal_params_from_numpy(d["ortho_params"], "cpu")
for impl in ("reference", "pallas"):
    with torch.no_grad():
        res[f"ortho_{impl}"] = par.mgkn_orthogonal_apply_node_sharded(
            op, ocfg, oparts, ometa, mesh1, impl=impl, device="cpu").numpy()

meta["foreign_modules"] = sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "jaxlib", "graph_pde_tpu")
    and sys.modules[m] is not None)
np.savez(f"{out_dir}/rank{rank}.npz", **res)
with open(f"{out_dir}/rank{rank}.json", "w") as f:
    json.dump(meta, f)
torch.distributed.destroy_process_group()
print("RANK_OK", rank, flush=True)
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _flat(tree, prefix, out):
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flat(v, f"{prefix}/{k}", out)
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            _flat(v, f"{prefix}/{i}", out)
    else:
        out[prefix] = np.asarray(tree)
    return out


def _jax_references(inp) -> dict:
    """The JAX package's results for every case the cluster runs."""
    ref = {}
    gcfg = jgkn.GKNConfig(**GKN)
    params, g4, g0 = inp["gkn_params"], inp["graphs"], inp["g0"]
    tx = joptim.adam_steplr(1e-3, weight_decay=5e-4, steps_per_epoch=1)
    for loss in LOSSES:
        task = jtasks.GKNTask(gcfg, u_normalizer=inp["u_normalizer_jax"],
                              loss_type=loss, use_sample_idx=False)
        p1, _, m1 = jtrainer.make_train_step(task, tx)(params,
                                                       tx.init(params), g4)
        _flat(_np_tree(p1), f"dp_{loss}", ref)
        ref[f"dp_{loss}_metrics"] = {k: float(v) for k, v in m1.items()}
    ref["tp_forward"] = np.asarray(jax.jit(jax.vmap(
        lambda g: jgkn.gkn_apply(params, gcfg, g)))(g4))
    ref["tp_mgkn"] = np.asarray(jax.jit(lambda p: jmg.mgkn_general_apply(
        p, jmg.MGKNGeneralConfig(**MGKN, variant="mkgn"), inp["mg0"]))(
            inp["mgkn_params"]["mkgn"]))
    n = int(g0.n_node)
    ref["gkn"] = np.asarray(jgkn.gkn_apply(params, gcfg, g0))[:n]
    grads = jax.jit(jax.grad(lambda p: jnp.sum(
        jgkn.gkn_apply(p, gcfg, g0)[:n] ** 2)))(params)
    _flat(_np_tree(grads), "grad", ref)

    mesh = jpar.make_mesh((S_SHARDS,), axis_names=("data",),
                          devices=jax.devices()[:S_SHARDS])
    mparts, mmeta = jpar.partition_multilevel_graph(inp["mg0"], S_SHARDS)
    for v in VARIANTS:
        mcfg = jmg.MGKNGeneralConfig(**MGKN, variant=v)
        ref[f"mgkn_{v}"] = np.asarray(jax.jit(
            lambda p, c=mcfg: jpar.mgkn_general_apply_node_sharded(
                p, c, mparts, mmeta, mesh, axis="data"))(
                    inp["mgkn_params"][v]))
    mcfg = jmg.MGKNGeneralConfig(**MGKN, variant="mkgn")
    n0 = MGKN["points"][0]
    mgrads = jax.jit(jax.grad(lambda p: jnp.sum(
        jmg.mgkn_general_apply(p, mcfg, inp["mg0"])[:n0] ** 2)))(
            inp["mgkn_params"]["mkgn"])
    _flat(_np_tree(mgrads), "grad_mgkn", ref)
    ocfg = jmo.MGKNOrthogonalConfig(**ORTHO)
    ref["ortho"] = np.asarray(jax.jit(lambda p: jmo.mgkn_orthogonal_apply(
        p, ocfg, inp["og0"]))(inp["ortho_params"]))
    return ref


@pytest.fixture(scope="module")
def cluster(inputs, tmp_path_factory):
    """(per-rank results, per-rank metadata, JAX references)."""
    work = tmp_path_factory.mktemp("cluster")
    inp_path = str(work / "inputs.pkl")
    with open(inp_path, "wb") as f:
        pickle.dump(_port_inputs(inputs), f)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(S_SHARDS), str(port),
         inp_path, str(work)], env=env, cwd=str(work),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(S_SHARDS)]
    try:
        ref = _jax_references(inputs)
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"RANK_OK {r}" in out, \
            f"rank {r} failed:\n{out}"
    res, meta = [], []
    for r in range(S_SHARDS):
        with np.load(work / f"rank{r}.npz") as z:
            res.append({k: z[k] for k in z.files})
        with open(work / f"rank{r}.json") as f:
            meta.append(json.load(f))
    return res, meta, ref


def _close(got, want, tol=TOL, case=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (case, got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"{case}: max-abs error {err:.3g} > {tol:g} of max-abs"


def _same_on_every_rank(res, key):
    for r in range(1, S_SHARDS):
        np.testing.assert_array_equal(res[r][key], res[0][key])
    return res[0][key]


# ------------------------------------------------------------ the tests
#
# Each test loops over its cases; the assertion names the case.

def test_partitions_match_jax(inputs):
    """Each host partition equals JAX's bit for bit (values, dtypes and
    the layout metadata) on the same host graph, over 2 and 4 shards."""
    port = _port_inputs(inputs)
    fns = {"graph": ("partition_graph", "g0"),
           "ring": ("partition_graph_ring", "g0"),
           "multilevel": ("partition_multilevel_graph", "mg0"),
           "multipole1d": ("partition_multipole1d", "og0")}
    for kind, (name, key) in fns.items():
        for n_shards in (2, 4):
            case = f"{kind}, {n_shards} shards"
            jout = getattr(jpar, name)(inputs[key], n_shards)
            tout = getattr(tpar, name)(port[key], n_shards)
            if isinstance(jout, tuple):
                (jout, jmeta), (tout, tmeta) = jout, tout
                assert jmeta == tmeta, case
            jflat, tflat = _flat(jout, "", {}), _flat(tout, "", {})
            assert jflat.keys() == tflat.keys(), case
            for k in jflat:
                assert tflat[k].dtype == jflat[k].dtype, (case, k)
                np.testing.assert_array_equal(tflat[k], jflat[k],
                                              err_msg=f"{case} {k}")


def test_dp_tp_train_step_matches_jax(cluster):
    """A DP + TP Adam step on the (2, 2) mesh (two graphs a data rank,
    the kappa MLP split over two model ranks) equals JAX's single-device
    step on the whole batch, under the MSE and the L1 loss, and under
    the MSE through K1's and B1-bwd's plain versions (impl='pallas':
    the rank's last-layer shard, the small layers gathered): every
    updated parameter, the TP shards gathered, within 1e-4 of each
    leaf's max-abs; the whole batch's loss and metrics within 1e-5
    relative. The MSE divides by the global mask count, which a
    per-rank mean would miss."""
    res, meta, ref = cluster
    for loss, impl in (("mse", "reference"), ("l1", "reference"),
                       ("mse", "pallas")):
        keys = [k for k in ref if k.startswith(f"dp_{loss}/")]
        assert len(keys) == 2 + 6 + 2 + 2, loss
        for k in keys:
            got = k.replace(f"dp_{loss}", f"dp_{loss}_{impl}", 1)
            _close(_same_on_every_rank(res, got), ref[k], case=got)
        want = ref[f"dp_{loss}_metrics"]
        for r in range(S_SHARDS):
            got = meta[r][f"dp_{loss}_{impl}"]
            assert got["batch"] == N_DP, (loss, impl)
            for k in ("loss", "mse", "l2_sum"):
                assert got[k] == pytest.approx(want[k], rel=1e-5), \
                    (loss, impl, k)


def test_tp_forward_matches_jax(cluster):
    """TP forwards against JAX's single-device forwards, on the plain
    message path and through K1's plain version: the GKN (its last kappa
    layer column parallel: each rank contracts its input channels) and
    the general MGKN (its two-layer down/up kappas row parallel: each
    rank's hidden slice, the bias's 1/tp share)."""
    res, _, ref = cluster
    for impl in ("reference", "pallas"):
        _close(_same_on_every_rank(res, f"tp_forward_{impl}"),
               ref["tp_forward"], case=f"gkn {impl}")
        _close(_same_on_every_rank(res, f"tp_mgkn_{impl}"), ref["tp_mgkn"],
               case=f"mgkn {impl}")


def test_tp_kernel_mlp_actually_partitioned(cluster):
    """Each rank holds its half of every kappa layer (the alternating
    column/row scheme): the last layer at [kw, w^2/tp] (three layers:
    column parallel), and no rank holds the whole [kw, w^2]."""
    _, meta, _ = cluster
    kw, w, tp = GKN["ker_width"], GKN["width"], 2
    want = [[6, kw // tp], [kw // tp, kw], [kw, w * w // tp]]
    for r in range(S_SHARDS):
        shapes = meta[r]["tp_kernel_shapes"]
        assert shapes == want
        assert [kw, w * w] not in shapes


def test_node_sharded_gkn_matches_jax(cluster, inputs):
    """The node-sharded GKN forwards (impl 'reference' and 'pallas', and
    the ring) against JAX's single-device forward on the valid nodes
    (the sharded layout re-pads N; valid nodes come first)."""
    res, _, ref = cluster
    n = int(inputs["g0"].n_node)
    n_loc = -(-int(inputs["g0"].x.shape[0]) // S_SHARDS)
    for case in ("gkn_reference", "gkn_pallas", "ring"):
        out = _same_on_every_rank(res, case)
        assert out.shape[0] == S_SHARDS * (-(-n_loc // 8) * 8), case
        _close(out[:n], ref["gkn"], case=case)


def test_node_sharded_grads_match_jax(cluster):
    """Gradients of the sum of squares of the valid outputs, each rank's
    share summed over the group (allreduce_grads), against jax.grad of
    the single-device forward: every leaf within 1e-4 of its max-abs.
    'gkn_pallas' and 'mgkn' run K1's and B1-bwd's plain versions."""
    res, _, ref = cluster
    for case in ("gkn_pallas", "ring", "mgkn"):
        prefix = "grad_mgkn" if case == "mgkn" else "grad"
        keys = [k for k in ref if k.startswith(prefix + "/")]
        assert keys, case
        for k in keys:
            got = _same_on_every_rank(res, f"grad_{case}" + k[len(prefix):])
            _close(got, ref[k], case=f"{case} {k}")


def test_node_sharded_mgkn_general_matches_jax(cluster):
    """The sharded general MGKN in its three variants (mkgn also at
    impl='pallas') against JAX's sharded forward (impl='reference', 4
    devices), every row of its output."""
    res, _, ref = cluster
    for case in ("mkgn_reference", "mkgn_pallas", "induced_reference",
                 "single_reference"):
        variant = case.split("_")[0]
        _close(_same_on_every_rank(res, f"mgkn_{case}"),
               ref[f"mgkn_{variant}"], case=case)


def test_node_sharded_mgkn_orthogonal_matches_jax(cluster):
    """Sharded fine levels and agglomerated coarse ones against JAX's
    single-device forward, at impl 'reference' and 'pallas'."""
    res, meta, ref = cluster
    lvl = meta[0]["ortho_lvl_sharded"]
    assert lvl[0] and not lvl[-1]
    for impl in ("reference", "pallas"):
        _close(_same_on_every_rank(res, f"ortho_{impl}"), ref["ortho"],
               case=impl)


def test_replicated_sharding_broadcasts_the_first_rank(cluster):
    res, _, _ = cluster
    for r in range(S_SHARDS):
        np.testing.assert_array_equal(res[r]["replicated"], np.zeros(5))


def test_cluster_imports_no_jax(cluster):
    _, meta, _ = cluster
    assert all(m["foreign_modules"] == [] for m in meta)


def test_initialize_noop_single_process(monkeypatch):
    """No coordinator and no MASTER_ADDR / WORLD_SIZE: initialize is a
    no-op, idempotent, and the process is not multi-process; the backend
    rule picks gloo without a card of its own for every rank."""
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    tpar.initialize()
    tpar.initialize()
    assert not torch.distributed.is_initialized()
    assert tpar.is_multiprocess() is False
    from graph_pde_tpu_torch.parallel.distributed import default_backend
    assert default_backend(4) == "gloo"
    assert default_backend(1, "cpu") == "gloo"
    with pytest.raises(ValueError, match="world size"):
        tpar.initialize("localhost:1")


def test_specs_match_jax(inputs):
    """param_specs and batch_spec give JAX's specs on the same leaves."""
    jspecs = jpar.param_specs(inputs["gkn_params"])
    tspecs = tpar.param_specs(_np_tree(inputs["gkn_params"]))
    jflat = jax.tree_util.tree_flatten_with_path(
        jspecs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    tflat = jax.tree_util.tree_flatten_with_path(
        tspecs, is_leaf=lambda x: isinstance(x, tpar.sharding.P))
    assert [p for p, _ in jflat[0]] == [p for p, _ in tflat[0]]
    assert [tuple(s) for _, s in jflat[0]] == [tuple(s) for _, s in tflat[0]]
    assert tuple(tpar.batch_spec()) == tuple(jpar.batch_spec())
