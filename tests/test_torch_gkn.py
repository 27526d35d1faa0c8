"""Port parity: the GKN model of graph_pde_tpu_torch against
graph_pde_tpu, on the CPU, from the same parameters (JAX gkn_init
carried over with convert.gkn_params_from_numpy) and the same padded
graphs.

Tolerance: float32 model outputs agree to 1e-4 relative to the output's
max-abs (a few depth steps of sums, each in a different order), bf16
gradients to 5e-3 (a bf16 ulp flips where float32 sums before a rounding
differ in order). The kcached_fused='on' and impl='pallas' JAX sides run
their Pallas kernels in interpret mode."""
import dataclasses
import pathlib
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_pde_tpu.graph import graph as jgraph
from graph_pde_tpu.models import gkn as jgkn

from graph_pde_tpu_torch.convert import gkn_params_from_numpy
from graph_pde_tpu_torch.graph import graph as tgraph
from graph_pde_tpu_torch.models import gkn as tgkn
from graph_pde_tpu_torch.ops.fused_iterate import fused_iterate_total
from graph_pde_tpu_torch.train.trainer import param_leaves, trainable

MODEL_TOL = 1e-4
_REPO = pathlib.Path(__file__).resolve().parent.parent


def _close(got, want, tol=MODEL_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"max-abs error {err:.3g} > {tol:g} of max-abs"


def _graph_args(seed, n=60, e=1500):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 6)).astype(np.float32),
            rng.integers(0, n, e), rng.integers(0, n, e),
            0.5 * rng.normal(size=(e, 6)).astype(np.float32))


def _both_graphs(seed, **kw):
    args = _graph_args(seed)
    jg = jgraph.build_graph(*args, **kw)
    tg = tgraph.build_graph(*args, **kw)
    return jax.tree_util.tree_map(jnp.asarray, jg), tg.to("cpu")


def _cfg(**kw):
    base = dict(width=16, ker_width=32, depth=2, ker_in=6, in_width=6,
                kernel_layers=(6, 16, 32, 256), relu_last=False)
    base.update(kw)
    return jgkn.GKNConfig(**base), tgkn.GKNConfig(**base)


def _params(jcfg, seed=0):
    jp = jgkn.gkn_init(jax.random.PRNGKey(seed), jcfg)
    return jp, gkn_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("impl,relu_last,decoder_mlp,fused", [
    ("auto", False, False, "off"),
    ("reference", True, False, "off"),
    ("reference", False, True, "off"),
    ("kcached", False, False, "off"),
    ("kcached", True, False, "on"),
    ("kcached", False, True, "auto"),
])
def test_gkn_apply_matches(impl, relu_last, decoder_mlp, fused):
    jcfg, tcfg = _cfg(impl=impl, relu_last=relu_last,
                      decoder_mlp=decoder_mlp, kcached_fused=fused)
    jp, tp = _params(jcfg)
    jg, tg = _both_graphs(1)
    assert tg.sorted_span > 0
    before = fused_iterate_total.launches
    got = tgkn.gkn_apply(tp, tcfg, tg)
    want = jgkn.gkn_apply(jp, jcfg, jg)
    _close(got.numpy(), want)
    assert fused_iterate_total.launches == before   # CPU: plain version


def test_gkn_apply_blocked_layout_matches():
    jcfg, tcfg = _cfg(impl="reference")
    jp, tp = _params(jcfg, seed=1)
    jg, tg = _both_graphs(2, node_block=16)
    _close(tgkn.gkn_apply(tp, tcfg, tg).numpy(),
           jgkn.gkn_apply(jp, jcfg, jg))


@pytest.mark.parametrize("impl,batch_mode,node_block", [
    ("reference", "vmap", 0), ("kcached", "vmap", 0),
    ("kcached", "flatten", 0), ("reference", "vmap", 16)])
def test_gkn_apply_batched_matches(impl, batch_mode, node_block):
    jcfg, tcfg = _cfg(impl=impl, kcached_fused="on", batch_mode=batch_mode)
    jp, tp = _params(jcfg, seed=2)
    args = [_graph_args(s) for s in range(3)]
    kw = (dict(node_block=node_block, block_edge_cap=512) if node_block
          else dict(n_edge_pad=2048))
    jst = jgraph.stack_graphs([jgraph.build_graph(*a, **kw) for a in args])
    tst = tgraph.stack_graphs([tgraph.build_graph(*a, **kw) for a in args])
    want = jgkn.gkn_apply_batched(
        jp, jcfg, jax.tree_util.tree_map(jnp.asarray, jst))
    got = tgkn.gkn_apply_batched(tp, tcfg, tst.to("cpu"))
    _close(got.numpy(), want)


def test_kcached_k_dtype_gate_is_per_graph(monkeypatch):
    """A flattened batch must take the per-graph K dtype decision: with
    the f32 budget between one graph's K and the batch's, the batched
    forward equals the per-graph forwards (float32 K), not a bf16 run."""
    _, tcfg = _cfg(impl="kcached")
    _, tp = _params(_cfg()[0], seed=3)
    args = [_graph_args(s) for s in range(3)]
    graphs = [tgraph.build_graph(*a, n_edge_pad=2048) for a in args]
    one_graph_bytes = 2048 * 16 * 16 * 4
    monkeypatch.setattr(tgkn, "_KCACHED_F32_MAX_BYTES", 2 * one_graph_bytes)
    batched = tgkn.gkn_apply_batched(tp, tcfg,
                                     tgraph.stack_graphs(graphs).to("cpu"))
    singles = torch.stack([tgkn.gkn_apply(tp, tcfg, g.to("cpu"))
                           for g in graphs])
    _close(batched.numpy(), singles.numpy(), 1e-5)
    bf16 = tgkn.gkn_apply_batched(
        tp, dataclasses.replace(tcfg, compute_dtype="bfloat16"),
        tgraph.stack_graphs(graphs).to("cpu"))
    assert not torch.allclose(bf16, batched, rtol=0, atol=1e-6)


def test_gkn_init_shapes_and_bounds():
    jcfg, tcfg = _cfg(decoder_mlp=True)
    jp, _ = _params(jcfg)
    tp = tgkn.gkn_init(torch.Generator().manual_seed(0), tcfg,
                          device="cpu")
    jshapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    tshapes = jax.tree.map(lambda a: tuple(a.shape), tp)
    assert jshapes == tshapes
    assert float(tp["root"].abs().max()) <= 1.0 / np.sqrt(16)
    again = tgkn.gkn_init(torch.Generator().manual_seed(0), tcfg,
                          device="cpu")
    torch.testing.assert_close(again["kernel"][2]["w"], tp["kernel"][2]["w"],
                               rtol=0, atol=0)


# loop_vjp: the depth loop's one backward (ops/kcached_loop.py) against
# JAX's custom VJP, on the unfused kcached path (loop_vjp also turns the
# fused path off); with bf16 compute or fp8 K at the bf16 bound above.
@pytest.mark.parametrize("dtype,k_storage,fused", [
    (None, None, "on"), ("bfloat16", None, "off"),
    ("bfloat16", "float8_e4m3", "off")])
def test_gkn_loop_vjp_matches_jax(dtype, k_storage, fused):
    jcfg, tcfg = _cfg(impl="kcached", loop_vjp=True, relu_last=True,
                      compute_dtype=dtype, k_storage=k_storage,
                      kcached_fused=fused)
    jp, tp = _params(jcfg, seed=8)
    jg, tg = _both_graphs(9)
    cot = np.random.default_rng(10).normal(
        size=(tg.x.shape[0], 1)).astype(np.float32)

    def jloss(p):
        out = jgkn.gkn_apply(p, jcfg, jg)
        return jnp.sum(out * cot), out

    (_, jout), jgr = jax.value_and_grad(jloss, has_aux=True)(jp)
    p = trainable(tp, "cpu")
    out = tgkn.gkn_apply(p, tcfg, tg)
    assert out.grad_fn is not None
    (out * torch.from_numpy(cot)).sum().backward()
    _close(out.detach().numpy(), jout)
    want = param_leaves(gkn_params_from_numpy(jax.tree.map(np.asarray, jgr),
                                              "cpu"))
    g_tol = MODEL_TOL if dtype is None else 2e-2
    for a, b in zip(param_leaves(p), want):
        _close(a.grad.numpy(), b, g_tol)
    # the forward of autograd through the loop, and its gradients (dK
    # rounds to bf16 once here, once a step there)
    plain = trainable(tp, "cpu")
    ref = tgkn.gkn_apply(plain, dataclasses.replace(
        tcfg, loop_vjp=False, kcached_fused="off"), tg)
    (ref * torch.from_numpy(cot)).sum().backward()
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    for a, b in zip(param_leaves(p), param_leaves(plain)):
        _close(a.grad.numpy(), b.grad.numpy(), g_tol)


# fp8 K storage on both kcached branches, in float32 and bf16 compute:
# the fused path streams k8 through K2 and B2-bwd, the unfused one
# quantizes K behind the straight-through estimator. Tolerances: 1e-4,
# except the bf16 gradients, at 2e-2 as in test_torch_backward.py::
# test_cached_kernel_grads_match_jax: in bf16 the kappa's gradients are
# bf16 tensors reduced over the edges in another order in each package
# (8.8e-3 with k_storage=None too, on this graph).
@pytest.mark.parametrize("dtype", [None, "bfloat16"])
@pytest.mark.parametrize("fused", ["on", "off"])
@pytest.mark.parametrize("k_storage", ["float8_e4m3", "float8_e5m2"])
def test_gkn_fp8_k_storage_matches_jax(k_storage, fused, dtype):
    jcfg, tcfg = _cfg(impl="kcached", kcached_fused=fused,
                      k_storage=k_storage, compute_dtype=dtype)
    jp, tp = _params(jcfg, seed=5)
    jg, tg = _both_graphs(6)
    cot = np.random.default_rng(7).normal(
        size=(tg.x.shape[0], 1)).astype(np.float32)

    def jloss(p):
        out = jgkn.gkn_apply(p, jcfg, jg)
        return jnp.sum(out * cot), out

    (_, jout), jgr = jax.value_and_grad(jloss, has_aux=True)(jp)
    p = trainable(tp, "cpu")
    before = (fused_iterate_total.launches, fused_iterate_total.e4m3_launches,
              fused_iterate_total.e5m2_launches)
    out = tgkn.gkn_apply(p, tcfg, tg)
    (out * torch.from_numpy(cot)).sum().backward()
    assert (fused_iterate_total.launches, fused_iterate_total.e4m3_launches,
            fused_iterate_total.e5m2_launches) == before   # CPU: plain
    _close(out.detach().numpy(), jout)
    g_tol = MODEL_TOL if dtype is None else 2e-2
    want = param_leaves(gkn_params_from_numpy(jax.tree.map(np.asarray, jgr),
                                              "cpu"))
    for j, (a, b) in enumerate(zip(param_leaves(p), want)):
        _close(a.grad.numpy(), b, g_tol)
    # fp8 storage changed the result
    plain = tgkn.gkn_apply(tp, dataclasses.replace(tcfg, k_storage=None), tg)
    assert not torch.allclose(plain, out.detach(), rtol=1e-4, atol=1e-5)


def test_gkn_apply_host_graph_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = _cfg()
    _, tp = _params(_cfg()[0])
    host = tgraph.build_graph(*_graph_args(5))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgkn.gkn_apply(tp, tcfg, host)


def test_gkn_init_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = _cfg()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgkn.gkn_init(torch.Generator().manual_seed(0), tcfg)


def _nudged(params, seed):
    """Every parameter moved by one float32 ulp, up or down at random."""
    gen = torch.Generator().manual_seed(seed)
    if isinstance(params, torch.Tensor):
        up = torch.randint(0, 2, params.shape, generator=gen).bool()
        return torch.nextafter(params, torch.where(up, torch.inf, -torch.inf))
    if isinstance(params, dict):
        return {k: _nudged(v, seed + j) for j, (k, v) in
                enumerate(params.items())}
    return tuple(_nudged(v, seed + 100 + j) for j, v in enumerate(params))


def test_gkn_bf16_grads_match_jax(capsys):
    """The bf16 gradients of the depth-3, width-64 model of the card test
    (tests/test_torch_cuda.py, the same graph) through the fused path match
    JAX's through the Pallas kernels (interpret mode), since both round
    at the same points; and how far one float32 ulp on every parameter
    moves them, which is what the card's other float32 summation orders
    do, and what the card test's bf16 tolerance must cover."""
    rng = np.random.default_rng(0)
    n, e = 200, 3000
    args = (rng.normal(size=(n, 6)), rng.integers(0, n, e),
            rng.integers(0, n, e), rng.normal(size=(e, 6)))
    base = dict(width=64, ker_width=128, depth=3, ker_in=6, in_width=6,
                kernel_layers=(6, 64, 128, 4096), impl="pallas",
                compute_dtype="bfloat16")
    jcfg, tcfg = jgkn.GKNConfig(**base), tgkn.GKNConfig(**base)
    jp = jgkn.gkn_init(jax.random.PRNGKey(1), jcfg)
    jg = jgraph.build_graph(*args)
    tg = tgraph.build_graph(*args).to("cpu")

    def tgrads(params):
        p = trainable(params, "cpu")
        (tgkn.gkn_apply(p, tcfg, tg) ** 2).sum().backward()
        return [t.grad for t in param_leaves(p)]

    jgr = jax.grad(lambda p: jnp.sum(jgkn.gkn_apply(p, jcfg, jg) ** 2))(jp)
    want = param_leaves(gkn_params_from_numpy(jax.tree.map(np.asarray, jgr),
                                              "cpu"))
    tp = gkn_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    got = tgrads(tp)
    for a, b in zip(got, want):
        _close(a, b, 5e-3)   # one bf16 ulp flip where sum orders differ
    spread = max(float((a - b).abs().max() / b.abs().max())
                 for a, b in zip(tgrads(_nudged(tp, 1)), got))
    with capsys.disabled():
        print(f"\nbf16 gradients moved by one float32 ulp on every "
              f"parameter: {spread:.3e} of the max-abs")
    assert 0.0 < spread <= 1e-2


def test_port_imports_no_jax():
    """Every module of the port imports and runs a tiny forward with jax
    and graph_pde_tpu blocked (fresh interpreter: conftest has already
    imported jax here)."""
    code = textwrap.dedent("""
        import pkgutil, sys, importlib
        sys.modules["jax"] = None
        sys.modules["graph_pde_tpu"] = None
        import numpy as np, torch
        import graph_pde_tpu_torch as pkg
        for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
            importlib.import_module(m.name)
        import chip_smoke
        from graph_pde_tpu_torch.graph import build_graph
        from graph_pde_tpu_torch.models import GKNConfig, gkn_init, gkn_apply
        rng = np.random.default_rng(0)
        g = build_graph(rng.normal(size=(10, 6)), rng.integers(0, 10, 40),
                        rng.integers(0, 10, 40), rng.normal(size=(40, 6)))
        cfg = GKNConfig(width=8, ker_width=16, depth=2, impl="kcached",
                        kcached_fused="on")
        p = gkn_init(torch.Generator().manual_seed(0), cfg, device="cpu")
        out = gkn_apply(p, cfg, g.to("cpu"))
        assert out.shape == (16, 1) and bool(torch.isfinite(out).all())
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                      "graph_pde_tpu")
               and sys.modules[m] is not None]
        assert not bad, bad
        print("ok")
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=_REPO)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
