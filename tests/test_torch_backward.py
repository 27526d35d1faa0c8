"""Port parity, gradients: the autograd Functions of graph_pde_tpu_torch
(fused edge messages, K1 + B1-bwd; the fused kcached iteration, K2 +
B2-bwd; the cached-K build) against jax.grad through the JAX package's
custom_vjps, on the CPU. The port's wrappers run their plain PyTorch
versions here; the JAX Pallas kernels run in interpret mode.

Tolerance: each gradient within 1e-4 of its own max-abs in float32 (sums
over a few hundred terms in different orders), 5e-3 where bf16 enters
(the packages round at the same places, but an fp32 sum taken in another
order can flip one bf16 ulp of an operand)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_pde_tpu.ops import dense as jdense
from graph_pde_tpu.ops.fused_iterate import (fused_iterate_total as
                                             j_iterate_total,
                                             sorted_iterate_setup as
                                             j_iterate_setup)
from graph_pde_tpu.ops.pallas_edge_conv import fused_edge_messages as j_fused

from graph_pde_tpu_torch.ops.kcached_loop import build_cached_k
from graph_pde_tpu_torch.ops.cached_contraction import to_fp8
from graph_pde_tpu_torch.ops.dense import dense_apply
from graph_pde_tpu_torch.ops.fused_edge_conv import (edge_messages_bwd_plain,
                                                     fused_edge_messages,
                                                     fused_edge_messages_bwd)
from graph_pde_tpu_torch.ops.fused_iterate import (fused_iterate_bwd,
                                                   fused_iterate_total,
                                                   sorted_iterate_setup)

F32_TOL = 1e-4
BF16_TOL = 5e-3


def _close(got, want, tol, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"{what}: max-abs error {err:.3g} > {tol:g} of max-abs"


def _leaf(a):
    return torch.tensor(np.asarray(a, np.float32), requires_grad=True)


def _k1_case(seed, layers, w, e=300, n=40):
    rng = np.random.default_rng(seed)
    jp = jdense.dense_init(jax.random.PRNGKey(seed), layers)
    x = rng.normal(size=(n, w)).astype(np.float32)
    s = rng.integers(0, n, e)
    a = rng.normal(size=(e, 6)).astype(np.float32)
    cot = rng.normal(size=(e, w)).astype(np.float32)
    return jp, x, s, a, cot


# (kappa layers, JAX layout): the merged o-major backward (Wl resident),
# and a streamed (non-resident, i-major) one; in bf16 and float32
@pytest.mark.parametrize("dtype", [None, "bfloat16"])
@pytest.mark.parametrize("layers,resident", [((6, 16, 32, 64), None),
                                             ((6, 24, 48, 64), False)])
def test_fused_edge_messages_grads_match_jax(layers, resident, dtype):
    w = 8
    jp, x, s, a, cot = _k1_case(1, list(layers), w)

    def jloss(x, a, p):
        msg = j_fused(x, jnp.asarray(s), a, p, in_channels=w,
                      out_channels=w, compute_dtype=dtype, resident=resident,
                      interpret=True)
        return jnp.sum(msg * cot)

    jx, ja, jpg = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(a), jp)

    tx, ta = _leaf(x), _leaf(a)
    tp = tuple({"w": _leaf(p["w"]), "b": _leaf(p["b"])} for p in jp)
    msg = fused_edge_messages(tx, torch.as_tensor(s), ta, tp, in_channels=w,
                              out_channels=w, compute_dtype=dtype)
    assert msg.grad_fn is not None
    (msg * torch.as_tensor(cot)).sum().backward()
    tol = F32_TOL if dtype is None else BF16_TOL
    _close(tx.grad, jx, tol, "dx")
    _close(ta.grad, ja, tol, "dattr")
    for j, (tl, jl) in enumerate(zip(tp, jpg)):
        _close(tl["w"].grad, jl["w"], tol, f"dW{j}")
        _close(tl["b"].grad, jl["b"], tol, f"db{j}")


def test_edge_messages_bwd_plain_is_the_vjp_of_the_forward():
    """The plain backward (what the kernel is held to on the card) is
    the exact gradient of the last layer and the contraction: checked
    against torch autograd through the plain einsum form."""
    rng = np.random.default_rng(2)
    e, kw, wi, wo = 200, 12, 3, 5
    x = torch.tensor(rng.normal(size=(30, wi)), dtype=torch.float32)
    s = torch.as_tensor(rng.integers(0, 30, e))
    h2 = torch.tensor(rng.normal(size=(e, kw)), dtype=torch.float32,
                      requires_grad=True)
    wl = torch.tensor(rng.normal(size=(kw, wi * wo)), dtype=torch.float32,
                      requires_grad=True)
    bl = torch.tensor(rng.normal(size=(wi * wo,)), dtype=torch.float32,
                      requires_grad=True)
    g = torch.tensor(rng.normal(size=(e, wo)), dtype=torch.float32)
    xs = x[s].requires_grad_(True)
    k = (h2 @ wl + bl).view(e, wi, wo)
    (torch.einsum("ei,eio->eo", xs, k) * g).sum().backward()
    before = fused_edge_messages_bwd.launches
    dx_src, dh2, dwl, dbl = fused_edge_messages_bwd(
        x, s, h2.detach(), g, wl.detach(), in_channels=wi, out_channels=wo)
    assert fused_edge_messages_bwd.launches == before   # CPU: plain
    _close(dx_src + g @ bl.detach().view(wi, wo).T, xs.grad, 1e-5, "dx_src")
    _close(dh2, h2.grad, 1e-5, "dh2")
    _close(dwl, wl.grad, 1e-5, "dWl")
    _close(dbl, bl.grad, 1e-5, "dbl")
    # bf16 mode rounds the three products' operands only
    r = edge_messages_bwd_plain(x, s, h2.detach(), g, wl.detach(),
                                in_channels=wi, out_channels=wo,
                                compute_dtype="bfloat16")
    for got, want in zip(r, (dx_src, dh2, dwl, dbl)):
        _close(got, want, 2e-2)
    _close(r[3], dbl, 1e-2, "dbl from bf16(x) * g")


def _iterate_case(seed, w, n=30, e=1024, pad=100):
    rng = np.random.default_rng(seed)
    recv = np.sort(rng.integers(0, n, e)).astype(np.int32)
    recv[-pad:] = n - 1            # padding parked on a real node
    mask = np.arange(e) < e - pad
    s = rng.integers(0, n, e).astype(np.int32)
    x = rng.normal(size=(n, w)).astype(np.float32)
    kk = rng.normal(size=(e, w * w)).astype(np.float32)
    cot = rng.normal(size=(n, w)).astype(np.float32)
    return recv, mask, s, x, kk, cot


@pytest.mark.parametrize("k_dtype", ["float32", "bfloat16"])
def test_fused_iterate_grads_match_jax(k_dtype):
    w, n, span = 8, 30, 64
    recv, mask, s, x, kk, cot = _iterate_case(3, w, n)
    oh, ids, _ = j_iterate_setup(jnp.asarray(recv), jnp.asarray(mask), n,
                                 span)
    jk = jnp.asarray(kk).astype(k_dtype)

    def jloss(x, K):
        total = j_iterate_total(x[jnp.asarray(s)], K, oh, ids, n, span,
                                in_channels=w, out_channels=w,
                                interpret=True)
        return jnp.sum(total * cot)

    jx, jK = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jk)

    tx = _leaf(x)
    tk = torch.tensor(kk).to(getattr(torch, k_dtype)).requires_grad_(True)
    setup = sorted_iterate_setup(torch.as_tensor(recv).long(),
                                 torch.as_tensor(mask), n)
    before = fused_iterate_bwd.launches
    total = fused_iterate_total(tx, torch.as_tensor(s).long(), tk, setup,
                                in_channels=w, out_channels=w)
    (total * torch.as_tensor(cot)).sum().backward()
    assert fused_iterate_bwd.launches == before    # CPU: plain
    assert tk.grad.dtype == tk.dtype              # dK in K's dtype
    _close(tx.grad, jx, F32_TOL, "dx")
    _close(tk.grad.float(), np.asarray(jK, np.float32),
           F32_TOL if k_dtype == "float32" else BF16_TOL, "dK")
    # masked padding edges get no gradient
    assert float(tk.grad[~torch.as_tensor(mask)].abs().max()) == 0.0


@pytest.mark.parametrize("k_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["float8_e4m3", "float8_e5m2"])
def test_fused_iterate_k8_grads_match_jax(name, k_dtype):
    """fp8 storage: the forward and B2-bwd read the 1-byte copy k8, dK
    lands on K in K's dtype, k8 gets no gradient; against JAX's use_k8
    custom_vjp (fused_iterate.py:160-182, interpret mode). K is scaled so
    that e4m3's overflow to NaN stays out of the way."""
    w, n, span = 8, 30, 64
    recv, mask, s, x, kk, cot = _iterate_case(6, w, n)
    kk = kk * 40.0
    oh, ids, _ = j_iterate_setup(jnp.asarray(recv), jnp.asarray(mask), n,
                                 span)
    jk = jnp.asarray(kk).astype(k_dtype)
    fp8 = {"float8_e4m3": jnp.float8_e4m3fn,
           "float8_e5m2": jnp.float8_e5m2}[name]

    def jloss(x, K):
        total = j_iterate_total(x[jnp.asarray(s)], K, oh, ids, n, span,
                                in_channels=w, out_channels=w,
                                k8=K.astype(fp8), interpret=True)
        return jnp.sum(total * cot), total

    (_, jtot), (jx, jK) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(x), jk)

    tx = _leaf(x)
    tk = torch.tensor(kk).to(getattr(torch, k_dtype)).requires_grad_(True)
    k8 = to_fp8(tk.detach(), name)
    setup = sorted_iterate_setup(torch.as_tensor(recv).long(),
                                 torch.as_tensor(mask), n)
    total = fused_iterate_total(tx, torch.as_tensor(s).long(), tk, setup,
                                in_channels=w, out_channels=w, k8=k8)
    (total * torch.as_tensor(cot)).sum().backward()
    _close(total.detach(), jtot, F32_TOL, "total")
    _close(tx.grad, jx, F32_TOL, "dx")
    assert tk.grad.dtype == tk.dtype
    _close(tk.grad.float(), np.asarray(jK, np.float32),
           F32_TOL if k_dtype == "float32" else BF16_TOL, "dK")
    # the forward read k8's values, not K's
    plain = fused_iterate_total(tx.detach(), torch.as_tensor(s).long(),
                                tk.detach(), setup, in_channels=w,
                                out_channels=w)
    assert not torch.allclose(plain, total.detach(), rtol=1e-3)
    with pytest.raises(ValueError, match="k8 must be an fp8 copy"):
        fused_iterate_total(tx, torch.as_tensor(s).long(), tk, setup,
                            in_channels=w, out_channels=w, k8=tk)


@pytest.mark.parametrize("chunked", [True, False])
@pytest.mark.parametrize("bf16", [False, True])
def test_cached_kernel_grads_match_jax(bf16, chunked, monkeypatch):
    """The cached-K build, differentiated by autograd, is jax.grad of
    dense_apply(...).astype(K dtype), over several chunks or in one, where
    K is the one dense_apply itself (no slice write)."""
    import graph_pde_tpu_torch.ops.kcached_loop as tloop

    if chunked:
        monkeypatch.setattr(tloop, "_K_BUILD_CHUNK", 128)
    rng = np.random.default_rng(4)
    layers = [6, 16, 16, 64]
    jp = jdense.dense_init(jax.random.PRNGKey(4), layers)
    a = rng.normal(size=(300, 6)).astype(np.float32)
    cot = rng.normal(size=(300, 64)).astype(np.float32)
    k_dtype = "bfloat16" if bf16 else "float32"

    def jloss(p, a):
        if bf16:
            p = jax.tree.map(lambda t: t.astype(jnp.bfloat16), p)
            a = a.astype(jnp.bfloat16)
        kk = jdense.dense_apply(p, a).astype(k_dtype)
        return jnp.sum(kk.astype(jnp.float32) * cot)

    jpg, ja = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(a))
    tp = tuple({"w": _leaf(p["w"]), "b": _leaf(p["b"])} for p in jp)
    ta = _leaf(a)
    kp, at = tp, ta
    if bf16:
        kp = tuple({k: v.to(torch.bfloat16) for k, v in p.items()}
                   for p in tp)
        at = ta.to(torch.bfloat16)
    kk = build_cached_k(tp, ta, compute_dtype="bfloat16" if bf16 else None,
                        k_dtype=getattr(torch, k_dtype))
    assert (type(kk.grad_fn).__name__ == "CopySlices") == chunked
    (kk.float() * torch.as_tensor(cot)).sum().backward()
    # in bf16 the kappa's gradients are bf16 tensors in both packages,
    # reduced over 300 edges in bf16 (XLA) or per chunk (torch): they
    # agree to a few bf16 ulps (2^-8 = 3.9e-3 of the max-abs each)
    tol = 2e-2 if bf16 else 1e-5
    _close(ta.grad, ja, tol, "dattr")
    for j, (tl, jl) in enumerate(zip(tp, jpg)):
        _close(tl["w"].grad, jl["w"], tol, f"dW{j}")
        _close(tl["b"].grad, jl["b"], tol, f"db{j}")
    with torch.no_grad():
        want = dense_apply(kp, at).to(kk.dtype)
    assert torch.equal(kk.detach(), want)
