"""Port parity: the cached-K contraction B3 (forward and backward), the
fp8 rounding of the cached K and its straight-through estimator, against
graph_pde_tpu/ops/cached_contraction.py on the CPU (the port takes its
plain versions here; the JAX Pallas kernels run in interpret mode).

Tolerances: float32 results within 1e-4 of their max-abs (sums in other
orders); a dK rounded to bf16 from the same float32 products, and every
fp8 rounding, bit-equal."""
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from graph_pde_tpu_torch.utils import tracing

# the modules (each package's ops/ exports a function of the same name)
jcc = importlib.import_module("graph_pde_tpu.ops.cached_contraction")
tcc = importlib.import_module("graph_pde_tpu_torch.ops.cached_contraction")

F32_TOL = 1e-4
FP8 = {"float8_e4m3": jnp.float8_e4m3fn, "float8_e5m2": jnp.float8_e5m2}


def _close(got, want, tol, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"{what}: max-abs error {err:.3g} > {tol:g} of max-abs"


def _probe_values(seed):
    """The overflow edge of e4m3fn (448, 464 and the floats around it),
    e5m2's, +-inf, NaN, signed zeros, subnormals, and 200,000 values
    spread over fp8's whole range and beyond."""
    edge = np.array([448, 463.99, 464, np.nextafter(np.float32(464), 1e9),
                     464.01, 465, 479, 480, 1e6, 57344, 61439, 61440, 65536,
                     np.inf, -np.inf, np.nan, 0.0, -0.0, 1e-9, 2.0 ** -9,
                     2.0 ** -10, 2.0 ** -17, 3 * 2.0 ** -18], np.float32)
    rng = np.random.default_rng(seed)
    mags = np.exp(rng.uniform(np.log(1e-8), np.log(1e6), 200_000))
    vals = np.concatenate([edge, -edge, (mags * rng.choice([-1, 1],
                                                          mags.size))])
    return vals.astype(np.float32)


@pytest.mark.parametrize("src", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["float8_e4m3", "float8_e5m2"])
def test_to_fp8_matches_jnp_astype(name, src):
    """Bit-equal to jnp.astype, NaN where JAX gives NaN. The inputs carry
    the same bits into both packages (bf16 inputs as their bit
    patterns). e4m3fn has one NaN per sign and both agree on it; XLA's
    e5m2 NaN payload depends on the source type, so there only the NaN
    positions are compared."""
    vals = _probe_values(1)
    if src == "bfloat16":
        bits = torch.from_numpy(vals).to(torch.bfloat16).view(torch.int16)
        t_in = bits.view(torch.bfloat16)
        j_in = jnp.asarray(bits.numpy().view(np.uint16)).view(jnp.bfloat16)
    else:
        t_in, j_in = torch.from_numpy(vals), jnp.asarray(vals)
    want = np.asarray(j_in.astype(FP8[name]))
    got = tcc.to_fp8(t_in, name)
    assert got.dtype == tcc.FP8_DTYPES[name]
    gb = got.view(torch.uint8).numpy()
    wb = want.view(np.uint8)
    nan = np.isnan(want.astype(np.float32))
    np.testing.assert_array_equal(np.isnan(got.float().numpy()), nan)
    np.testing.assert_array_equal(gb[~nan], wb[~nan])
    if name == "float8_e4m3":
        np.testing.assert_array_equal(gb, wb)
        # the edge: 464 rounds to 448, the next float above it is NaN
        over = np.abs(t_in.float().numpy()) > 464
        np.testing.assert_array_equal(nan, over | np.isnan(
            t_in.float().numpy()))
    assert np.isnan(want.astype(np.float32)).any()


def test_to_fp8_rejects_unknown_name():
    with pytest.raises(ValueError, match="unknown k_storage"):
        tcc.to_fp8(torch.zeros(3), "float8_e3m4")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["float8_e4m3", "float8_e5m2"])
def test_quantize_ste_matches_jax(name, dtype):
    """The value is jnp's fp8 rounding upcast back to x's dtype (bit for
    bit), and the gradient is the cotangent itself, as jax.grad through
    the custom_jvp gives."""
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(40, 64)) * 50).astype(np.float32)
    cot = rng.normal(size=(40, 64)).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    jv = jcc.quantize_ste(jx, FP8[name])
    jg = jax.grad(lambda a: jnp.sum(jcc.quantize_ste(a, FP8[name])
                                    .astype(jnp.float32) * cot))(jx)
    tx = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_(True)
    tv = tcc.quantize_ste(tx, name)
    assert tv.dtype == tx.dtype
    (tv.float() * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_array_equal(tv.detach().float().numpy(),
                                  np.asarray(jv, np.float32))
    np.testing.assert_array_equal(tx.grad.float().numpy(),
                                  np.asarray(jg, np.float32))
    assert not torch.equal(tv.detach(), tx.detach())


def test_maybe_quantize_k_policy():
    kk = torch.randn(10, 16) * 100
    assert tcc.maybe_quantize_k(kk, None) is kk
    with pytest.raises(ValueError, match="unknown k_storage"):
        tcc.maybe_quantize_k(kk, "int8")
    for name in FP8:
        q = tcc.maybe_quantize_k(kk, name)
        assert q.dtype == kk.dtype
        want = jcc.maybe_quantize_k(jnp.asarray(kk.numpy()), name)
        np.testing.assert_array_equal(q.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", ["float8_e4m3", "float8_e5m2"])
def test_apply_cached_kernel_fp8_k_matches_jax(name):
    """An fp8-typed K is upcast to bf16 before the multiply."""
    rng = np.random.default_rng(3)
    e, w = 300, 8
    x = rng.normal(size=(e, w)).astype(np.float32)
    kk = rng.normal(size=(e, w * w)).astype(np.float32)
    want = jcc.apply_cached_kernel(jnp.asarray(x),
                                   jnp.asarray(kk).astype(FP8[name]), w, w)
    got = tcc.apply_cached_kernel(torch.from_numpy(x),
                                  tcc.to_fp8(torch.from_numpy(kk), name),
                                  w, w)
    _close(got.numpy(), want, F32_TOL)


@pytest.mark.parametrize("args", [(300, 16, 16), (300, 3, 5), (64, 8, 8),
                                  (100, 2, 512)])
def test_contraction_supported_is_the_jax_gate(args):
    assert (tcc.contraction_supported(*args)
            == jcc.contraction_supported(*args))


def _case(seed, e, w_in, w_out):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(e, w_in)).astype(np.float32)
    kk = rng.normal(size=(e, w_in * w_out)).astype(np.float32)
    cot = rng.normal(size=(e, w_out)).astype(np.float32)
    return x, kk, cot


# (in, out): the JAX package's test shape, a shape that is not a multiple
# of 8, and one of two column chunks (in * out = 2048)
@pytest.mark.parametrize("w_in,w_out", [(16, 16), (3, 5), (32, 64)])
@pytest.mark.parametrize("k_dtype", ["float32", "bfloat16"])
def test_cached_contraction_matches_jax(k_dtype, w_in, w_out):
    """Forward and both gradients on 300 edges (not a multiple of the JAX
    kernel's 512-edge block) against the Pallas op (interpret mode) and
    jax.grad through its custom_vjp."""
    e = 300
    x, kk, cot = _case(4, e, w_in, w_out)
    jk = jnp.asarray(kk).astype(k_dtype)

    def jloss(x, K):
        msg = jcc.cached_contraction(x, K, in_channels=w_in,
                                     out_channels=w_out, interpret=True)
        return jnp.sum(msg * cot), msg

    (_, jmsg), (jdx, jdk) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(x), jk)

    tx = torch.from_numpy(x).requires_grad_(True)
    tk = torch.from_numpy(kk).to(getattr(torch, k_dtype)).requires_grad_(True)
    before = (tcc.cached_contraction.launches,
              tcc.cached_contraction_bwd.launches)
    msg = tcc.cached_contraction(tx, tk, in_channels=w_in,
                                 out_channels=w_out)
    assert msg.dtype == torch.float32 and msg.grad_fn is not None
    (msg * torch.from_numpy(cot)).sum().backward()
    assert (tcc.cached_contraction.launches,
            tcc.cached_contraction_bwd.launches) == before   # CPU: plain
    _close(msg.detach().numpy(), jmsg, F32_TOL, "msg")
    _close(tx.grad.numpy(), jdx, F32_TOL, "dx")
    assert tk.grad.dtype == tk.dtype
    # dK = x (x) g rounded to K's dtype from the same float32 products
    np.testing.assert_array_equal(tk.grad.float().numpy(),
                                  np.asarray(jdk, np.float32))


def _pallas_bwd(x, K, g, w_in, w_out, block_e=jcc.DEFAULT_BLOCK_E):
    """The JAX package's backward kernel, _bwd_kernel, through a
    pl.pallas_call built with the specs of its bwd_impl
    (cached_contraction.py:136-152), in interpret mode: no JAX function
    reaches bwd_impl."""
    c_total = w_in * w_out
    chunk = min(jcc.C_CHUNK, c_total)
    e = x.shape[0]
    e_pad = ((e + block_e - 1) // block_e) * block_e

    def edge_spec(width):
        return pl.BlockSpec((block_e, width), lambda ei, ci: (ei, 0),
                            memory_space=pltpu.VMEM)

    k_spec = pl.BlockSpec((block_e, chunk), lambda ei, ci: (ei, ci),
                          memory_space=pltpu.VMEM)
    dx, dk = pl.pallas_call(
        functools.partial(jcc._bwd_kernel, w_in, w_out, chunk, K.dtype),
        grid=(e_pad // block_e, c_total // chunk),
        in_specs=[edge_spec(w_in), k_spec, edge_spec(w_out)],
        out_specs=[edge_spec(w_in), k_spec],
        out_shape=[jax.ShapeDtypeStruct((e_pad, w_in), jnp.float32),
                   jax.ShapeDtypeStruct((e_pad, c_total), K.dtype)],
        interpret=True,
    )(jcc._pad_e(x, e_pad), jcc._pad_e(K, e_pad), jcc._pad_e(g, e_pad))
    return dx[:e], dk[:e]


@pytest.mark.parametrize("w_in,w_out", [(16, 16), (32, 64)])
@pytest.mark.parametrize("k_dtype", ["float32", "bfloat16"])
def test_cached_contraction_bwd_plain_matches_pallas_bwd_kernel(
        k_dtype, w_in, w_out):
    """What the B3-bwd kernel is held to on the card (its plain version)
    against the Pallas _bwd_kernel it replaces."""
    x, kk, g = _case(5, 300, w_in, w_out)
    jk = jnp.asarray(kk).astype(k_dtype)
    jdx, jdk = _pallas_bwd(jnp.asarray(x), jk, jnp.asarray(g), w_in, w_out)
    tk = torch.from_numpy(kk).to(getattr(torch, k_dtype))
    dx, dk = tcc.cached_contraction_bwd(torch.from_numpy(x), tk,
                                        torch.from_numpy(g),
                                        in_channels=w_in, out_channels=w_out)
    assert dx.dtype == torch.float32 and dk.dtype == tk.dtype
    _close(dx.numpy(), jdx, F32_TOL, "dx")
    # the selector GEMM forms x[e, i] * g[e, o] exactly (one nonzero term)
    np.testing.assert_array_equal(dk.float().numpy(),
                                  np.asarray(jdk, np.float32))


def test_cached_contraction_plain_does_not_round_x():
    """Unlike apply_cached_kernel, a bf16 K does not round x: the result
    is the float32 contraction with K's values."""
    x, kk, _ = _case(6, 50, 8, 8)
    tk = torch.from_numpy(kk).to(torch.bfloat16)
    got = tcc.cached_contraction_plain(torch.from_numpy(x), tk,
                                       in_channels=8, out_channels=8)
    want = np.einsum("ei,eio->eo", x.astype(np.float64),
                     tk.double().numpy().reshape(50, 8, 8))
    _close(got.numpy(), want, 1e-6)
    rounded = tcc.apply_cached_kernel(torch.from_numpy(x), tk, 8, 8)
    assert not torch.allclose(rounded, got, rtol=0, atol=1e-6)


@pytest.mark.parametrize("e", [1, 129, 300])
def test_apply_cached_kernel_float32_equals_b3(e):
    """The equivalence that sends a float32 K on CUDA through B3: on
    float32 K, the plain path's forward and its autograd gradients in x
    and K equal B3's plain versions (what B3-fwd and B3-bwd compute) to
    float32 rounding (the sums of msg and dx in another order; dK the
    same products, bit for bit). On the CPU every call takes the plain
    path, and ``contract_plain`` counts it while a recording is open."""
    w = 64
    x, kk, g = (torch.from_numpy(a) for a in _case(e, e, w, w))
    xs, ks = x.clone().requires_grad_(True), kk.clone().requires_grad_(True)
    with tracing.recording() as rec:
        got = tcc.apply_cached_kernel(xs, ks, w, w)
        (got * g).sum().backward()
    assert rec.counters == {"contract_plain": 1}
    kw = dict(in_channels=w, out_channels=w)
    _close(got.detach().numpy(),
           tcc.cached_contraction_plain(x, kk, **kw).numpy(), 1e-6, "msg")
    dx, dk = tcc.cached_contraction_bwd_plain(x, kk, g, **kw)
    _close(xs.grad.numpy(), dx.numpy(), 1e-6, "dx")
    assert torch.equal(ks.grad, dk)
