"""Per-edge contraction against cached kernel matrices, and the fp8
storage policy of the cached K (counterpart of
graph_pde_tpu/ops/cached_contraction.py).

    msg[e, o] = sum_i x_src[e, i] * K[e, i*out + o]

``cached_contraction`` is the public op of the JAX package's Pallas
kernels (B3): a ``torch.autograd.Function`` whose forward is the B3-fwd
kernel and whose backward is the B3-bwd kernel, which writes both
cotangents in one pass over K (``csrc/cached_contraction.cu``). CUDA
tensors launch the kernels (or raise, never falling back); CPU tensors
take the plain versions ``cached_contraction_plain`` and
``cached_contraction_bwd_plain``. K may be float32 or bfloat16; it is
upcast exactly and x is not rounded to K's dtype.

``apply_cached_kernel`` is the unfused kcached path's contraction (XLA
in JAX); its docstring says which K takes B3 and which plain PyTorch
(``apply_cached_kernel_plain``).

fp8 storage (``k_storage``): ``to_fp8`` is the one place the port rounds
to fp8, ``quantize_ste`` the straight-through estimator of the unfused
path, and ``maybe_quantize_k`` the policy that names them.
"""
from __future__ import annotations

import ctypes

import torch

from ..utils import tracing
from . import kernels

C_CHUNK = 1024   # the JAX kernel's column chunk (its shape gate)
_CHUNK = 65536   # edges per step: bounds the [chunk, in, out] product

FP8_DTYPES = {"float8_e4m3": torch.float8_e4m3fn,
              "float8_e5m2": torch.float8_e5m2}
# Above this magnitude a value rounds past e4m3fn's largest finite value
# (448; 464 is the midpoint to the next step, and ties go to 448's even
# mantissa). jnp.astype gives NaN there, as it does for +-inf; torch's
# cast saturates to +-448 instead.
_E4M3_NAN_ABOVE = 464.0


def contraction_supported(e: int, in_channels: int,
                          out_channels: int) -> bool:
    """The JAX package's gate (cached_contraction.py:35-39). The CUDA
    kernels take every shape it admits."""
    c = in_channels * out_channels
    chunk = min(C_CHUNK, c)
    return c % chunk == 0 and chunk % out_channels == 0


def to_fp8(kk: torch.Tensor, name: str) -> torch.Tensor:
    """``kk`` rounded to the fp8 type named by ``name`` ('float8_e4m3' or
    'float8_e5m2'), as ``jnp.astype`` rounds it: round to nearest even,
    and for e4m3fn NaN (with x's sign) wherever |x| > 464 or x is
    infinite, where torch's own cast would saturate."""
    dt = FP8_DTYPES.get(name)
    if dt is None:
        raise ValueError(f"unknown k_storage {name!r}")
    q = kk.to(dt)
    if dt is torch.float8_e4m3fn:
        bits = q.view(torch.uint8)
        # a saturated +-448 is 0x7e / 0xfe; or-ing 0x7f makes it the NaN
        # of the same sign
        q = torch.where(kk.abs() > _E4M3_NAN_ABOVE, bits | 0x7F,
                        bits).view(dt)
    return q


class _QuantizeSTE(torch.autograd.Function):
    """fp8-rounded values in x's dtype; the gradient passes through
    unchanged (the JAX custom_jvp, cached_contraction.py:230-268)."""

    @staticmethod
    def forward(ctx, x, name):
        return to_fp8(x, name).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


def quantize_ste(x: torch.Tensor, name: str) -> torch.Tensor:
    """Straight-through fp8 quantization: the forward value is x rounded
    to fp8 and upcast back to x's dtype, the backward is the identity,
    so the dK cotangent keeps full precision."""
    return _QuantizeSTE.apply(x, name)


def maybe_quantize_k(kk: torch.Tensor, k_storage) -> torch.Tensor:
    """The cached-K storage policy: None keeps K as it is;
    'float8_e4m3' / 'float8_e5m2' quantize it behind the straight-through
    estimator."""
    if k_storage is None:
        return kk
    if k_storage not in FP8_DTYPES:
        raise ValueError(f"unknown k_storage {k_storage!r}")
    return quantize_ste(kk, k_storage)


def apply_cached_kernel(x_src: torch.Tensor, kk2d: torch.Tensor,
                        in_channels: int, out_channels: int) -> torch.Tensor:
    """msg[e, o] = sum_i K[e, i, o] * x[e, i], float32 [E, out].

    A float32 K on CUDA, in a shape the contraction's gate admits, goes
    through B3 (``cached_contraction``): the same float32 products and
    float32 sums, in the kernel's order, one pass over the whole K each
    way and no [E, in, out] product. Every other K (CPU, bf16, fp8)
    takes ``apply_cached_kernel_plain``. The counters ``contract_b3`` and
    ``contract_plain`` count the calls of each.
    """
    if (kk2d.is_cuda and kk2d.dtype == torch.float32
            and contraction_supported(x_src.shape[0], in_channels,
                                      out_channels)):
        tracing.count("contract_b3")
        return cached_contraction(x_src.to(torch.float32), kk2d,
                                  in_channels=in_channels,
                                  out_channels=out_channels)
    tracing.count("contract_plain")
    return apply_cached_kernel_plain(x_src, kk2d, in_channels, out_channels)


def apply_cached_kernel_plain(x_src: torch.Tensor, kk2d: torch.Tensor,
                              in_channels: int,
                              out_channels: int) -> torch.Tensor:
    """The plain path of ``apply_cached_kernel``, in edge chunks.

    Products are taken in K's dtype (a bf16 K rounds x to bf16 and each
    product to bf16) and summed in float32, as the JAX formulation does.
    An fp8 K is a storage format only: it is upcast to bf16 first.
    """
    e = x_src.shape[0]
    out = torch.empty((e, out_channels), dtype=torch.float32,
                      device=x_src.device)
    for s0 in range(0, e, _CHUNK):
        s1 = min(e, s0 + _CHUNK)
        kk = kk2d[s0:s1].view(s1 - s0, in_channels, out_channels)
        if kk.dtype in FP8_DTYPES.values():
            kk = kk.to(torch.bfloat16)
        xs = x_src[s0:s1].to(kk.dtype)
        out[s0:s1] = (kk * xs[:, :, None]).sum(dim=1, dtype=torch.float32)
    return out


# ------------------------------------------------------------------ B3

def cached_contraction_plain(x_src, K, *, in_channels: int,
                             out_channels: int) -> torch.Tensor:
    """Plain PyTorch version of B3-fwd: msg [E, out] float32, K upcast
    exactly, x not rounded; in edge chunks."""
    e = x_src.shape[0]
    msg = torch.empty((e, out_channels), dtype=torch.float32,
                      device=x_src.device)
    for s0 in range(0, e, _CHUNK):
        s1 = min(e, s0 + _CHUNK)
        kk = K[s0:s1].to(torch.float32).view(s1 - s0, in_channels,
                                             out_channels)
        msg[s0:s1] = torch.einsum("ei,eio->eo",
                                  x_src[s0:s1].to(torch.float32), kk)
    return msg


def cached_contraction_bwd_plain(x_src, K, g, *, in_channels: int,
                                 out_channels: int):
    """Plain PyTorch version of B3-bwd: dx = K . g in float32, cast to
    x's dtype, and dK = x (x) g, cast to K's dtype; in edge chunks."""
    e = x_src.shape[0]
    dx = torch.empty((e, in_channels), dtype=x_src.dtype, device=K.device)
    dk = torch.empty_like(K)
    for s0 in range(0, e, _CHUNK):
        s1 = min(e, s0 + _CHUNK)
        kk = K[s0:s1].to(torch.float32).view(s1 - s0, in_channels,
                                             out_channels)
        gg = g[s0:s1].to(torch.float32)
        xs = x_src[s0:s1].to(torch.float32)
        dx[s0:s1] = torch.einsum("eio,eo->ei", kk, gg).to(x_src.dtype)
        dk[s0:s1] = (xs[:, :, None] * gg[:, None, :]).reshape(
            s1 - s0, -1).to(K.dtype)
    return dx, dk


# (pointer operands..., edges, in, out, K is bf16, stream)
_FWD_ARGS = ([ctypes.c_void_p] * 3
             + [ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p])
_BWD_ARGS = ([ctypes.c_void_p] * 5
             + [ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p])


def _check(x_src, K, in_channels: int, out_channels: int, what: str):
    e = x_src.shape[0]
    if not contraction_supported(e, in_channels, out_channels):
        raise ValueError(f"{what}: in={in_channels}, out={out_channels} is "
                         "outside the contraction's shape gate")
    if K.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what}: K must be float32 or bfloat16, not "
                         f"{K.dtype}")
    if x_src.dtype != torch.float32:
        raise ValueError(f"{what}: x must be float32, not {x_src.dtype}")
    if (x_src.shape != (e, in_channels)
            or K.shape != (e, in_channels * out_channels)):
        raise ValueError(f"{what}: x must be [E, in] and K [E, in * out]")
    if x_src.device != K.device:
        raise ValueError(f"{what}: x and K must share one CUDA device")
    if K.data_ptr() % 16:
        raise ValueError(f"{what}: K must be 16-byte aligned")


def _launch(x_src, K, in_channels: int, out_channels: int) -> torch.Tensor:
    x_src, K = x_src.contiguous(), K.contiguous()
    _check(x_src, K, in_channels, out_channels, "B3-fwd")
    e = x_src.shape[0]
    msg = torch.empty((e, out_channels), dtype=torch.float32,
                      device=K.device)
    fn = kernels.fn("cached_contraction", "gpde_contract_fwd", _FWD_ARGS)
    with torch.cuda.device(K.device):
        stream = torch.cuda.current_stream(K.device).cuda_stream
        err = fn(x_src.data_ptr(), K.data_ptr(), msg.data_ptr(), e,
                 in_channels, out_channels, int(K.dtype == torch.bfloat16),
                 stream)
    kernels.check(err, "B3-fwd kernel launch")
    cached_contraction.launches += 1
    return msg


def _launch_bwd(x_src, K, g, in_channels: int, out_channels: int):
    x_src, K = x_src.contiguous(), K.contiguous()
    g = g.contiguous().to(torch.float32)
    if g.data_ptr() % 16:   # the kernel reads g rows in 16-byte runs
        g = g.clone()
    _check(x_src, K, in_channels, out_channels, "B3-bwd")
    e = x_src.shape[0]
    if g.shape != (e, out_channels) or g.device != K.device:
        raise ValueError("B3-bwd: g must be [E, out] on K's device")
    dx = torch.empty((e, in_channels), dtype=torch.float32, device=K.device)
    dk = torch.empty_like(K)
    fn = kernels.fn("cached_contraction", "gpde_contract_bwd", _BWD_ARGS)
    with torch.cuda.device(K.device):
        stream = torch.cuda.current_stream(K.device).cuda_stream
        err = fn(x_src.data_ptr(), K.data_ptr(), g.data_ptr(),
                 dx.data_ptr(), dk.data_ptr(), e, in_channels, out_channels,
                 int(K.dtype == torch.bfloat16), stream)
    kernels.check(err, "B3-bwd kernel launch")
    cached_contraction_bwd.launches += 1
    return dx, dk


def cached_contraction_bwd(x_src, K, g, *, in_channels: int,
                           out_channels: int):
    """(dx [E, in] in x's dtype, dK [E, in*out] in K's dtype) from the
    cotangent g [E, out] of ``cached_contraction``.

    CUDA tensors launch the B3-bwd kernel (counted in
    ``cached_contraction_bwd.launches``); CPU tensors take the plain
    version."""
    if K.is_cuda:
        return _launch_bwd(x_src, K, g, in_channels, out_channels)
    return cached_contraction_bwd_plain(x_src, K, g,
                                        in_channels=in_channels,
                                        out_channels=out_channels)


cached_contraction_bwd.launches = 0


class _CachedContraction(torch.autograd.Function):
    """B3: the JAX custom_vjp (cached_contraction.py:154-175), with the
    backward formulas of its ``_bwd_kernel``."""

    @staticmethod
    def forward(ctx, x_src, K, in_channels, out_channels):
        ctx.save_for_backward(x_src, K)
        ctx.shape = (in_channels, out_channels)
        if K.is_cuda:
            return _launch(x_src, K, in_channels, out_channels)
        return cached_contraction_plain(x_src, K, in_channels=in_channels,
                                        out_channels=out_channels)

    @staticmethod
    def backward(ctx, g):
        x_src, K = ctx.saved_tensors
        in_channels, out_channels = ctx.shape
        dx, dk = cached_contraction_bwd(x_src, K, g, in_channels=in_channels,
                                        out_channels=out_channels)
        return (dx if ctx.needs_input_grad[0] else None,
                dk if ctx.needs_input_grad[1] else None, None, None)


def cached_contraction(x_src, K, *, in_channels: int,
                       out_channels: int) -> torch.Tensor:
    """msg[e] = x_src[e] @ K[e].reshape(in, out), float32 [E, out],
    differentiable in x_src and K. K: [E, in*out], float32 or bfloat16.

    CUDA tensors launch the B3-fwd kernel (counted in
    ``cached_contraction.launches``) and, in the backward, the B3-bwd
    kernel; CPU tensors take the plain versions."""
    return _CachedContraction.apply(x_src, K, in_channels, out_channels)


cached_contraction.launches = 0

__all__ = ["cached_contraction", "cached_contraction_plain",
           "cached_contraction_bwd", "cached_contraction_bwd_plain",
           "contraction_supported", "apply_cached_kernel",
           "apply_cached_kernel_plain", "to_fp8",
           "quantize_ste", "maybe_quantize_k", "FP8_DTYPES"]
