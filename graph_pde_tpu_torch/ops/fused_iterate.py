"""Cached-K iteration: per-edge contraction and per-node masked sum in
one kernel, and its gradient (counterpart of
graph_pde_tpu/ops/fused_iterate.py).

    total[n] = sum_{e: recv[e] = n, mask[e]} x[senders[e]] @ K[e].reshape(in, out)

The kcached GKN path computes K once per forward and runs this once per
depth step. ``sorted_iterate_setup`` builds, once per forward, what is
invariant across the steps: the CSR row pointer of the sorted receivers
and the clamped valid-edge counts (the mean's divisor). The CUDA kernel
(``csrc/fused_iterate.cu``, K2) walks each node's CSR row and writes the
node's sum once; the [E, out] messages never reach device memory and no
one-hot is built.

``fused_iterate_total`` is a ``torch.autograd.Function``, as the JAX
version is a ``custom_vjp``. Its backward runs one kernel (``csrc/
fused_iterate_bwd.cu``, B2-bwd) for dmsg[e] = mask[e] * dtotal[recv[e]]
and dxj = K . dmsg, in one of two forms picked by shape alone
(``b2_bwd_form``): a warp per edge where out % 8 == 0 and out divides
256 (the GKN widths), else a block per edge; dK = xj (x) dmsg is formed
outside the kernel in K's
dtype (as in JAX, so the depth steps' dK contributions accumulate in
that dtype), and dxj is scatter-added onto the senders. CUDA tensors
launch the kernels (or raise, never falling back); CPU tensors take the
plain versions ``fused_iterate_total_plain`` and
``fused_iterate_bwd_plain``.

K may be float32 or bfloat16; either way it is upcast to float32 before
the multiply and x is not rounded (the JAX kernels do the same). With
fp8 storage (``k8``, fused_iterate.py:160-182 in JAX) both kernels
stream the 1-byte copy k8 of K instead (e4m3 or e5m2, upcast exactly),
and dK lands on the full-precision K argument, in K's dtype: a
straight-through estimator.

While a recording is open (``utils.tracing``) the counters
``iterate_k2`` and ``iterate_plain`` count the calls of
``fused_iterate_total`` that launch K2 and that take the plain version.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from ..utils import tracing
from . import kernels
from .segment import segment_counts

BLOCK_E = 512    # the JAX kernel's edge block (edge capacity multiple)
C_CHUNK = 1024   # the JAX kernel's column chunk
_MAX_OUT = 1024  # out_channels bound of the CUDA kernels (the gate implies it)
_COLS = 4096     # K columns per pass of the backward kernel
_PLAIN_CHUNK = 65536
# the kernels' K-kind code of each K stream dtype, and the launch counter
# of each fp8 form
_K_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2,
           torch.float8_e5m2: 3}
_FP8_COUNTER = {torch.float8_e4m3fn: "e4m3_launches",
                torch.float8_e5m2: "e5m2_launches"}


def fused_iterate_supported(e: int, in_channels: int, out_channels: int,
                            span: int) -> bool:
    """The JAX package's gate (fused_iterate.py:53-58). The CUDA kernel
    takes every shape it admits."""
    c = in_channels * out_channels
    chunk = min(C_CHUNK, c)
    return (e > 0 and e % BLOCK_E == 0 and span > 0
            and c % chunk == 0 and chunk % out_channels == 0)


@dataclasses.dataclass
class IterateSetup:
    """Once-per-forward aggregation operands of ``fused_iterate_total``."""

    receivers: torch.Tensor   # [E] int64, sorted ascending
    mask: torch.Tensor        # [E] bool
    rowptr: torch.Tensor      # [N + 1] int64 CSR row pointer
    counts: torch.Tensor      # [N, 1] float32 valid edges, clamped to 1

    @property
    def num_segments(self) -> int:
        return self.rowptr.shape[0] - 1


def sorted_iterate_setup(receivers: torch.Tensor, mask: torch.Tensor,
                         num_segments: int) -> IterateSetup:
    """Row pointer and clamped counts from receiver-sorted edges."""
    receivers = receivers.contiguous()
    if receivers.numel() > 1 and bool((receivers[1:] < receivers[:-1]).any()):
        raise ValueError("fused iteration needs receiver-sorted edges")
    bounds = torch.arange(num_segments + 1, device=receivers.device,
                          dtype=receivers.dtype)
    rowptr = torch.searchsorted(receivers, bounds)
    counts = segment_counts(receivers, mask, num_segments)[:, None]
    return IterateSetup(receivers=receivers, mask=mask.contiguous(),
                        rowptr=rowptr, counts=counts)


def fused_iterate_total_plain(x, senders, K, setup: IterateSetup, *,
                              in_channels: int,
                              out_channels: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: [N, out] float32 sums,
    computed in edge chunks. K is the stream the kernel reads: float32,
    bfloat16 or an fp8 k8."""
    e = senders.shape[0]
    total = torch.zeros((setup.num_segments, out_channels),
                        dtype=torch.float32, device=x.device)
    for s0 in range(0, e, _PLAIN_CHUNK):
        s1 = min(e, s0 + _PLAIN_CHUNK)
        xj = x.index_select(0, senders[s0:s1]).to(torch.float32)
        kk = K[s0:s1].to(torch.float32).view(s1 - s0, in_channels,
                                              out_channels)
        msg = torch.einsum("ei,eio->eo", xj, kk)
        msg = torch.where(setup.mask[s0:s1, None], msg, 0.0)
        total.index_add_(0, setup.receivers[s0:s1], msg)
    return total


def fused_iterate_bwd_plain(K, setup: IterateSetup, dtotal, *,
                            in_channels: int, out_channels: int):
    """Plain PyTorch version of the backward kernel: (dxj [E, in],
    dmsg [E, out]) float32, computed in edge chunks. K is the stream the
    kernel reads, as in ``fused_iterate_total_plain``."""
    e = K.shape[0]
    dmsg = torch.where(setup.mask[:, None],
                       dtotal.index_select(0, setup.receivers), 0.0)
    dxj = torch.empty((e, in_channels), dtype=torch.float32,
                      device=K.device)
    for s0 in range(0, e, _PLAIN_CHUNK):
        s1 = min(e, s0 + _PLAIN_CHUNK)
        kk = K[s0:s1].to(torch.float32).view(s1 - s0, in_channels,
                                              out_channels)
        dxj[s0:s1] = torch.einsum("eio,eo->ei", kk, dmsg[s0:s1])
    return dxj, dmsg


# (pointer operands..., rows, in, out, K kind, stream)
_ARGS = ([ctypes.c_void_p] * 6
         + [ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p])


def _check_k(K, in_channels: int, out_channels: int,
             stream: bool = False) -> None:
    """K is float32 or bfloat16; a K stream (what a kernel reads) may
    also be the fp8 copy k8."""
    if out_channels > _MAX_OUT:
        raise ValueError(f"CUDA iteration kernels take out_channels <= "
                         f"{_MAX_OUT}, not {out_channels}")
    if K.dtype not in (torch.float32, torch.bfloat16) and not (
            stream and K.dtype in _FP8_COUNTER):
        raise ValueError(f"cached K must be float32 or bfloat16"
                         f"{' (or fp8 as k8)' if stream else ''}, not "
                         f"{K.dtype}")
    if K.shape[1] != in_channels * out_channels:
        raise ValueError("K rows must hold in_channels * out_channels")


def _count(fn, K) -> None:
    fn.launches += 1
    if K.dtype in _FP8_COUNTER:
        attr = _FP8_COUNTER[K.dtype]
        setattr(fn, attr, getattr(fn, attr) + 1)


def _launch(x, senders, K, setup: IterateSetup, in_channels: int,
            out_channels: int) -> torch.Tensor:
    c = in_channels * out_channels
    _check_k(K, in_channels, out_channels, stream=True)
    dev = x.device
    if x.dtype != torch.float32 or x.shape[1] != in_channels:
        raise ValueError("x must be float32 [N, in_channels]")
    e = senders.shape[0]
    if K.shape != (e, c) or setup.mask.shape != (e,):
        raise ValueError("K / mask / senders shapes disagree")
    tensors = [x.contiguous(), senders.contiguous(), K.contiguous(),
               setup.mask, setup.rowptr]
    for t in tensors:
        if t.device != dev:
            raise ValueError("iteration kernel operands must share one "
                             "CUDA device")
    if senders.dtype != torch.int64 or setup.rowptr.dtype != torch.int64:
        raise ValueError("senders and rowptr must be int64")
    n = setup.num_segments
    out = torch.empty((n, out_channels), dtype=torch.float32, device=dev)
    ptrs = tensors + [out]
    if any(t.data_ptr() % 16 for t in (ptrs[0], ptrs[2])):
        raise ValueError("iteration kernel needs 16-byte aligned x and K")
    fn = kernels.fn("fused_iterate", "gpde_iterate_total", _ARGS)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*[t.data_ptr() for t in ptrs], n, in_channels,
                 out_channels, _K_KIND[K.dtype], stream)
    kernels.check(err, "iteration kernel launch")
    _count(fused_iterate_total, K)
    return out


def b2_bwd_form(out_channels: int) -> str:
    """The B2-bwd kernel form a shape takes: 'warp' (one warp per edge,
    dmsg in registers) where out % 8 == 0 and out divides 256, else
    'general' (one block per edge)."""
    if out_channels % 8 == 0 and 256 % out_channels == 0:
        return "warp"
    return "general"


def _launch_bwd(K, setup: IterateSetup, dtotal, in_channels: int,
                out_channels: int):
    _check_k(K, in_channels, out_channels, stream=True)
    c = in_channels * out_channels
    form = b2_bwd_form(out_channels)
    if form == "general" and c > _COLS and _COLS % out_channels:
        raise ValueError("iteration backward kernel needs in * out <= "
                         f"{_COLS} or out_channels dividing {_COLS}")
    dev = K.device
    e = K.shape[0]
    K = K.contiguous()
    dtotal = dtotal.contiguous().to(torch.float32)
    if dtotal.shape != (setup.num_segments, out_channels):
        raise ValueError("dtotal must be [N, out_channels]")
    for t in (setup.mask, setup.receivers, dtotal):
        if t.device != dev:
            raise ValueError("iteration backward operands must share one "
                             "CUDA device")
    if (setup.receivers.dtype != torch.int64 or K.data_ptr() % 16
            or dtotal.data_ptr() % 16):
        raise ValueError("receivers must be int64, K and dtotal 16-byte "
                         "aligned")
    dxj = torch.empty((e, in_channels), dtype=torch.float32, device=dev)
    dmsg = torch.empty((e, out_channels), dtype=torch.float32, device=dev)
    fn = kernels.fn("fused_iterate_bwd", f"gpde_iterate_bwd_{form}", _ARGS)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*[t.data_ptr() for t in (K, setup.mask, setup.receivers,
                                          dtotal, dxj, dmsg)],
                 e, in_channels, out_channels, _K_KIND[K.dtype], stream)
    kernels.check(err, "iteration backward kernel launch")
    _count(fused_iterate_bwd, K)
    attr = f"{form}_launches"
    setattr(fused_iterate_bwd, attr, getattr(fused_iterate_bwd, attr) + 1)
    return dxj, dmsg


def fused_iterate_bwd(K, setup: IterateSetup, dtotal, *, in_channels: int,
                      out_channels: int):
    """(dxj [E, in], dmsg [E, out]) float32 from the cotangent dtotal
    [N, out] of ``fused_iterate_total``; K is the stream the forward read
    (K, or the fp8 k8).

    CUDA tensors launch the B2-bwd kernel in the form ``b2_bwd_form``
    picks (counted in ``fused_iterate_bwd.launches``, in
    ``warp_launches`` or ``general_launches``, and an fp8 K also in
    ``e4m3_launches`` / ``e5m2_launches``); CPU tensors take the plain
    version."""
    if K.is_cuda:
        return _launch_bwd(K, setup, dtotal, in_channels, out_channels)
    return fused_iterate_bwd_plain(K, setup, dtotal.to(torch.float32),
                                   in_channels=in_channels,
                                   out_channels=out_channels)


fused_iterate_bwd.launches = 0
fused_iterate_bwd.e4m3_launches = 0
fused_iterate_bwd.e5m2_launches = 0
fused_iterate_bwd.warp_launches = 0
fused_iterate_bwd.general_launches = 0


def _outer(x, senders, dmsg, dtype) -> torch.Tensor:
    """dK[e, i*out + o] = x[senders[e], i] * dmsg[e, o] in ``dtype``,
    in edge chunks (the float32 product exists one chunk at a time)."""
    e, w_out = dmsg.shape
    dk = torch.empty((e, x.shape[1] * w_out), dtype=dtype, device=x.device)
    for s0 in range(0, e, _PLAIN_CHUNK):
        s1 = min(e, s0 + _PLAIN_CHUNK)
        xj = x.index_select(0, senders[s0:s1]).to(torch.float32)
        dk[s0:s1] = (xj[:, :, None] * dmsg[s0:s1, None, :]).reshape(
            s1 - s0, -1).to(dtype)
    return dk


class _FusedIterateTotal(torch.autograd.Function):
    """The masked per-node sum, with the JAX custom_vjps' backward
    (fused_iterate.py:160-200): both kernels read the stream (K, or k8
    where given), and dK lands on K in K's dtype; k8 gets no gradient."""

    @staticmethod
    def forward(ctx, x, K, senders, setup, in_channels, out_channels, k8):
        stream = K if k8 is None else k8
        ctx.save_for_backward(x, stream, senders)
        ctx.setup = setup
        ctx.shape = (in_channels, out_channels)
        ctx.k_dtype = K.dtype
        if x.is_cuda:
            return _launch(x, senders, stream, setup, in_channels,
                           out_channels)
        return fused_iterate_total_plain(x, senders, stream, setup,
                                         in_channels=in_channels,
                                         out_channels=out_channels)

    @staticmethod
    def backward(ctx, dtotal):
        x, stream, senders = ctx.saved_tensors
        in_channels, out_channels = ctx.shape
        dxj, dmsg = fused_iterate_bwd(stream, ctx.setup, dtotal,
                                      in_channels=in_channels,
                                      out_channels=out_channels)
        dx = dk = None
        if ctx.needs_input_grad[0]:
            dx = torch.zeros_like(x).index_add_(0, senders, dxj)
        if ctx.needs_input_grad[1]:
            dk = _outer(x, senders, dmsg, ctx.k_dtype)
        return dx, dk, None, None, None, None, None


def fused_iterate_total(x, senders, K, setup: IterateSetup, *,
                        in_channels: int, out_channels: int,
                        k8=None) -> torch.Tensor:
    """Masked per-node message SUM of one kcached depth step, [N, out]
    float32, differentiable in x and K. The caller multiplies by
    1/counts for the mean. K is float32 or bfloat16; ``k8``, an fp8
    (e4m3 or e5m2) copy of K, is what both kernels then read.

    CUDA tensors launch the K2 kernel (counted in
    ``fused_iterate_total.launches``, and with k8 also in
    ``e4m3_launches`` / ``e5m2_launches``) and, in the backward, the
    B2-bwd kernel; CPU tensors take the plain versions."""
    _check_k(K, in_channels, out_channels)
    if k8 is not None and (k8.dtype not in _FP8_COUNTER
                           or k8.shape != K.shape):
        raise ValueError(f"k8 must be an fp8 copy of K, not {k8.dtype} "
                         f"{tuple(k8.shape)}")
    tracing.count("iterate_k2" if x.is_cuda else "iterate_plain")
    return _FusedIterateTotal.apply(x, K, senders, setup, in_channels,
                                    out_channels, k8)


fused_iterate_total.launches = 0
fused_iterate_total.e4m3_launches = 0
fused_iterate_total.e5m2_launches = 0

__all__ = ["fused_iterate_total", "fused_iterate_total_plain",
           "fused_iterate_bwd", "fused_iterate_bwd_plain",
           "sorted_iterate_setup", "fused_iterate_supported",
           "b2_bwd_form", "IterateSetup", "BLOCK_E"]
