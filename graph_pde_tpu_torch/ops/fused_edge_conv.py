"""Fused edge messages (counterpart of graph_pde_tpu/ops/pallas_edge_conv.py,
forward only).

    msg[e, o] = sum_i x[senders[e], i] * kappa(edge_attr[e])[i * out + o]

with kappa the edge-kernel DenseNet. The CUDA kernel (``csrc/
fused_edge_conv.cu``, K1) runs the whole MLP and the contraction per tile
of edges, so the [E, in * out] kernel matrices never reach device memory.
Its single-launch form takes the GKN shapes; a general form takes every
other shape the JAX gate admits (see the source).
``fused_edge_messages`` launches it for CUDA tensors and runs the plain
PyTorch version, ``edge_messages_plain``, for CPU tensors; on CUDA it
launches the kernel or raises, it never falls back.

``compute_dtype='bfloat16'`` rounds as the JAX kernel does: GEMM operands
are bf16 with fp32 accumulation, biases stay fp32, and each K * x
product is rounded to bf16 before the sum over i.

The JAX kernel's selector GEMMs, o/i-major layouts, resident/streamed Wl
split and VMEM fit gates work around Mosaic and have no counterpart here.
"""
from __future__ import annotations

import ctypes

import torch

from .dense import layer_dims
from . import kernels

C_CHUNK = 1024          # the JAX gate's column chunk
_MAX_SHARED = 232448    # bytes of shared memory one block may use
_PLAIN_CHUNK = 32768    # edges per step of the plain version
_SCRATCH_ELEMS = 1 << 26  # floats per small-activation buffer, general form


def fused_path_supported(kernel_params, in_channels: int,
                         out_channels: int) -> bool:
    """The JAX package's fused-path gate (pallas_edge_conv.py:61-73).
    The CUDA kernel takes every shape it admits."""
    dims = layer_dims(kernel_params)
    c = in_channels * out_channels
    if dims[-1][1] != c:
        return False
    chunk = min(C_CHUNK, c)
    if c % chunk != 0 or chunk % out_channels != 0:
        return False
    return dims[-1][0] <= 2048


def kernel_shape_supported(dims, in_channels: int, out_channels: int) -> bool:
    """Shapes the kernel's single-launch form takes: two small ReLU
    layers, attr width <= 16, kw1 % 16 == 0, kw2 % 128 == 0,
    out_channels == 64, an even in_channels, and a tile that fits shared
    memory. Other shapes take its general form."""
    if len(dims) != 3 or dims[-1][1] != in_channels * out_channels:
        return False
    (a_dim, kw1), (kw1b, kw2), (kw2b, _) = dims
    smem = 4 * (128 * (kw2 + max(kw1, in_channels)) + 2 * 16 * 128)
    return (kw1 == kw1b and kw2 == kw2b and a_dim <= 16
            and kw1 % 16 == 0 and kw2 % 128 == 0 and out_channels == 64
            and in_channels % 2 == 0 and smem <= _MAX_SHARED)


def _is_bf16(compute_dtype) -> bool:
    return compute_dtype in ("bfloat16", torch.bfloat16)


def edge_messages_plain(x, senders, edge_attr, kernel_params, *,
                        in_channels: int, out_channels: int,
                        compute_dtype=None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: [E, out] float32 messages,
    computed in edge chunks so that K exists one chunk at a time."""
    if _is_bf16(compute_dtype):
        def rnd(t):
            return t.to(torch.bfloat16).to(torch.float32)
    else:
        def rnd(t):
            return t
    small, last = kernel_params[:-1], kernel_params[-1]
    wl, bl = rnd(last["w"]), last["b"]
    ws = [(rnd(p["w"]), p["b"]) for p in small]
    e = senders.shape[0]
    out = torch.empty((e, out_channels), dtype=torch.float32,
                      device=x.device)
    for s0 in range(0, e, _PLAIN_CHUNK):
        s1 = min(e, s0 + _PLAIN_CHUNK)
        h = edge_attr[s0:s1]
        for w, b in ws:
            h = torch.relu(rnd(h) @ w + b)
        k = (rnd(h) @ wl + bl).view(s1 - s0, in_channels, out_channels)
        xs = rnd(x.index_select(0, senders[s0:s1]))
        out[s0:s1] = rnd(k * xs[:, :, None]).sum(dim=1)
    return out


def _kernel_fn(name: str, argtypes):
    fn = getattr(kernels.load("fused_edge_conv"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_FAST_ARGS = [_P] * 10 + [_I64, _I, _I, _I, _I, _I, _P]
_DENSE_ARGS = [_P, _I64, _I, _P, _P, _I, _P, _I, _P]
_LAST_ARGS = [_P, _I64, _I, _P, _P, _P, _P, _P, _I, _I, _I, _P]


def _launch_fast(x, senders, edge_attr, weights, msg, dims, in_channels,
                 rb, stream) -> int:
    ptrs = [x, senders, edge_attr, *weights, msg]
    if any(t.data_ptr() % 16 for t in ptrs):
        raise ValueError("edge-message kernel needs 16-byte aligned tensors")
    fn = _kernel_fn("gpde_edge_messages", _FAST_ARGS)
    return fn(*[t.data_ptr() for t in ptrs], senders.shape[0], in_channels,
              dims[0][0], dims[0][1], dims[1][1], rb, stream)


def _launch_general(x, senders, edge_attr, weights, msg, in_channels,
                    out_channels, rb, stream) -> int:
    """Per chunk of edges: one dense_relu launch per small layer (the
    activations live in a scratch buffer), then the last layer and the
    contraction in one launch."""
    dense = _kernel_fn("gpde_dense_relu", _DENSE_ARGS)
    last = _kernel_fn("gpde_last_contract", _LAST_ARGS)
    small = [(weights[2 * j], weights[2 * j + 1])
             for j in range(len(weights) // 2 - 1)]
    wl, bl = weights[-2], weights[-1]
    e = senders.shape[0]
    widest = max([w.shape[1] for w, _ in small], default=1)
    chunk = max(128, _SCRATCH_ELEMS // widest // 128 * 128)
    for s0 in range(0, e, chunk):
        s1 = min(e, s0 + chunk)
        h = edge_attr[s0:s1]
        for w, b in small:
            nxt = torch.empty((s1 - s0, w.shape[1]), dtype=torch.float32,
                              device=x.device)
            err = dense(h.data_ptr(), s1 - s0, w.shape[0], w.data_ptr(),
                        b.data_ptr(), w.shape[1], nxt.data_ptr(), rb, stream)
            if err:
                return err
            h = nxt
        err = last(h.data_ptr(), s1 - s0, wl.shape[0], wl.data_ptr(),
                   bl.data_ptr(), x.data_ptr(), senders[s0:s1].data_ptr(),
                   msg[s0:s1].data_ptr(), in_channels, out_channels, rb,
                   stream)
        if err:
            return err
    return 0


def _launch(x, senders, edge_attr, kernel_params, in_channels,
            out_channels, compute_dtype) -> torch.Tensor:
    dims = layer_dims(kernel_params)
    dev = x.device
    weights = [t for p in kernel_params for t in (p["w"], p["b"])]
    for t in [x, edge_attr, *weights]:
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError("edge-message kernel takes float32 tensors on "
                             "one CUDA device")
    if senders.device != dev or senders.dtype != torch.int64:
        raise ValueError("senders must be int64 on the features' device")
    x, edge_attr = x.contiguous(), edge_attr.contiguous()
    weights = [t.contiguous() for t in weights]
    senders = senders.contiguous()
    if (x.shape[1] != in_channels or edge_attr.shape[0] != senders.shape[0]
            or edge_attr.shape[1] != dims[0][0]):
        raise ValueError("x / edge_attr / senders shapes disagree")
    msg = torch.empty((senders.shape[0], out_channels), dtype=torch.float32,
                      device=dev)
    rb = int(_is_bf16(compute_dtype))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if kernel_shape_supported(dims, in_channels, out_channels):
            err = _launch_fast(x, senders, edge_attr, weights, msg, dims,
                               in_channels, rb, stream)
        else:
            err = _launch_general(x, senders, edge_attr, weights, msg,
                                  in_channels, out_channels, rb, stream)
    kernels.check(err, "edge-message kernel launch")
    fused_edge_messages.launches += 1
    return msg


def fused_edge_messages(x, senders, edge_attr, kernel_params, *,
                        in_channels: int, out_channels: int,
                        compute_dtype=None) -> torch.Tensor:
    """[E, out] float32 messages x[senders] @ kappa(edge_attr), fused.

    CUDA tensors launch the K1 kernel (counted in
    ``fused_edge_messages.launches``, once per call in either form); CPU
    tensors take the plain version."""
    if not fused_path_supported(kernel_params, in_channels, out_channels):
        raise ValueError("fused path unsupported for this kernel shape; "
                         "use impl='scan'")
    if x.is_cuda:
        return _launch(x, senders, edge_attr, kernel_params, in_channels,
                       out_channels, compute_dtype)
    return edge_messages_plain(x, senders, edge_attr, kernel_params,
                               in_channels=in_channels,
                               out_channels=out_channels,
                               compute_dtype=compute_dtype)


fused_edge_messages.launches = 0

__all__ = ["fused_edge_messages", "edge_messages_plain",
           "fused_path_supported", "kernel_shape_supported", "C_CHUNK"]
