"""Edge-conditioned kernel convolution (counterpart of
graph_pde_tpu/ops/edge_conv.py).

    out_i = aggr_{j in N(i)} [ x_j @ kappa(e_ji) ]  (+ x_i @ root) (+ bias)

with kappa a per-edge MLP producing a [w_in, w_out] matrix ('full') or a
diagonal ('diag'). Aggregation is the masked mean (PyG scatter_mean) or
sum over valid edges.

Paths (``impl``), named as in the JAX package so configs carry over:
  - 'reference': gather, MLP, [E, w_in, w_out] kernel matrices, einsum,
    masked segment reduce.
  - 'scan': the same in fixed-size edge chunks (bounded memory).
  - 'pallas': the fused hand kernel (ops/fused_edge_conv.py), which
    never writes the kernel matrices to device memory.
  - 'auto': 'pallas' when the tensors are on CUDA and the JAX package's
    fused-path gate holds (the CUDA kernel takes every shape it admits);
    otherwise the JAX rule, 'reference' up to 64 M kernel elements and
    'scan' above. A shape decision only.
  - 'kcached': the kernel matrices ``cached_k`` [E, w_in*w_out], built
    once a forward by ops/kcached_loop.py's ``build_cached_k``, contracted
    by ``apply_cached_kernel``; edge_attr, kernel_params and compute_dtype
    are already in K.

A kappa split over tensor-parallel ranks (parallel.TPKernel) computes
its own messages: ``messages`` on the plain paths, ``fused_messages``
(K1 on every rank) on 'pallas'; 'auto' gates on its whole shapes.
"""
from __future__ import annotations

from typing import Optional

import torch

from .cached_contraction import apply_cached_kernel
from .dense import dense_apply
from .segment import gather_rows, masked_segment_mean, masked_segment_sum

_REFERENCE_MAX_KERNEL_ELEMS = 64 * 1024 * 1024  # E * w_in * w_out


def cast_params(kernel_params, dtype):
    """The kappa parameters (a tuple of {'w', 'b'} layers) cast to
    ``dtype``."""
    return tuple({k: v.to(dtype) for k, v in p.items()}
                 for p in kernel_params)


def _kernel_messages(x_src, edge_attr, kernel_params, in_channels,
                     out_channels, kernel_type, compute_dtype):
    """Per-edge messages x_j @ kappa(e), float32 [E', w_out] ('full')."""
    if hasattr(kernel_params, "messages"):     # tensor-parallel kappa
        return kernel_params.messages(x_src, edge_attr, in_channels,
                                      out_channels, kernel_type,
                                      compute_dtype)
    if compute_dtype is not None:
        x_src = x_src.to(compute_dtype)
        edge_attr = edge_attr.to(compute_dtype)
        kernel_params = cast_params(kernel_params, compute_dtype)
    k = dense_apply(kernel_params, edge_attr)
    if kernel_type == "diag":
        return x_src * k
    w = k.view(x_src.shape[0], in_channels, out_channels)
    return torch.einsum("ei,eio->eo", x_src.to(torch.float32),
                        w.to(torch.float32))


def resolve_dtype(compute_dtype):
    """A config's compute_dtype as a torch dtype: None (float32) or
    torch.bfloat16."""
    if compute_dtype in ("bfloat16", torch.bfloat16):
        return torch.bfloat16
    if compute_dtype is None:
        return None
    raise ValueError(f"unsupported compute_dtype {compute_dtype!r}")


def edge_kernel_conv(
    x: torch.Tensor,
    senders: torch.Tensor,
    receivers: torch.Tensor,
    edge_attr: torch.Tensor,
    edge_mask: torch.Tensor,
    kernel_params,
    *,
    in_channels: int,
    out_channels: int,
    aggr: str = "mean",
    root: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    kernel_type: str = "full",
    impl: str = "auto",
    chunk_size: int = 1024,
    compute_dtype=None,
    node_block: int = 0,
    gate_edges: Optional[int] = None,
    cached_k: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The edge-conditioned convolution on one padded graph, [N, w_out]
    float32. ``node_block`` graphs need no special handling here (their
    mask is explicit); ``gate_edges`` is the per-graph edge count the
    'auto' rule sees when several graphs are flattened into one;
    ``cached_k`` is the K of impl='kcached', and only of it."""
    n = x.shape[0]
    e = senders.shape[0]
    if aggr not in ("mean", "add"):
        raise ValueError(f"aggr must be 'mean' or 'add', not {aggr!r}")
    if kernel_type not in ("full", "diag"):
        raise ValueError(f"unknown kernel_type {kernel_type!r}")
    if (impl == "kcached") != (cached_k is not None):
        raise ValueError(f"impl {impl!r} with cached_k "
                         f"{'None' if cached_k is None else 'given'}: "
                         "cached_k goes with impl='kcached' only")
    dtype = resolve_dtype(compute_dtype)

    if impl == "auto":
        impl = _pick_impl(e if gate_edges is None else gate_edges,
                          in_channels, out_channels, kernel_type,
                          kernel_params, x.is_cuda)

    if impl == "kcached":
        msg = apply_cached_kernel(gather_rows(x, senders), cached_k,
                                  in_channels, out_channels)
    elif impl == "pallas":
        from .fused_edge_conv import fused_edge_messages

        kw = dict(in_channels=in_channels, out_channels=out_channels,
                  compute_dtype=dtype)
        if hasattr(kernel_params, "fused_messages"):  # tensor-parallel
            msg = kernel_params.fused_messages(x, senders, edge_attr, **kw)
        else:
            msg = fused_edge_messages(x, senders, edge_attr, kernel_params,
                                      **kw)
    elif impl == "scan" and kernel_type == "full" and e > chunk_size:
        msg = torch.cat([
            _kernel_messages(gather_rows(x, senders[s0:s0 + chunk_size]),
                             edge_attr[s0:s0 + chunk_size], kernel_params,
                             in_channels, out_channels, "full", dtype)
            for s0 in range(0, e, chunk_size)])
    elif impl in ("reference", "scan"):
        msg = _kernel_messages(gather_rows(x, senders), edge_attr,
                               kernel_params, in_channels, out_channels,
                               kernel_type, dtype)
    else:
        raise ValueError(f"unknown impl {impl!r}")

    msg = msg.to(torch.float32)
    if aggr == "mean":
        out = masked_segment_mean(msg, receivers, edge_mask, n)
    else:
        out = masked_segment_sum(msg, receivers, edge_mask, n)
    if root is not None:
        out = out + x @ root
    if bias is not None:
        out = out + bias
    return out


def edge_conv_gaussian(
    x: torch.Tensor,
    senders: torch.Tensor,
    receivers: torch.Tensor,
    edge_attr: torch.Tensor,
    edge_mask: torch.Tensor,
    lengthscale_params,
    *,
    aggr: str = "mean",
    root: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The diagonal Gaussian kernel conv (reference: graph-neural-operator/
    nn_conv.py:99-194): the message is x[s_e] * weight_e with
    weight_e = exp(-attr0^2 / ell^2) / sqrt(|attr1 * attr2|) and learned
    per-channel lengthscales ell = nn(1). Plain torch: no kernel."""
    n = x.shape[0]
    one = torch.ones((1, 1), dtype=x.dtype, device=x.device)
    ell = dense_apply(lengthscale_params, one).reshape(-1)
    a = 1.0 / torch.sqrt(torch.abs(edge_attr[:, 1] * edge_attr[:, 2])
                         + 1e-12)
    b = torch.exp(-(edge_attr[:, 0:1] ** 2) / (ell[None, :] ** 2))
    msg = gather_rows(x, senders) * (a[:, None] * b)
    if aggr == "mean":
        out = masked_segment_mean(msg, receivers, edge_mask, n)
    else:
        out = masked_segment_sum(msg, receivers, edge_mask, n)
    if root is not None:
        out = out + x @ root
    if bias is not None:
        out = out + bias
    return out


def _pick_impl(e, in_channels, out_channels, kernel_type, kernel_params,
               on_cuda: bool) -> str:
    if kernel_type != "full":
        return "reference"
    if on_cuda:
        from .fused_edge_conv import fused_path_supported

        shapes = getattr(kernel_params, "whole_shapes", kernel_params)
        if fused_path_supported(shapes, in_channels, out_channels):
            return "pallas"
    if e * in_channels * out_channels <= _REFERENCE_MAX_KERNEL_ELEMS:
        return "reference"
    return "scan"


__all__ = ["edge_kernel_conv", "edge_conv_gaussian", "cast_params",
           "resolve_dtype"]
