"""The port's kcached layer: the cached-K build, and the kcached depth
loop as one autograd Function (counterpart of
graph_pde_tpu/ops/kcached_loop.py).

impl='kcached' evaluates each conv's kernel MLP once a forward,
K = kappa(edge_attr) [E, w_in*w_out] (``build_cached_k``), and hands K to
``edge_kernel_conv(..., impl='kcached', cached_k=K)`` at every conv that
reuses it: the GKN's depth steps, each MGKN conv of every V-cycle.

Under autograd, each step of the kcached GKN's depth-T loop adds its
own dK_t = x_t[s] (x) g_t, an [E, w^2] tensor, in the backward.
``kcached_depth_loop`` differentiates the whole loop at once:

  forward : per iteration, gather, the contraction against K, the masked
            segment mean or sum, root and bias, ReLU. It saves the T
            iteration inputs [T, N, w] and the final output.
  backward: per iteration in reverse, the ReLU mask, the bias and root
            cotangents, the mean's 1 / max(count, 1), the gather of the
            output cotangent to the edges, dx through the transposed
            contraction and a scatter-add to the senders. The per-edge
            cotangents g_t [E, w] are stacked, and

                dK[e] = sum_t x_t[senders[e]] (x) g_t[e]

            is built once at the end, one batched contraction over t
            (in edge chunks, to bound the float32 peak), in K's dtype.

The JAX package measured this slower than plain autodiff on the TPU, so
``GKNConfig.loop_vjp`` defaults to False there and here. Supported:
kernel_type='full' on flat receiver-sorted edge lists (blocked graphs
keep the autograd path), aggr 'mean' or 'add', optional root and bias,
float32 or bfloat16 K. The forward runs ``edge_kernel_conv``'s kcached
path; the backward is plain torch.
"""
from __future__ import annotations

from typing import Optional

import torch

from .cached_contraction import maybe_quantize_k
from .dense import dense_apply
from .edge_conv import cast_params, edge_kernel_conv, resolve_dtype
from .segment import gather_rows, segment_counts

# Edges per chunk of the transposed contraction and of dK's build.
_CHUNK = 65536
# Edges per step when building the cached K (bounds the float32 peak).
_K_BUILD_CHUNK = 65536


def build_cached_k(kernel_params, attr: torch.Tensor, *, compute_dtype=None,
                   k_dtype: Optional[torch.dtype] = None,
                   k_storage: Optional[str] = None) -> torch.Tensor:
    """K = kappa(attr) [E, w_in*w_out] for impl='kcached'.

    The kappa parameters and ``attr`` are cast to ``compute_dtype``
    ('bfloat16') where it is given; the MLP's output is cast to
    ``k_dtype`` (default: the compute dtype, else float32), then
    ``k_storage`` ('float8_e4m3' / 'float8_e5m2') stores it in fp8 behind
    the straight-through estimator: fp32 kappa -> k_dtype -> fp8, the JAX
    package's rounding order. Up to ``_K_BUILD_CHUNK`` edges K is the one
    ``dense_apply`` itself; above, each chunk is built and cast on its
    own into one K, the same numbers without one large float32 peak.
    Autograd differentiates either form in attr and every kappa
    parameter, as JAX differentiates dense_apply(...).astype."""
    dtype = resolve_dtype(compute_dtype)
    if dtype is not None:
        kernel_params, attr = cast_params(kernel_params, dtype), attr.to(dtype)
    if k_dtype is None:
        k_dtype = torch.float32 if dtype is None else dtype
    e = attr.shape[0]
    if e <= _K_BUILD_CHUNK:
        kk = dense_apply(kernel_params, attr).to(k_dtype)
    else:
        kk = torch.empty((e, kernel_params[-1]["w"].shape[1]),
                         dtype=k_dtype, device=attr.device)
        for s0 in range(0, e, _K_BUILD_CHUNK):
            s1 = min(e, s0 + _K_BUILD_CHUNK)
            kk[s0:s1] = dense_apply(kernel_params, attr[s0:s1]).to(k_dtype)
    return maybe_quantize_k(kk, k_storage)


def _contract_t(gmsg: torch.Tensor, kk2d: torch.Tensor,
                width: int) -> torch.Tensor:
    """dxj[e, i] = sum_o K[e, i, o] * gmsg[e, o], products in K's dtype
    and sums in float32 (the transpose of ``apply_cached_kernel``)."""
    e = gmsg.shape[0]
    out = torch.empty((e, width), dtype=torch.float32, device=gmsg.device)
    for s0 in range(0, e, _CHUNK):
        s1 = min(e, s0 + _CHUNK)
        kk = kk2d[s0:s1].view(s1 - s0, width, width)
        g = gmsg[s0:s1].to(kk.dtype)
        out[s0:s1] = (kk * g[:, None, :]).sum(dim=2, dtype=torch.float32)
    return out


class _DepthLoop(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, kk, root, bias, senders, receivers, edge_mask,
                depth, width, aggr, relu_last):
        xs = []
        for t in range(depth):
            xs.append(x)
            x = edge_kernel_conv(x, senders, receivers, None, edge_mask,
                                 None, in_channels=width,
                                 out_channels=width, aggr=aggr, root=root,
                                 bias=bias, impl="kcached", cached_k=kk)
            if t != depth - 1 or relu_last:
                x = torch.relu(x)
        ctx.save_for_backward(torch.stack(xs), x, kk, root, bias, senders,
                              receivers, edge_mask)
        ctx.cfg = (depth, width, aggr, relu_last)
        return x

    @staticmethod
    def backward(ctx, g):
        xs, y, kk, root, bias, senders, receivers, edge_mask = \
            ctx.saved_tensors
        depth, width, aggr, relu_last = ctx.cfg
        n, e = xs.shape[1], senders.shape[0]
        mask_f = edge_mask.to(torch.float32)[:, None]
        inv = (1.0 / segment_counts(receivers, edge_mask, n)
               if aggr == "mean" else None)
        droot = torch.zeros_like(root) if root is not None else None
        dbias = (torch.zeros(width, dtype=torch.float32, device=g.device)
                 if bias is not None else None)
        gmsgs = [None] * depth
        g = g.to(torch.float32)
        for t in reversed(range(depth)):
            if t != depth - 1 or relu_last:
                x_out = y if t == depth - 1 else xs[t + 1]
                g = g * (x_out > 0)
            x_in = xs[t]
            if dbias is not None:
                dbias = dbias + g.sum(dim=0)
            if droot is not None:
                droot = droot + x_in.T @ g
                g_root = g @ root.T
            g_scaled = g * inv[:, None] if inv is not None else g
            gmsg = gather_rows(g_scaled, receivers) * mask_f
            gmsgs[t] = gmsg
            dxj = _contract_t(gmsg, kk, width)
            g = torch.zeros((n, width), dtype=torch.float32,
                            device=g.device).index_add_(0, senders, dxj)
            if droot is not None:
                g = g + g_root
        # dK once: for each edge chunk, [c, w, T] @ [c, T, w] over t.
        g_stack = torch.stack(gmsgs)
        dkk = torch.empty_like(kk)
        for s0 in range(0, e, _CHUNK):
            s1 = min(e, s0 + _CHUNK)
            xj = xs[:, senders[s0:s1]].permute(1, 2, 0)
            gt = g_stack[:, s0:s1].permute(1, 0, 2)
            dkk[s0:s1] = torch.bmm(xj, gt).reshape(
                s1 - s0, width * width).to(kk.dtype)
        return (g, dkk, droot, dbias, None, None, None, None, None, None,
                None)


def kcached_depth_loop(x: torch.Tensor, kk: torch.Tensor,
                       root: Optional[torch.Tensor],
                       bias: Optional[torch.Tensor], senders: torch.Tensor,
                       receivers: torch.Tensor, edge_mask: torch.Tensor, *,
                       depth: int, width: int, aggr: str = "mean",
                       relu_last: bool = True) -> torch.Tensor:
    """The depth-T kcached iteration with the loop-level backward.

    x: [N, w] float32 node features (after the encoder); kk: [E, w*w]
    cached kernel matrices (float32 or bfloat16); root [w, w] and bias
    [w] optional; senders / receivers [E], receiver-sorted, padding at
    the tail; edge_mask [E] bool. Returns the final iterate [N, w]
    float32, ReLU'd unless the last step has ``relu_last`` False."""
    if aggr not in ("mean", "add"):
        raise ValueError(f"aggr must be 'mean' or 'add', not {aggr!r}")
    return _DepthLoop.apply(x, kk, root, bias, senders, receivers,
                            edge_mask, depth, width, aggr, relu_last)


__all__ = ["build_cached_k", "kcached_depth_loop"]
