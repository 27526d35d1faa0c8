"""Collectives over a process group, as autograd Functions where a
gradient flows through them (what the JAX package takes from jax.lax
inside shard_map).

- ``all_gather_rows``: tiled all-gather along dim 0; its backward is the
  transpose, a reduce-scatter sum (jax.lax.all_gather(tiled=True)).
- ``gather_shards``: the same forward for a function's final output,
  which every rank then holds whole; its backward takes this rank's own
  slice of the cotangent (shard_map's out_specs). Summing there instead
  would count each rank's identical loss S times.
- ``ring_shift``: jax.lax.ppermute by +1 around the group; backward
  shifts by -1.
- ``copy_to`` / ``reduce_from``: the Megatron pair around a
  tensor-parallel region (identity forward and all-reduce backward;
  all-reduce forward and identity backward).
- ``allreduce_grads``: the SUM all-reduce of every parameter gradient
  over a group, which shard_map's transpose inserts for replicated
  parameters.

Every op hands torch.distributed the tensor as it is, on its device,
except point-to-point under gloo: gloo's TCP transport reads a send
buffer from host memory, and on CUDA tensors ``batch_isend_irecv``
fails ("gloo/transport/tcp/pair.cc:339 writev ...: Bad address", torch
2.11 on an H100 machine; ``chip_smoke.py --gloo-probe``), while its
broadcast, all_reduce, all_gather_into_tensor and reduce_scatter_tensor
take CUDA tensors. So ``ring_shift`` stages through pinned host memory
always for that pairing of backend and device, and the compute stays on
the card.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def axis_index(group) -> int:
    """This rank's index within ``group``."""
    return dist.get_rank(group)


def axis_size(group) -> int:
    return dist.get_world_size(group)


def _gather(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    out = x.new_empty((axis_size(group) * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out


def _reduce_scatter(g: torch.Tensor, group) -> torch.Tensor:
    g = g.contiguous()
    out = g.new_empty((g.shape[0] // axis_size(group),)
                      + tuple(g.shape[1:]))
    dist.reduce_scatter_tensor(out, g, op=dist.ReduceOp.SUM, group=group)
    return out


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def _own_rows(g: torch.Tensor, group) -> torch.Tensor:
    n = g.shape[0] // axis_size(group)
    r = axis_index(group)
    return g[r * n:(r + 1) * n]


def _p2p_via_host(x: torch.Tensor, group) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _shift(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """x of the rank ``step`` places before this one in ``group``."""
    s, r = axis_size(group), axis_index(group)
    dst = dist.get_global_rank(group, (r + step) % s)
    src = dist.get_global_rank(group, (r - step) % s)
    x = x.contiguous()
    if _p2p_via_host(x, group):
        send = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        send.copy_(x)
        recv = torch.empty_like(send, pin_memory=True)
    else:
        send, recv = x, torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, send, dst, group),
           dist.P2POp(dist.irecv, recv, src, group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return recv.to(x.device)


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather(x, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group), None


class _GatherShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather(x, group)

    @staticmethod
    def backward(ctx, g):
        return _own_rows(g, ctx.group), None


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -1), None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """[n, ...] on each of S ranks -> [S * n, ...] in rank order, on
    every rank; the backward reduce-scatters (sums) the cotangent."""
    return _AllGatherRows.apply(x, group)


def gather_shards(x: torch.Tensor, group) -> torch.Tensor:
    """A function's row-sharded final output gathered whole on every
    rank; the backward keeps this rank's rows of the cotangent."""
    return _GatherShards.apply(x, group)


def ring_shift(x: torch.Tensor, group) -> torch.Tensor:
    """Each rank's x sent to the next rank of ``group`` (ppermute i ->
    i + 1 mod S); returns the previous rank's."""
    return _RingShift.apply(x, group)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Enters a tensor-parallel region: identity forward, all-reduce
    (sum) of the gradient over ``group``."""
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """Leaves a tensor-parallel region: all-reduce (sum) of the partial
    results over ``group``, identity backward."""
    return _ReduceFrom.apply(x, group)


def global_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of a detached value over ``group`` (no gradient)."""
    return _all_reduce(x.detach(), group)


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    return [t for v in tree for t in _tensors(v)]


def allreduce_grads(params, group) -> None:
    """Sums every parameter's ``.grad`` over ``group``, in place, in one
    collective. After a backward in which each rank saw only its own
    data or its own edges, every rank then holds the whole gradient. A
    parameter without a gradient is skipped."""
    grads = [p.grad for p in _tensors(params) if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    off = 0
    for g in grads:
        g.copy_(flat[off:off + g.numel()].view_as(g))
        off += g.numel()


__all__ = ["axis_index", "axis_size", "all_gather_rows", "gather_shards",
           "ring_shift", "copy_to", "reduce_from", "global_sum",
           "allreduce_grads"]
