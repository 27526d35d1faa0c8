"""Node-sharded single-graph execution (counterpart of
graph_pde_tpu/parallel/halo.py), the graph analog of sequence
parallelism.

Each rank owns a contiguous block of the nodes of one graph and every
edge whose RECEIVER lives in its block (a host-side partition of the
receiver-sorted edge list). Each conv iteration all-gathers the [N,
width] node features, computes its edge block's messages and reduces
them onto its own nodes; the gradient of the gather is a reduce-scatter.

The apply functions are SPMD: every rank of the group calls them with
the same host ``parts``, takes its own row, and moves it to its device.
They return the whole [S * n_loc, out] output on every rank. Parameter
gradients then hold only the rank's own edges' and nodes' share: sum
them over the group with ``allreduce_grads`` after the backward.

``impl='pallas'`` runs the fused message kernel (K1 on CUDA, its
backward B1-bwd; their plain versions on the CPU) on the rank's edge
bucket, gathering from the all-gathered features by the global sender
ids; 'reference' gathers and runs the plain messages. The ring variant,
which rotates feature blocks instead of all-gathering them, is
reference-only, as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..graph.graph import Graph, round_up
from ..models.gkn import _gkn_decode, _relu_after, params_to
from ..ops.edge_conv import _kernel_messages
from ..ops.segment import (gather_rows, masked_segment_mean,
                           masked_segment_sum, segment_degrees)
from ._comm import (all_gather_rows, axis_index, axis_size, gather_shards,
                    ring_shift)


def _host_masks(graph: Graph):
    n_pad, e_pad = graph.x.shape[0], np.asarray(graph.senders).shape[0]
    emask = (np.asarray(graph.edge_valid).astype(bool)
             if graph.edge_valid is not None
             else np.arange(e_pad) < int(graph.n_edge))
    return emask, np.arange(n_pad) < int(graph.n_node)


def partition_graph(graph: Graph, n_shards: int, edge_multiple: int = 256):
    """Host-side: splits a padded host Graph into per-rank node blocks.

    Returns a dict of numpy arrays with leading axis n_shards:
      x: [S, n_loc, F]
      senders: [S, e_loc] GLOBAL node ids (index into all-gathered x)
      receivers: [S, e_loc] LOCAL node ids within the shard
      edge_attr: [S, e_loc, A]
      edge_mask: [S, e_loc]
      node_mask: [S, n_loc]
    """
    x = np.asarray(graph.x)
    senders = np.asarray(graph.senders)
    receivers = np.asarray(graph.receivers)
    attr = np.asarray(graph.edge_attr)
    emask, nmask = _host_masks(graph)

    n_pad = x.shape[0]
    n_loc = round_up(-(-n_pad // n_shards), 8)
    n_tot = n_loc * n_shards
    if n_tot != n_pad:
        x = np.pad(x, ((0, n_tot - n_pad), (0, 0)))
        nmask = np.pad(nmask, (0, n_tot - n_pad))

    shard_of = receivers // n_loc
    e_loc = 0
    per_shard = []
    for s in range(n_shards):
        sel = (shard_of == s) & emask
        per_shard.append(sel)
        e_loc = max(e_loc, int(sel.sum()))
    e_loc = round_up(max(e_loc, 1), edge_multiple)

    S = n_shards
    out_s = np.zeros((S, e_loc), np.int32)
    out_r = np.full((S, e_loc), n_loc - 1, np.int32)
    out_a = np.zeros((S, e_loc, attr.shape[1]), np.float32)
    out_m = np.zeros((S, e_loc), bool)
    for s in range(S):
        sel = per_shard[s]
        e = int(sel.sum())
        out_s[s, :e] = senders[sel]
        out_r[s, :e] = receivers[sel] - s * n_loc
        out_a[s, :e] = attr[sel]
        out_m[s, :e] = True
    return {
        "x": x.reshape(S, n_loc, -1),
        "senders": out_s,
        "receivers": out_r,
        "edge_attr": out_a,
        "edge_mask": out_m,
        "node_mask": nmask.reshape(S, n_loc),
    }


def _local_row(tree, group, dev: torch.device):
    """This rank's row of every host array of ``tree`` (leading axis S)
    as a tensor on ``dev``: float32 features, int64 ids, bool masks."""
    me, S = axis_index(group), axis_size(group)

    def take(a):
        a = np.asarray(a)
        if a.shape[0] != S:
            raise ValueError(f"parts have {a.shape[0]} shards, the group "
                             f"{S} ranks")
        a = a[me]
        if a.dtype == np.bool_:
            return torch.from_numpy(a.copy()).to(dev)
        if np.issubdtype(a.dtype, np.integer):
            return torch.from_numpy(a.astype(np.int64)).to(dev)
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    if isinstance(tree, dict):
        return {k: _local_row(v, group, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_local_row(v, group, dev) for v in tree]
    return take(tree)


def _messages(x_all, senders, edge_attr, kernel_params, in_channels,
              out_channels, impl):
    if impl in ("pallas", "pallas_interpret"):
        # fused kernel on the rank's edge bucket: the gather out of the
        # all-gathered features happens inside the kernel
        from ..ops.fused_edge_conv import fused_edge_messages

        return fused_edge_messages(x_all, senders, edge_attr, kernel_params,
                                   in_channels=in_channels,
                                   out_channels=out_channels)
    if impl != "reference":
        raise ValueError(f"unknown impl {impl!r}")
    return _kernel_messages(gather_rows(x_all, senders), edge_attr,
                            kernel_params, in_channels, out_channels, "full",
                            None)


def node_sharded_conv_local(x_loc, senders, receivers, edge_attr, edge_mask,
                            kernel_params, *, group, in_channels: int,
                            out_channels: int, aggr: str = "mean",
                            root=None, bias=None, impl: str = "reference"):
    """One rank's conv: all-gather the node features over ``group``,
    compute the local edge block, reduce onto the local nodes."""
    x_all = all_gather_rows(x_loc, group)
    n_loc = x_loc.shape[0]
    msg = _messages(x_all, senders, edge_attr, kernel_params, in_channels,
                    out_channels, impl)
    if aggr == "mean":
        out = masked_segment_mean(msg, receivers, edge_mask, n_loc)
    else:
        out = masked_segment_sum(msg, receivers, edge_mask, n_loc)
    if root is not None:
        out = out + x_loc @ root
    if bias is not None:
        out = out + bias
    return out


def gkn_apply_node_sharded(params, cfg, parts, mesh, axis: str = "data",
                           impl: str = "reference",
                           device: DeviceLike = None) -> torch.Tensor:
    """GKN forward over one node-sharded graph; every rank of the mesh's
    ``axis`` calls it with the same ``parts`` (partition_graph).
    Returns the [S * n_loc, out_width] predictions on ``device`` (None:
    CUDA). impl: 'reference' | 'pallas' (the fused message kernel on
    each rank's bucket; 'pallas_interpret' is the same)."""
    group = mesh.get_group(axis)
    dev = resolve_device(device)
    p = _local_row(parts, group, dev)
    params = params_to(params, dev)
    h = p["x"] @ params["fc1"]["w"] + params["fc1"]["b"]
    for t in range(cfg.depth):
        h = node_sharded_conv_local(
            h, p["senders"], p["receivers"], p["edge_attr"], p["edge_mask"],
            params["kernel"], group=group, in_channels=cfg.width,
            out_channels=cfg.width, aggr=cfg.aggr, root=params.get("root"),
            bias=params.get("bias"), impl=impl)
        if _relu_after(cfg, t):
            h = torch.relu(h)
    return gather_shards(_gkn_decode(params, cfg, h), group)


def partition_graph_ring(graph: Graph, n_shards: int,
                         edge_multiple: int = 256):
    """Host-side: buckets each receiver-shard's edges by SENDER shard for
    ring execution. Returns arrays with leading axes [S_recv, S_send]:

      x: [S, n_loc, F]
      senders: [S, S, e_b]  local ids within the SENDING shard
      receivers: [S, S, e_b] local ids within the receiving shard
      edge_attr: [S, S, e_b, A]
      edge_mask: [S, S, e_b]
      node_mask: [S, n_loc]
    """
    parts = partition_graph(graph, n_shards, edge_multiple=1)
    S = n_shards
    n_loc = parts["x"].shape[1]
    a_dim = parts["edge_attr"].shape[-1]

    e_b = 1
    buckets = []
    for rs in range(S):
        senders = parts["senders"][rs]
        mask = parts["edge_mask"][rs]
        src_shard = senders // n_loc
        row = []
        for ss in range(S):
            sel = (src_shard == ss) & mask
            row.append(sel)
            e_b = max(e_b, int(sel.sum()))
        buckets.append(row)
    e_b = round_up(e_b, edge_multiple)

    out_s = np.zeros((S, S, e_b), np.int32)
    out_r = np.full((S, S, e_b), n_loc - 1, np.int32)
    out_a = np.zeros((S, S, e_b, a_dim), np.float32)
    out_m = np.zeros((S, S, e_b), bool)
    for rs in range(S):
        for ss in range(S):
            sel = buckets[rs][ss]
            e = int(sel.sum())
            out_s[rs, ss, :e] = parts["senders"][rs][sel] - ss * n_loc
            out_r[rs, ss, :e] = parts["receivers"][rs][sel]
            out_a[rs, ss, :e] = parts["edge_attr"][rs][sel]
            out_m[rs, ss, :e] = True
    return {
        "x": parts["x"],
        "senders": out_s,
        "receivers": out_r,
        "edge_attr": out_a,
        "edge_mask": out_m,
        "node_mask": parts["node_mask"],
    }


def ring_conv_local(x_loc, senders_by_src, receivers_by_src, attr_by_src,
                    mask_by_src, kernel_params, *, group,
                    in_channels: int, out_channels: int,
                    aggr: str = "mean", root=None, bias=None):
    """Ring halo exchange: instead of all-gathering the node array,
    rotate [n_loc, w] feature blocks around the group; at step t each
    rank holds shard (me - t) mod S and processes the edge bucket whose
    senders live there. One block is resident at a time."""
    S, me = axis_size(group), axis_index(group)
    n_loc = x_loc.shape[0]
    block = x_loc
    acc = x_loc.new_zeros((n_loc, out_channels))
    cnt = x_loc.new_zeros((n_loc,))
    for t in range(S):
        src = (me - t) % S
        msg = _kernel_messages(gather_rows(block, senders_by_src[src]),
                               attr_by_src[src], kernel_params, in_channels,
                               out_channels, "full", None)
        acc = acc + masked_segment_sum(msg, receivers_by_src[src],
                                       mask_by_src[src], n_loc)
        cnt = cnt + segment_degrees(receivers_by_src[src], mask_by_src[src],
                                    n_loc)
        if t != S - 1:
            block = ring_shift(block, group)
    out = acc / torch.clamp(cnt, min=1.0)[:, None] if aggr == "mean" else acc
    if root is not None:
        out = out + x_loc @ root
    if bias is not None:
        out = out + bias
    return out


def gkn_apply_node_sharded_ring(params, cfg, parts, mesh,
                                axis: str = "data",
                                device: DeviceLike = None) -> torch.Tensor:
    """GKN forward with ring-halo node sharding (parts from
    partition_graph_ring); [S * n_loc, out_width] on every rank."""
    group = mesh.get_group(axis)
    dev = resolve_device(device)
    p = _local_row(parts, group, dev)
    params = params_to(params, dev)
    h = p["x"] @ params["fc1"]["w"] + params["fc1"]["b"]
    for t in range(cfg.depth):
        h = ring_conv_local(
            h, p["senders"], p["receivers"], p["edge_attr"], p["edge_mask"],
            params["kernel"], group=group, in_channels=cfg.width,
            out_channels=cfg.width, aggr=cfg.aggr, root=params.get("root"),
            bias=params.get("bias"))
        if _relu_after(cfg, t):
            h = torch.relu(h)
    return gather_shards(_gkn_decode(params, cfg, h), group)


__all__ = [
    "partition_graph",
    "partition_graph_ring",
    "node_sharded_conv_local",
    "ring_conv_local",
    "gkn_apply_node_sharded",
    "gkn_apply_node_sharded_ring",
]
