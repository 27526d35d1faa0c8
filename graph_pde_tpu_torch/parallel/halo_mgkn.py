"""Node-sharded execution of the multilevel MGKNs (counterpart of
graph_pde_tpu/parallel/halo_mgkn.py).

General MGKN: every LEVEL's node set is split into S contiguous blocks,
so each rank owns a proportional slice of every level (its local node
array is the concatenation of its per-level blocks). All edges (down,
mid, up) are bucketed host-side by the shard of their RECEIVER; senders
carry global ids into the all-gathered node array. Each conv
all-gathers the [sum_l n_l, width] features and reduces its edge bucket
onto local nodes. The reference's in-place level-slice update becomes a
new tensor with the rank's level slice replaced.

Orthogonal MGKN (1-d dyadic hierarchy): fine levels stay block-sharded
on the sequence axis (pooling and nearest upsampling are block-local
while blocks stay even); once a level's block would fall below
``min_block`` (or stop dividing evenly), the state is all-gathered and
the coarse levels compute replicated, re-sharding by the rank's slice
on the way up: the classic parallel-multigrid pattern.

As in parallel/halo.py the apply functions are SPMD over the mesh's
``axis``, return the whole output on every rank, and leave each rank's
parameter gradients holding its own share (``allreduce_grads``).
``impl='pallas'`` runs the fused message kernel (K1, B1-bwd in the
backward) on each rank's edge bucket.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..graph.graph import MultiLevelGraph, round_up
from ..models.gkn import params_to
from ..ops.pooling import avg_pool_1d, upsample_nearest_1d
from ..ops.segment import masked_segment_mean
from ._comm import all_gather_rows, axis_index, axis_size, gather_shards
from .halo import _local_row, _messages


def _level_layout(points, n_shards):
    """points: global level offsets (len L+1). Returns per-level local
    block sizes, local level offsets, and total local nodes."""
    sizes = [points[l + 1] - points[l] for l in range(len(points) - 1)]
    loc = [round_up(-(-n // n_shards), 8) for n in sizes]
    loc_offs = [0]
    for v in loc:
        loc_offs.append(loc_offs[-1] + v)
    return sizes, loc, loc_offs


def _map_nodes(ids, levels, points, loc, loc_offs):
    """Global concat-layout node ids -> (shard, local id within shard).

    ``levels`` gives each id's level (pass None to derive it from
    ``points``)."""
    ids = np.asarray(ids, np.int64)
    if levels is None:
        levels = np.searchsorted(np.asarray(points), ids,
                                 side="right") - 1
    within = ids - np.asarray(points)[levels]
    loc_arr = np.asarray(loc)[levels]
    shard = within // loc_arr
    local = within - shard * loc_arr + np.asarray(loc_offs)[levels]
    return shard.astype(np.int64), local.astype(np.int64)


def _bucket_edges(senders_g, receivers_sh, receivers_loc, attr, valid,
                  n_shards, park, edge_multiple):
    """Groups edges by receiver shard into fixed-capacity buckets.

    senders_g: gathered-domain sender ids. receivers_sh/loc: shard and
    local receiver ids. park: local parking index for padding edges."""
    S = n_shards
    e_loc = 1
    sels = []
    for s in range(S):
        sel = (receivers_sh == s) & valid
        sels.append(sel)
        e_loc = max(e_loc, int(sel.sum()))
    e_loc = round_up(e_loc, edge_multiple)
    a_dim = attr.shape[1]
    out_s = np.zeros((S, e_loc), np.int32)
    out_r = np.full((S, e_loc), park, np.int32)
    out_a = np.zeros((S, e_loc, a_dim), np.float32)
    out_m = np.zeros((S, e_loc), bool)
    for s in range(S):
        sel = sels[s]
        e = int(sel.sum())
        out_s[s, :e] = senders_g[sel]
        out_r[s, :e] = receivers_loc[sel]
        out_a[s, :e] = attr[sel]
        out_m[s, :e] = True
    return {"senders": out_s, "receivers": out_r, "attr": out_a,
            "mask": out_m}


def partition_multilevel_graph(g: MultiLevelGraph, n_shards: int,
                               edge_multiple: int = 64):
    """Host-side partition of one host multilevel graph for S ranks.

    Returns (parts, meta): parts holds numpy arrays with leading axis
    n_shards; meta the static layout (per-level local sizes/offsets)
    the sharded forward needs."""
    S = n_shards
    points = tuple(int(p) for p in g.points)
    L = len(points) - 1
    sizes, loc, loc_offs = _level_layout(points, S)
    n_loc_tot = loc_offs[-1]

    x = np.asarray(g.x)
    f_dim = x.shape[1]
    x_sh = np.zeros((S, n_loc_tot, f_dim), np.float32)
    nmask = np.zeros((S, n_loc_tot), bool)
    for l in range(L):
        lvl = x[points[l]:points[l + 1]]
        pad = np.zeros((S * loc[l], f_dim), np.float32)
        pad[: sizes[l]] = lvl
        x_sh[:, loc_offs[l]:loc_offs[l + 1]] = pad.reshape(S, loc[l],
                                                           f_dim)
        m = np.zeros(S * loc[l], bool)
        m[: sizes[l]] = True
        nmask[:, loc_offs[l]:loc_offs[l + 1]] = m.reshape(S, loc[l])

    def gathered_id(shard, local):
        return shard * n_loc_tot + local

    down, mid, up = [], [], []
    # down/up: global-index edges over the whole node array
    for snd, rcv, attr, msk, ranges, out in (
        (g.down_senders, g.down_receivers, g.down_attr, g.down_mask,
         g.down_ranges, down),
        (g.up_senders, g.up_receivers, g.up_attr, g.up_mask, g.up_ranges,
         up),
    ):
        snd = np.asarray(snd)
        rcv = np.asarray(rcv)
        attr = np.asarray(attr)
        msk = np.asarray(msk).astype(bool)
        for l in range(L - 1):
            r0, r1 = ranges[l]
            s_sh, s_loc = _map_nodes(snd[r0:r1], None, points, loc,
                                     loc_offs)
            r_sh, r_loc = _map_nodes(rcv[r0:r1], None, points, loc,
                                     loc_offs)
            out.append(_bucket_edges(
                gathered_id(s_sh, s_loc), r_sh, r_loc, attr[r0:r1],
                msk[r0:r1], S, n_loc_tot - 1, edge_multiple))
    # mid: LEVEL-LOCAL indices (conv applied on the level slice)
    m_snd = np.asarray(g.mid_senders)
    m_rcv = np.asarray(g.mid_receivers)
    m_attr = np.asarray(g.mid_attr)
    m_msk = np.asarray(g.mid_mask).astype(bool)
    for l in range(L):
        r0, r1 = g.mid_ranges[l]
        snd_l = m_snd[r0:r1].astype(np.int64)
        rcv_l = m_rcv[r0:r1].astype(np.int64)
        lv = np.full(snd_l.shape, l)
        s_sh, s_loc = _map_nodes(snd_l + points[l], lv, points, loc,
                                 loc_offs)
        r_sh = rcv_l // loc[l]
        r_loc = rcv_l - r_sh * loc[l]  # slice-local (within level block)
        mid.append(_bucket_edges(
            gathered_id(s_sh, s_loc), r_sh, r_loc, m_attr[r0:r1],
            m_msk[r0:r1], S, loc[l] - 1, edge_multiple))

    parts = {"x": x_sh, "node_mask": nmask, "down": down, "mid": mid,
             "up": up}
    meta = {"loc": tuple(loc), "loc_offs": tuple(loc_offs),
            "n_loc_tot": n_loc_tot, "points": points}
    return parts, meta


def _gathered_conv(x_all, bucket, kernel_params, width, out_size,
                   impl: str = "reference"):
    """Messages from the all-gathered features, reduced onto out_size
    local rows (masked mean, PyG scatter_mean parity); impl 'pallas'
    runs the fused message kernel on the rank's edge bucket."""
    msg = _messages(x_all, bucket["senders"], bucket["attr"], kernel_params,
                    width, width, impl)
    return masked_segment_mean(msg, bucket["receivers"], bucket["mask"],
                               out_size)


def _set_rows(h, p0, p1, rows):
    """h with rows p0:p1 replaced by ``rows``, as a new tensor."""
    return torch.cat([h[:p0], rows, h[p1:]])


def mgkn_general_apply_node_sharded(params, cfg, parts, meta, mesh,
                                    axis: str = "data",
                                    impl: str = "reference",
                                    device: DeviceLike = None
                                    ) -> torch.Tensor:
    """Node-sharded forward of the general MGKN V-cycle.

    Returns [S * loc0, out_width] on every rank; the first points[1]
    rows are the finest-level predictions in original node order (each
    shard's block is a contiguous chunk of level 0). Every variant but
    'mkgn' runs the residual K_ll + ReLU, as the JAX package's sharded
    forward does."""
    group = mesh.get_group(axis)
    dev = resolve_device(device)
    L = cfg.level
    loc = meta["loc"]
    lo = meta["loc_offs"]
    n_loc_tot = meta["n_loc_tot"]
    width = cfg.width
    p = _local_row({k: parts[k] for k in ("x", "down", "mid", "up")},
                   group, dev)
    down, mid, up = p["down"], p["mid"], p["up"]
    params = params_to(params, dev)

    h = p["x"] @ params["fc_in"]["w"] + params["fc_in"]["b"]
    for _ in range(cfg.depth):
        for l in range(L - 1):
            h_all = all_gather_rows(h, group)
            h = h + _gathered_conv(h_all, down[l],
                                   params["conv_down"][l]["kernel"],
                                   width, n_loc_tot, impl=impl)
            h = torch.relu(h)
        for l in reversed(range(L)):
            h_all = all_gather_rows(h, group)
            h_slice = h[lo[l]:lo[l + 1]]
            delta = _gathered_conv(h_all, mid[l],
                                   params["conv_mid"][l]["kernel"],
                                   width, loc[l], impl=impl)
            if cfg.variant == "mkgn":
                # K_ll replaces the level slice, root term, no ReLU
                # (MGKN_general_darcy2d.py:84-86)
                new = delta + h_slice @ params["conv_mid"][l]["root"]
                h = _set_rows(h, lo[l], lo[l + 1], new)
            else:
                h = torch.relu(_set_rows(h, lo[l], lo[l + 1],
                                         h_slice + delta))
            if l > 0:
                h_all = all_gather_rows(h, group)
                h = h + _gathered_conv(
                    h_all, up[l - 1], params["conv_up"][l - 1]["kernel"],
                    width, n_loc_tot, impl=impl)
                h = torch.relu(h)

    h0 = h[lo[0]:lo[1]]
    h0 = torch.relu(h0 @ params["fc_out1"]["w"] + params["fc_out1"]["b"])
    h0 = h0 @ params["fc_out2"]["w"] + params["fc_out2"]["b"]
    return gather_shards(h0, group)


def _orth_grid_lengths(s: int, n_edge_sets: int):
    """Edge set i lives on the grid of length s / 2^max(i-1, 0) (set 0:
    finest NN edges; set i>=1: level-i interactive edges applied to
    phi[i-1])."""
    return [s // (2 ** max(i - 1, 0)) for i in range(n_edge_sets)]


def partition_multipole1d(g, n_shards: int, min_block: int = 8,
                          edge_multiple: int = 64):
    """Host-side partition of one host MultipoleGraph1D for S ranks.

    Returns (parts, meta). Levels whose per-rank block is at least
    ``min_block`` and even are sharded; coarser ones are replicated
    (meta['lvl_sharded'][l]). Sharded edge sets are bucketed by
    receiver block; replicated ones keep their full edge lists."""
    s = np.asarray(g.x).shape[0]
    S = n_shards
    n_sets = len(g.senders)
    glens = _orth_grid_lengths(s, n_sets)
    level = n_sets - 1

    def level_sharded(length):
        return length % S == 0 and length // S >= min_block \
            and (length // S) % 2 == 0

    edge_parts = []
    for i in range(n_sets):
        gl = glens[i]
        snd = np.asarray(g.senders[i], np.int64)
        rcv = np.asarray(g.receivers[i], np.int64)
        attr = np.asarray(g.attrs[i], np.float32)
        if not level_sharded(gl):
            edge_parts.append({
                "senders": np.broadcast_to(snd, (S,) + snd.shape).copy(),
                "receivers": np.broadcast_to(rcv,
                                             (S,) + rcv.shape).copy(),
                "attr": np.broadcast_to(attr, (S,) + attr.shape).copy(),
                "mask": np.ones((S, snd.shape[0]), bool),
            })
            continue
        blk = gl // S
        r_sh = rcv // blk
        edge_parts.append(_bucket_edges(
            snd, r_sh, rcv - r_sh * blk, attr,
            np.ones(snd.shape[0], bool), S, blk - 1, edge_multiple))

    x = np.asarray(g.x, np.float32)
    if not level_sharded(s):
        raise ValueError(
            f"s={s} over {S} shards gives blocks under min_block="
            f"{min_block} (or uneven); node sharding is not useful "
            "here — run unsharded")
    blk0 = s // S
    parts = {
        "x": x.reshape(S, blk0, -1),
        "edges": edge_parts,
    }
    meta = {
        "s": s,
        "glens": tuple(glens),
        "set_sharded": tuple(level_sharded(gl) for gl in glens),
        # x at level l has length s/2^l; sharded iff that length is
        "lvl_sharded": tuple(level_sharded(s // (2 ** l))
                             for l in range(level)),
    }
    return parts, meta


def _orth_conv(x_state, sharded_in, bucket, conv_params, width, group,
               out_len_loc, impl: str = "reference"):
    """One edge-kernel conv on the (sharded or replicated) level state.
    x_state is local [blk, w] when sharded_in else the full [gl, w]."""
    if sharded_in:
        x_all = all_gather_rows(x_state, group)
        out_size = out_len_loc
    else:
        x_all = x_state
        out_size = x_state.shape[0]
    msg = _messages(x_all, bucket["senders"], bucket["attr"],
                    conv_params["kernel"], width, width, impl)
    out = masked_segment_mean(msg, bucket["receivers"], bucket["mask"],
                              out_size)
    return out + x_state @ conv_params["root"] + conv_params["bias"]


def mgkn_orthogonal_apply_node_sharded(params, cfg, parts, meta, mesh,
                                       axis: str = "data",
                                       impl: str = "reference",
                                       device: DeviceLike = None
                                       ) -> torch.Tensor:
    """Node-sharded forward of the orthogonal MGKN V-cycle.

    Returns [s, out_width] predictions in original order on every rank
    (contiguous blocks reassemble the sequence)."""
    group = mesh.get_group(axis)
    dev = resolve_device(device)
    level = cfg.level
    width = cfg.width
    S = axis_size(group)
    me = axis_index(group)
    lvl_sharded = meta["lvl_sharded"]
    p = _local_row({"x": parts["x"], "edges": parts["edges"]}, group, dev)
    edges = p["edges"]
    params = params_to(params, dev)

    def to_mode(x, was_sharded, want_sharded, length):
        if was_sharded == want_sharded:
            return x
        if was_sharded:  # agglomerate
            return all_gather_rows(x, group)
        blk = length // S
        return x[me * blk:(me + 1) * blk]

    h = p["x"] @ params["fc1"]["w"] + params["fc1"]["b"]
    for _ in range(cfg.depth):
        phi = [None] * level
        cur_sharded = lvl_sharded[0]
        for l in range(level):
            want = lvl_sharded[l]
            h = to_mode(h, cur_sharded, want, meta["s"] // (2 ** l))
            cur_sharded = want
            phi[l] = (h, cur_sharded)
            if l != level - 1:
                h = avg_pool_1d(h, 2)
        # coarsest conv (edge set `level` on phi[level-1]'s grid)
        ph, ph_sh = phi[level - 1]
        assert ph_sh == meta["set_sharded"][level]
        h = torch.relu(h + _orth_conv(
            ph, ph_sh, edges[level], params["conv"][level], width, group,
            ph.shape[0], impl=impl))
        for l in reversed(range(level)):
            if l != 0:
                h = upsample_nearest_1d(h, 2)
                ph, ph_sh = phi[l - 1]
                # h now lives on phi[l-1]'s grid; match its mode
                h = to_mode(h, cur_sharded, ph_sh,
                            meta["s"] // (2 ** (l - 1)))
                cur_sharded = ph_sh
                h = torch.relu(h + _orth_conv(
                    ph, ph_sh, edges[l], params["conv"][l], width, group,
                    ph.shape[0], impl=impl))
            else:
                ph, ph_sh = phi[0]
                h = torch.relu(h + _orth_conv(
                    ph, ph_sh, edges[0], params["conv"][0], width, group,
                    ph.shape[0], impl=impl))
    h = torch.relu(h @ params["fc2"]["w"] + params["fc2"]["b"])
    h = h @ params["fc3"]["w"] + params["fc3"]["b"]
    return gather_shards(h, group)


__all__ = [
    "partition_multilevel_graph",
    "mgkn_general_apply_node_sharded",
    "partition_multipole1d",
    "mgkn_orthogonal_apply_node_sharded",
]
