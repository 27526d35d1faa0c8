"""Padded, receiver-sorted graph container (counterpart of
graph_pde_tpu/graph/graph.py).

A ``Graph`` is built on the host as numpy arrays, exactly as the JAX
package builds it: edges sorted by (receiver, sender), edge capacity
padded to a multiple of 512, padding edges parked at ``receiver =
N_pad - 1`` and excluded by the edge mask. ``Graph.to(device)`` returns
the same graph as torch tensors (float32 features, int64 indices, bool
masks) on that device; with no device given it resolves to CUDA and
raises when there is none.

Batching is a leading axis of same-capacity graphs (``stack_graphs``).
``flatten_stacked`` turns such a stack into one disjoint-union graph,
which is how the port runs a batch.

``MultiLevelGraph`` is the general MGKN's input: L levels of nodes in
one array, per-level edge sets concatenated at static capacities
(``build_multilevel_graph``), stacked by ``stack_graphs`` as well.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..utils import tracing

# Edge-block size of the receiver-span bound (the JAX package's
# ops/segment.py _SORTED_BLOCK_EB); also the edge padding multiple.
_SORTED_BLOCK_EB = 512


def round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


def _sorted_span_flag(receivers_padded: np.ndarray, limit: int = 64) -> int:
    """``limit`` when every 512-edge block of the sorted, padded receiver
    array spans fewer than ``limit`` nodes, else 0. The kcached fused
    iteration is gated on it, as in the JAX package."""
    eb = _SORTED_BLOCK_EB
    e = receivers_padded.shape[0]
    if e == 0 or e % eb != 0:
        return 0
    rb = receivers_padded.reshape(-1, eb)
    span = int((rb[:, -1] - rb[:, 0]).max()) + 1
    return limit if span <= limit else 0


def _sender_sort(senders_padded: np.ndarray):
    """Sender-sort permutation and its verified span, or (None, 0) when
    the span bound fails."""
    perm = np.argsort(senders_padded, kind="stable").astype(np.int32)
    span = _sorted_span_flag(senders_padded[perm])
    return (perm, span) if span else (None, 0)


def _to_tensor(a, device: torch.device):
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        on_host = a.device.type == "cpu"
        t = a.to(device)
    else:
        on_host = True
        a = np.asarray(a)
        if a.dtype == np.bool_:
            t = torch.as_tensor(a, device=device)
        elif np.issubdtype(a.dtype, np.integer):
            t = torch.as_tensor(a.astype(np.int64), device=device)
        else:
            t = torch.as_tensor(a.astype(np.float32), device=device)
    if on_host and device.type != "cpu":
        tracing.count("h2d_copies")
        tracing.count("h2d_bytes", t.nbytes)
    return t


_ARRAY_FIELDS = ("x", "senders", "receivers", "edge_attr", "n_node",
                 "n_edge", "y", "sample_idx", "edge_valid", "sender_perm")


@dataclasses.dataclass
class Graph:
    """A padded, receiver-sorted edge-list graph.

    Attributes:
      x: [N_pad, F] node features.
      senders: [E_pad] source node of each edge (message source).
      receivers: [E_pad] target node, sorted ascending; the padding tail
        points at N_pad - 1.
      edge_attr: [E_pad, A] edge features.
      n_node / n_edge: number of valid nodes / edges (valid prefixes).
      y: optional [N_pad, out] node targets.
      sample_idx: optional [N_pad] original-grid index of each node.
      edge_valid: optional explicit [E_pad] edge mask (blocked layout and
        flattened batches, where validity is not a prefix).
      node_block: blocked-CSR block size (0 = flat layout).
      sorted_span: host-verified receiver-span bound (0 = not verified).
      sender_perm / sender_span: sender-sort permutation and its bound.
    """

    x: object
    senders: object
    receivers: object
    edge_attr: object
    n_node: object
    n_edge: object
    y: object = None
    sample_idx: object = None
    edge_valid: object = None
    node_block: int = 0
    sorted_span: int = 0
    sender_perm: object = None
    sender_span: int = 0

    @property
    def num_nodes_padded(self) -> int:
        return self.x.shape[-2]

    @property
    def num_edges_padded(self) -> int:
        return self.senders.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.x.device

    def node_mask(self):
        """[N_pad] bool mask of valid nodes (torch graphs only); [B, N_pad]
        for a stacked batch, whose ``n_node`` is [B]."""
        ar = torch.arange(self.num_nodes_padded, device=self.x.device)
        n = torch.as_tensor(self.n_node, device=self.x.device)
        return ar < n.unsqueeze(-1)

    def edge_mask(self):
        """[E_pad] bool mask of valid edges (torch graphs only)."""
        if self.edge_valid is not None:
            return self.edge_valid
        ar = torch.arange(self.num_edges_padded, device=self.senders.device)
        return ar < self.n_edge

    def to(self, device: DeviceLike = None) -> "Graph":
        """This graph as torch tensors on ``device`` (None -> CUDA)."""
        dev = resolve_device(device)
        return dataclasses.replace(
            self, **{f: _to_tensor(getattr(self, f), dev)
                     for f in _ARRAY_FIELDS})


def build_graph(
    x: np.ndarray,
    senders: np.ndarray,
    receivers: np.ndarray,
    edge_attr: np.ndarray,
    *,
    n_node_pad: Optional[int] = None,
    n_edge_pad: Optional[int] = None,
    node_multiple: int = 8,
    edge_multiple: int = 512,
    y: Optional[np.ndarray] = None,
    sample_idx: Optional[np.ndarray] = None,
    node_block: int = 0,
    block_edge_cap: Optional[int] = None,
) -> Graph:
    """Pads and sorts host numpy arrays into a ``Graph``; the arrays are
    identical to the JAX package's ``build_graph``.

    Edges are sorted by (receiver, sender); capacities default to the
    actual sizes rounded up to ``node_multiple`` / ``edge_multiple``.
    With ``node_block`` set, nodes are grouped into blocks and each
    block's edge run is padded to a common capacity (blocked layout).
    """
    x = np.asarray(x, np.float32)
    if x.ndim == 1:
        x = x[:, None]
    senders = np.asarray(senders, np.int32).reshape(-1)
    receivers = np.asarray(receivers, np.int32).reshape(-1)
    edge_attr = np.asarray(edge_attr, np.float32)
    if edge_attr.ndim == 1:
        edge_attr = edge_attr[:, None]

    n, f = x.shape
    e, a = edge_attr.shape
    if senders.shape != (e,) or receivers.shape != (e,):
        raise ValueError(f"senders/receivers must have shape ({e},)")

    order = np.lexsort((senders, receivers))
    senders = senders[order]
    receivers = receivers[order]
    edge_attr = edge_attr[order]

    if node_block:
        n_pad = round_up(n_node_pad or n, node_block)
    else:
        n_pad = (n_node_pad if n_node_pad is not None
                 else round_up(max(n, 1), node_multiple))
    if n_pad < n:
        raise ValueError(f"node capacity {n_pad} < {n}")

    if node_block:
        n_blocks = n_pad // node_block
        starts = np.searchsorted(receivers,
                                 np.arange(n_blocks) * node_block)
        ends = np.append(starts[1:], e)
        per_block = ends - starts
        eb = block_edge_cap or round_up(int(per_block.max()),
                                        edge_multiple)
        if eb < per_block.max():
            raise ValueError(
                f"block edge capacity {eb} < {per_block.max()}")
        e_pad = n_blocks * eb
        sp = np.zeros((e_pad,), np.int32)
        rp = np.zeros((e_pad,), np.int32)
        ap = np.zeros((e_pad, a), np.float32)
        ev = np.zeros((e_pad,), bool)
        for b in range(n_blocks):
            cnt = per_block[b]
            o = b * eb
            sp[o:o + cnt] = senders[starts[b]:ends[b]]
            rp[o:o + cnt] = receivers[starts[b]:ends[b]]
            # padding inside block b parks on the block's last node
            rp[o + cnt:o + eb] = (b + 1) * node_block - 1
            ap[o:o + cnt] = edge_attr[starts[b]:ends[b]]
            ev[o:o + cnt] = True
        xp = np.zeros((n_pad, f), np.float32)
        xp[:n] = x
        sperm, sspan = _sender_sort(sp)
        return Graph(x=xp, senders=sp, receivers=rp, edge_attr=ap,
                     n_node=np.int32(n), n_edge=np.int32(e),
                     y=_pad_y(y, n_pad),
                     sample_idx=_pad_sample_idx(sample_idx, n_pad),
                     edge_valid=ev, node_block=node_block,
                     sender_perm=sperm, sender_span=sspan)

    e_pad = (n_edge_pad if n_edge_pad is not None
             else round_up(max(e, 1), edge_multiple))
    if e_pad < e:
        raise ValueError(f"edge capacity {e_pad} < {e}")

    xp = np.zeros((n_pad, f), np.float32)
    xp[:n] = x
    sp = np.zeros((e_pad,), np.int32)
    sp[:e] = senders
    rp = np.full((e_pad,), n_pad - 1, np.int32)
    rp[:e] = receivers
    ap = np.zeros((e_pad, a), np.float32)
    ap[:e] = edge_attr

    sperm, sspan = _sender_sort(sp)
    return Graph(
        x=xp,
        senders=sp,
        receivers=rp,
        edge_attr=ap,
        n_node=np.int32(n),
        n_edge=np.int32(e),
        y=_pad_y(y, n_pad),
        sample_idx=_pad_sample_idx(sample_idx, n_pad),
        sorted_span=_sorted_span_flag(rp),
        sender_perm=sperm,
        sender_span=sspan,
    )


def _pad_y(y, n_pad):
    if y is None:
        return None
    y = np.asarray(y, np.float32)
    if y.ndim == 1:
        y = y[:, None]
    yp = np.zeros((n_pad, y.shape[1]), np.float32)
    yp[: y.shape[0]] = y
    return yp


def _pad_sample_idx(sample_idx, n_pad):
    if sample_idx is None:
        return None
    sample_idx = np.asarray(sample_idx, np.int32).reshape(-1)
    sip = np.zeros((n_pad,), np.int32)
    sip[: sample_idx.shape[0]] = sample_idx
    return sip


def stack_graphs(graphs):
    """Stacks same-capacity host graphs (``Graph`` or
    ``MultiLevelGraph``) along a new leading batch axis. The span bounds
    of a ``Graph`` hold for the batch only if they hold for every
    member, so the stack keeps their minimum."""
    graphs = list(graphs)
    if isinstance(graphs[0], MultiLevelGraph):
        return _stack_multilevel(graphs)
    span = min(g.sorted_span for g in graphs)
    sspan = min(g.sender_span for g in graphs)
    fields = _stack_arrays(graphs, [f for f in _ARRAY_FIELDS
                                    if f != "sender_perm" or sspan])
    fields.setdefault("sender_perm", None)
    return Graph(**fields, node_block=graphs[0].node_block,
                 sorted_span=span, sender_span=sspan)


def _stack_arrays(graphs, names) -> dict:
    """name -> the graphs' arrays stacked on a new leading axis (None
    where no graph has the field)."""
    fields = {}
    for f in names:
        vals = [getattr(g, f) for g in graphs]
        if any(v is None for v in vals):
            if not all(v is None for v in vals):
                raise ValueError(f"field {f!r} is set on only some graphs")
            fields[f] = None
        else:
            fields[f] = np.stack([np.asarray(v) for v in vals])
    return fields


def flatten_stacked(g: Graph) -> Graph:
    """Flattens a stacked batch (torch tensors) into ONE disjoint-union
    graph: node indices of graph b are offset by b * N_pad.

    Receivers stay globally sorted (graph b's receivers, padding parked
    at its own N_pad - 1, land below graph b+1's), and per-graph edge
    capacities are 512-multiples, so the span bound still holds. Valid
    nodes are no longer a prefix: ``n_node``/``n_edge`` become the full
    capacities and edge validity rides the explicit ``edge_valid`` mask.
    """
    if g.node_block:
        raise ValueError("flatten_stacked: blocked-CSR not supported")
    if g.x.ndim != 3:
        raise ValueError("flatten_stacked expects a stacked batch")
    b, n_pad = g.x.shape[0], g.x.shape[1]
    e_pad = g.senders.shape[1]
    dev = g.senders.device
    offs = (torch.arange(b, device=dev) * n_pad)[:, None]
    if g.edge_valid is not None:
        ev = g.edge_valid
    else:
        ev = torch.arange(e_pad, device=dev)[None] < g.n_edge[:, None]
    sender_perm = None
    if g.sender_perm is not None:
        sender_perm = (g.sender_perm
                       + (torch.arange(b, device=dev) * e_pad)[:, None]
                       ).reshape(b * e_pad)
    return Graph(
        x=g.x.reshape(b * n_pad, -1),
        senders=(g.senders + offs).reshape(b * e_pad),
        receivers=(g.receivers + offs).reshape(b * e_pad),
        edge_attr=g.edge_attr.reshape(b * e_pad, -1),
        n_node=torch.tensor(b * n_pad, device=dev),
        n_edge=torch.tensor(b * e_pad, device=dev),
        y=None if g.y is None else g.y.reshape(b * n_pad, -1),
        sample_idx=(None if g.sample_idx is None
                    else g.sample_idx.reshape(b * n_pad)),
        edge_valid=ev.reshape(b * e_pad),
        sorted_span=g.sorted_span,
        sender_perm=sender_perm,
        sender_span=g.sender_span,
    )


def repad_edges(g: Graph, e_pad: int) -> Graph:
    """Grows a flat host graph's edge capacity to ``e_pad``: the tail is
    masked edges parked at receiver ``N_pad - 1``, as ``build_graph``
    pads, and the sender sort is rebuilt."""
    if g.node_block:
        raise ValueError("repad_edges: blocked-CSR not supported")
    e = g.senders.shape[0]
    if e_pad < e:
        raise ValueError(f"edge capacity {e_pad} < {e}")
    if e_pad == e:
        return g
    extra = e_pad - e
    n_pad = g.x.shape[0]
    receivers = np.concatenate(
        [np.asarray(g.receivers), np.full(extra, n_pad - 1, np.int32)])
    senders = np.concatenate(
        [np.asarray(g.senders), np.zeros(extra, np.int32)])
    sperm, sspan = _sender_sort(senders)
    return dataclasses.replace(
        g, senders=senders, receivers=receivers,
        edge_attr=np.concatenate(
            [np.asarray(g.edge_attr),
             np.zeros((extra, g.edge_attr.shape[1]), np.float32)]),
        sorted_span=_sorted_span_flag(receivers),
        sender_perm=sperm, sender_span=sspan)


def pad_capacities(graphs) -> tuple:
    """Max (node, edge) capacity over a list of pre-pad (n, e) tuples."""
    n_max = max(g[0] for g in graphs)
    e_max = max(g[1] for g in graphs)
    return n_max, e_max


# ---------------------------------------------------------- multilevel

_MULTILEVEL_ARRAYS = ("x", "mid_senders", "mid_receivers", "mid_attr",
                      "mid_mask", "down_senders", "down_receivers",
                      "down_attr", "down_mask", "up_senders",
                      "up_receivers", "up_attr", "up_mask", "y",
                      "sample_idx")
_MULTILEVEL_STATIC = ("points", "mid_ranges", "down_ranges", "up_ranges")


@dataclasses.dataclass
class MultiLevelGraph:
    """An L-level multipole graph in one node array (the JAX package's
    MultiLevelGraph), one sample or a stack of them.

    Level l holds rows [points[l], points[l + 1]); level sizes are fixed
    by the generator, so nodes carry no padding. Edge sets are
    concatenated with static per-level capacity ranges:

    - mid edges (K_ll): indices local to the level's slice;
    - down edges (K_{l,l+1}) and up edges (K_{l+1,l}): global indices
      over the whole node array.

    ``points`` and the ``*_ranges`` are plain tuples. Host graphs hold
    numpy arrays (int32 indices, as JAX's); ``to(device)`` gives torch
    tensors (float32 features, int64 indices, bool masks).
    """

    x: object
    mid_senders: object
    mid_receivers: object
    mid_attr: object
    mid_mask: object
    down_senders: object
    down_receivers: object
    down_attr: object
    down_mask: object
    up_senders: object
    up_receivers: object
    up_attr: object
    up_mask: object
    y: object = None
    sample_idx: object = None
    points: tuple = ()
    mid_ranges: tuple = ()
    down_ranges: tuple = ()
    up_ranges: tuple = ()

    @property
    def level(self) -> int:
        return len(self.points) - 1

    def to(self, device: DeviceLike = None) -> "MultiLevelGraph":
        """This graph as torch tensors on ``device`` (None -> CUDA)."""
        dev = resolve_device(device)
        return dataclasses.replace(
            self, **{f: _to_tensor(getattr(self, f), dev)
                     for f in _MULTILEVEL_ARRAYS})


def _stack_multilevel(graphs) -> MultiLevelGraph:
    first = graphs[0]
    for g in graphs[1:]:
        if any(getattr(g, f) != getattr(first, f)
               for f in _MULTILEVEL_STATIC):
            raise ValueError("stacked multilevel graphs need one set of "
                             "points and edge capacities")
    return MultiLevelGraph(**_stack_arrays(graphs, _MULTILEVEL_ARRAYS),
                           **{f: getattr(first, f)
                              for f in _MULTILEVEL_STATIC})


def _pad_edge_segments(edge_list, attr_list, caps, local_sizes,
                       edge_multiple):
    """Pads per-level (senders, receivers, attr) to static capacities and
    concatenates. ``local_sizes[l]`` is the padding receiver parking index
    for level l. Returns arrays + the static range tuple + capacities."""
    n_levels = len(edge_list)
    if caps is None:
        caps = tuple(round_up(max(e.shape[1], 1), edge_multiple)
                     for e in edge_list)
    a_dim = attr_list[0].shape[1]
    s_out, r_out, a_out, m_out, ranges = [], [], [], [], []
    start = 0
    for l in range(n_levels):
        e = edge_list[l].shape[1]
        cap = caps[l]
        if cap < e:
            raise ValueError(f"edge capacity {cap} < {e} at level {l}")
        src = np.asarray(edge_list[l][0], np.int64)
        dst = np.asarray(edge_list[l][1], np.int64)
        attr = np.asarray(attr_list[l], np.float32)
        order = np.lexsort((src, dst))
        src, dst, attr = src[order], dst[order], attr[order]
        sp = np.zeros(cap, np.int32)
        sp[:e] = src
        rp = np.full(cap, local_sizes[l] - 1, np.int32)
        rp[:e] = dst
        ap = np.zeros((cap, a_dim), np.float32)
        ap[:e] = attr
        mp = np.zeros(cap, bool)
        mp[:e] = True
        s_out.append(sp)
        r_out.append(rp)
        a_out.append(ap)
        m_out.append(mp)
        ranges.append((start, start + cap))
        start += cap
    return (np.concatenate(s_out), np.concatenate(r_out),
            np.concatenate(a_out), np.concatenate(m_out),
            tuple(ranges), tuple(caps))


def build_multilevel_graph(
    x: np.ndarray,
    level_sizes,
    mid_edges, mid_attrs,
    down_edges, down_attrs,
    up_edges, up_attrs,
    *,
    y: Optional[np.ndarray] = None,
    sample_idx: Optional[np.ndarray] = None,
    mid_caps=None, down_caps=None, up_caps=None,
    edge_multiple: int = 256,
) -> MultiLevelGraph:
    """Builds a host MultiLevelGraph from per-level edge lists, with the
    JAX package's arrays.

    ``mid_edges[l]`` use GLOBAL indices (as RandomMultiMeshGenerator
    makes them) and are made local to the level's slice here; down and
    up edges stay global. Each level's edges are sorted by (receiver,
    sender) and padded to its capacity (default: the count rounded up to
    ``edge_multiple``), padding parked at receiver ``level_sizes[l] - 1``
    (mid) or ``n_tot - 1`` (down, up). A single-level graph gets
    zero-size down and up placeholders."""
    level_sizes = tuple(int(m) for m in level_sizes)
    points = (0,) + tuple(np.cumsum(level_sizes).tolist())
    n_tot = points[-1]
    x = np.asarray(x, np.float32)
    if x.shape[0] != n_tot:
        raise ValueError(f"x has {x.shape[0]} rows, the levels {n_tot}")

    mid_local = []
    for l, ei in enumerate(mid_edges):
        ei = np.asarray(ei) - points[l]
        if ei.size and (ei.min() < 0 or ei.max() >= level_sizes[l]):
            raise ValueError(f"mid edges of level {l} leave its slice")
        mid_local.append(ei)

    mid = _pad_edge_segments(mid_local, mid_attrs, mid_caps, level_sizes,
                             edge_multiple)
    if len(down_edges) == 0:
        # single-level graphs (the neurips2_MGKN ablation) have no
        # inter-level edges; keep zero-size placeholders
        a_dim = mid[2].shape[1]
        empty = (np.zeros(0, np.int32), np.zeros(0, np.int32),
                 np.zeros((0, a_dim), np.float32), np.zeros(0, bool),
                 (), ())
        down = up = empty
    else:
        glob_sizes = [n_tot] * len(down_edges)
        down = _pad_edge_segments(down_edges, down_attrs, down_caps,
                                  glob_sizes, edge_multiple)
        up = _pad_edge_segments(up_edges, up_attrs, up_caps, glob_sizes,
                                edge_multiple)

    yp = None
    if y is not None:
        yp = np.asarray(y, np.float32)
        if yp.ndim == 1:
            yp = yp[:, None]
    sip = None
    if sample_idx is not None:
        sip = np.asarray(sample_idx, np.int32).reshape(-1)

    return MultiLevelGraph(
        x=x,
        mid_senders=mid[0], mid_receivers=mid[1], mid_attr=mid[2],
        mid_mask=mid[3],
        down_senders=down[0], down_receivers=down[1], down_attr=down[2],
        down_mask=down[3],
        up_senders=up[0], up_receivers=up[1], up_attr=up[2], up_mask=up[3],
        y=yp, sample_idx=sip,
        points=points, mid_ranges=mid[4], down_ranges=down[4],
        up_ranges=up[4],
    )


def multilevel_graph_from_padded(
    x: np.ndarray,
    level_sizes,
    senders: np.ndarray,
    receivers: np.ndarray,
    attr: np.ndarray,
    mask: np.ndarray,
    caps,
    *,
    sample_idx: Optional[np.ndarray] = None,
) -> MultiLevelGraph:
    """A host MultiLevelGraph from its edge arrays already padded as
    ``build_multilevel_graph`` pads them (``native.native_place_windows``
    writes them so): the mid, down and up lists concatenated, list by
    list at the capacities ``caps`` = (mid, down, up). The graph's edge
    fields are views of the given arrays."""
    level_sizes = tuple(int(m) for m in level_sizes)
    points = (0,) + tuple(np.cumsum(level_sizes).tolist())
    x = np.asarray(x, np.float32)
    if x.shape[0] != points[-1]:
        raise ValueError(f"x has {x.shape[0]} rows, the levels {points[-1]}")
    groups, ranges, start = [], [], 0
    for group_caps in caps:
        end = start + sum(group_caps)
        groups.append(slice(start, end))
        bounds = np.concatenate([[0], np.cumsum(group_caps)]).tolist()
        ranges.append(tuple(zip(bounds[:-1], bounds[1:])))
        start = end
    if start != senders.shape[0]:
        raise ValueError(f"{senders.shape[0]} edges for capacities {caps}")
    mid, down, up = groups
    sip = None
    if sample_idx is not None:
        sip = np.asarray(sample_idx, np.int32).reshape(-1)
    return MultiLevelGraph(
        x=x,
        mid_senders=senders[mid], mid_receivers=receivers[mid],
        mid_attr=attr[mid], mid_mask=mask[mid],
        down_senders=senders[down], down_receivers=receivers[down],
        down_attr=attr[down], down_mask=mask[down],
        up_senders=senders[up], up_receivers=receivers[up],
        up_attr=attr[up], up_mask=mask[up],
        sample_idx=sip, points=points, mid_ranges=ranges[0],
        down_ranges=ranges[1], up_ranges=ranges[2],
    )


@dataclasses.dataclass
class NodeBatch:
    """Per-sample node data on a SHARED edge structure.

    The full-grid lattice (neurips4_GCN.py:133) is the same for every
    sample, so one template ``Graph`` holds the edges and a batch carries
    only what varies: node features, targets and the valid-node count.
    ``map_arrays``, ``leading_size`` and ``batch_iterator`` take it as any
    dataclass of arrays."""

    x: object            # [B, N_pad, F]
    y: object            # [B, N_pad, out]
    n_node: object       # [B]


__all__ = [
    "Graph",
    "MultiLevelGraph",
    "NodeBatch",
    "build_graph",
    "build_multilevel_graph",
    "multilevel_graph_from_padded",
    "pad_capacities",
    "stack_graphs",
    "flatten_stacked",
    "repad_edges",
    "round_up",
]
