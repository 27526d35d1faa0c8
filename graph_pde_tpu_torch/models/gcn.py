"""The GCN baseline (counterpart of graph_pde_tpu/models/gcn.py;
neurips4_GCN.py:20-54).

Four distinct GCNConv layers iterated ``depth`` times, then a two-layer
head: the reference's demonstration that a plain GCN fails at operator
learning. GCNConv follows PyG: x' = D^-1/2 (A + I) D^-1/2 x W + b, with
the self-loop added analytically (one 1/deg term), so padded edge lists
need no self-edges. Padded nodes keep degree 1 and carry values, as in
the JAX package; the node mask keeps them out of the loss.

The aggregation is a masked ``index_add_`` on either layout: a blocked
graph (``node_block``) parks its padding edges under mask 0, so it sums
as the flat one does. The JAX package's one-hot and blocked one-hot
forms are TPU workarounds for XLA's serial scatter and have no
counterpart here. ``gcn_apply`` takes the node features of one graph
[N_pad, F], or of a batch of samples on the graph's shared edges [B,
N_pad, F] (GCNTask's template layout): the batch then indexes the node
axis with the template's edge lists instead of copying them per sample.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..device import DeviceLike
from ..graph.graph import Graph
from ..ops.dense import linear_init
from ..ops.segment import segment_degrees
from .gkn import _as_tensors, _member, params_to


@dataclasses.dataclass(frozen=True)
class GCNConfig:
    width: int = 128
    ker_width: int = 256
    depth: int = 1
    in_width: int = 6
    out_width: int = 1


def gcn_init(gen: torch.Generator, cfg: GCNConfig, *,
             device: DeviceLike = None):
    """torch.nn.Linear default draws from ``gen``, in the JAX layout, on
    ``device`` (``None``: CUDA, or an error without a GPU)."""
    return {
        "fc_in": linear_init(gen, cfg.in_width, cfg.width, device=device),
        "convs": [linear_init(gen, cfg.width, cfg.width, device=device)
                  for _ in range(4)],
        "fc_out1": linear_init(gen, cfg.width, cfg.ker_width,
                               device=device),
        "fc_out2": linear_init(gen, cfg.ker_width, cfg.out_width,
                               device=device),
    }


def degree_terms(receivers: torch.Tensor, edge_mask: torch.Tensor,
                 n: int):
    """(rsqrt(deg), 1 / deg) with deg = masked in-degree + 1 (the self
    loop): structural, so computed once a forward."""
    deg = segment_degrees(receivers, edge_mask, n) + 1.0
    return torch.rsqrt(deg), 1.0 / deg


def gcn_conv(x, senders, receivers, edge_mask, layer, inv_sqrt=None,
             inv_deg=None) -> torch.Tensor:
    """One GCNConv: [..., N, in] -> [..., N, out] (the leading axes are
    samples sharing the edge lists). ``inv_sqrt``/``inv_deg`` are
    ``degree_terms``, computed here when not given."""
    n = x.shape[-2]
    if inv_sqrt is None:
        inv_sqrt, inv_deg = degree_terms(receivers, edge_mask, n)
    xw = x @ layer["w"]
    scale = (inv_sqrt[senders] * edge_mask.to(xw.dtype))[:, None]
    msg = xw.index_select(-2, senders) * scale
    agg = torch.zeros_like(xw).index_add_(xw.ndim - 2, receivers, msg)
    out = inv_sqrt[:, None] * agg + inv_deg[:, None] * xw
    return out + layer["b"]


def gcn_apply(params, cfg: GCNConfig, graph: Graph,
              x: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Forward on one padded graph -> [N_pad, out_width], or, with ``x``
    [B, N_pad, in_width], on a batch of samples sharing ``graph``'s edges
    -> [B, N_pad, out_width]. A host graph moves to the default device
    (CUDA, or an error)."""
    graph = _as_tensors(graph)
    params = params_to(params, graph.device)
    x = graph.x if x is None else x
    mask = graph.edge_mask()
    x = x @ params["fc_in"]["w"] + params["fc_in"]["b"]
    inv_sqrt, inv_deg = degree_terms(graph.receivers, mask, x.shape[-2])
    for _ in range(cfg.depth):
        for conv in params["convs"]:
            x = torch.relu(gcn_conv(x, graph.senders, graph.receivers, mask,
                                    conv, inv_sqrt, inv_deg))
    x = torch.relu(x @ params["fc_out1"]["w"] + params["fc_out1"]["b"])
    return x @ params["fc_out2"]["w"] + params["fc_out2"]["b"]


def gcn_apply_batched(params, cfg: GCNConfig, graphs: Graph) -> torch.Tensor:
    """Forward over a stacked batch of graphs, each with its own edges ->
    [B, N_pad, out_width]."""
    graphs = _as_tensors(graphs)
    return torch.stack([gcn_apply(params, cfg, _member(graphs, b))
                        for b in range(graphs.x.shape[0])])


__all__ = ["GCNConfig", "gcn_init", "gcn_apply", "gcn_apply_batched",
           "gcn_conv", "degree_terms"]
