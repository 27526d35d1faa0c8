"""MGKN (orthogonal, 1-d): a nested multipole hierarchy on a dyadic grid
(counterpart of graph_pde_tpu/models/mgkn_orthogonal.py).

Levels share one node set downsampled by 2; the inter-level transfers
are nearest-neighbor upsampling and average pooling on the width
channels (ops/pooling.py), and each level applies a full edge-kernel
conv on its FMM edge list (nearest-neighbor edges at the finest level,
"interactive" |dx| in {2, 3} edges per level, graph/multipole.py).

V-cycle (MGKN_orthogonal_burgers1d.py:59-86): the per-level states phi
are stored on the way down; the coarsest level and every level on the
way up apply a residual conv with ReLU. Kernel widths halve per level
with a floor of 16. Convs are PyG NNConv defaults: mean aggregation,
root weight and bias.

Every conv is one ``edge_kernel_conv``. ``impl='kcached'`` evaluates
each level's kernel MLP once per forward and hands each conv its K,
through the port's kcached layer (ops/kcached_loop.py). On CUDA, 'auto'
takes the K1 kernel (ops/fused_edge_conv.py) at every level the JAX
gate admits, and B1-bwd in the backward.

A batch runs as one flattened graph per edge list (node offsets b * s_l,
the same messages and means as JAX's per-sample vmap); the impl gate
sees one sample's edge count.

Spans (``utils.tracing``): ``kbuild`` around the kcached K build;
``conv.fine`` around each conv on edge lists 0 and 1 (the finest
level's nearest-neighbour and interactive edges) and ``conv.coarse``
around each conv on lists 2 and up (its gather, contraction, mean, root
and bias); ``pool`` and ``upsample`` around each inter-level transfer.
The counter ``k_bytes`` adds the bytes of the K matrices each kcached
forward builds, from their shapes.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..device import DeviceLike
from ..ops.dense import dense_init, linear_init, pyg_uniform_init
from ..ops.edge_conv import edge_kernel_conv
from ..ops.kcached_loop import build_cached_k
from ..ops.pooling import avg_pool_1d, upsample_nearest_1d
from ..utils import tracing
from .gkn import params_to


@dataclasses.dataclass
class MultipoleGraph1D:
    """The orthogonal MGKN's input, one sample or a stacked batch.

    Edge lists are ordered [NN(finest), inter(level 1), ..., inter(level
    L)] as graph/multipole.py builds them; list l indexes the nodes of
    level max(l, 1). Arrays carry a leading batch axis in a batch
    (senders/receivers stored per sample, as in the JAX package)."""

    x: torch.Tensor                     # [s, in_width]
    senders: List[torch.Tensor]         # level+1 arrays [E_l]
    receivers: List[torch.Tensor]
    attrs: List[torch.Tensor]           # [E_l, 4] each
    y: Optional[torch.Tensor] = None    # [s, out]

    def to(self, device: DeviceLike = None) -> "MultipoleGraph1D":
        """Every array as a tensor on ``device`` (None: CUDA)."""
        from ..device import resolve_device

        dev = resolve_device(device)

        def t(a):
            return torch.as_tensor(a).to(dev)

        return MultipoleGraph1D(
            x=t(self.x), senders=[t(v) for v in self.senders],
            receivers=[t(v) for v in self.receivers],
            attrs=[t(v) for v in self.attrs],
            y=None if self.y is None else t(self.y))


def multipole_batch(xs, ys, senders, receivers, attrs) -> MultipoleGraph1D:
    """A stacked host batch from ``burgers_multipole_data``'s output:
    the shared edge lists repeated per sample."""
    n = xs.shape[0]
    return MultipoleGraph1D(
        x=xs, senders=[np.repeat(se[None], n, axis=0) for se in senders],
        receivers=[np.repeat(r[None], n, axis=0) for r in receivers],
        attrs=list(attrs), y=ys)


@dataclasses.dataclass(frozen=True)
class MGKNOrthogonalConfig:
    width: int = 64
    ker_width: int = 1024
    depth: int = 4
    ker_in: int = 4
    in_width: int = 2
    out_width: int = 1
    s: int = 1024
    impl: str = "auto"
    compute_dtype: Optional[str] = None
    # kcached only: fp8 straight-through storage of each level's cached
    # kernel matrices ('float8_e4m3' / 'float8_e5m2')
    k_storage: Optional[str] = None

    @property
    def level(self) -> int:
        return int(np.log2(self.s) - 1)


def level_kernel_width(cfg: MGKNOrthogonalConfig, idx: int) -> int:
    """The kappa width of edge list ``idx``: ker_width halved per level,
    at least 16."""
    return max(cfg.ker_width // (2 ** idx), 16)


def mgkn_orthogonal_init(gen: torch.Generator, cfg: MGKNOrthogonalConfig,
                         *, device: DeviceLike = None):
    """Parameters drawn from ``gen`` with the JAX package's
    distributions, in its layout and draw order, on ``device`` (None:
    CUDA, or an error without a GPU)."""
    params = {"fc1": linear_init(gen, cfg.in_width, cfg.width,
                                 device=device),
              "conv": []}
    for l in range(cfg.level + 1):
        kw = level_kernel_width(cfg, l)
        params["conv"].append({
            "kernel": dense_init(gen, (cfg.ker_in, kw, kw, cfg.width ** 2),
                                 device=device),
            "root": pyg_uniform_init(gen, cfg.width, (cfg.width, cfg.width),
                                     device=device),
            "bias": pyg_uniform_init(gen, cfg.width, (cfg.width,),
                                     device=device),
        })
    params["fc2"] = linear_init(gen, cfg.width, cfg.ker_width, device=device)
    params["fc3"] = linear_init(gen, cfg.ker_width, cfg.out_width,
                                device=device)
    return params


def _flatten(g: MultipoleGraph1D, s: int):
    """(x [B*s, in], senders, receivers, attrs) of a stacked batch as one
    graph per edge list: sample b's level-l nodes offset by b * s_l."""
    b = g.x.shape[0]
    senders, receivers, attrs = [], [], []
    for idx, (se, r, a) in enumerate(zip(g.senders, g.receivers, g.attrs)):
        s_l = s // 2 ** max(idx - 1, 0)
        off = (torch.arange(b, device=se.device) * s_l)[:, None]
        senders.append((se + off).reshape(-1))
        receivers.append((r + off).reshape(-1))
        attrs.append(a.reshape(b * a.shape[1], a.shape[2]))
    return g.x.reshape(-1, g.x.shape[-1]), senders, receivers, attrs


def _forward(params, cfg: MGKNOrthogonalConfig, x, senders, receivers,
             attrs, gate_edges) -> torch.Tensor:
    level, w = cfg.level, cfg.width
    kks = None
    if cfg.impl == "kcached":
        with tracing.span("kbuild"):
            kks = [build_cached_k(cp["kernel"], a,
                                  compute_dtype=cfg.compute_dtype,
                                  k_storage=cfg.k_storage)
                   for cp, a in zip(params["conv"], attrs)]
        tracing.count("k_bytes", sum(k.numel() * k.element_size()
                                     for k in kks))

    def conv(h, idx):
        with tracing.span("conv.fine" if idx < 2 else "conv.coarse"):
            cp = params["conv"][idx]
            e = senders[idx].shape[0]
            mask = torch.ones(e, dtype=torch.bool, device=h.device)
            return edge_kernel_conv(
                h, senders[idx], receivers[idx], attrs[idx], mask,
                cp["kernel"], in_channels=w, out_channels=w, aggr="mean",
                root=cp["root"], bias=cp["bias"], impl=cfg.impl,
                compute_dtype=cfg.compute_dtype, gate_edges=gate_edges[idx],
                cached_k=None if kks is None else kks[idx])

    x = x @ params["fc1"]["w"] + params["fc1"]["b"]
    for _ in range(cfg.depth):
        phi = [None] * level
        for l in range(level):
            phi[l] = x
            if l != level - 1:
                with tracing.span("pool"):
                    x = avg_pool_1d(x, 2)
        # coarsest: the interactive edges of the deepest level
        x = torch.relu(x + conv(phi[-1], level))
        for l in reversed(range(level)):
            if l != 0:
                with tracing.span("upsample"):
                    x = upsample_nearest_1d(x, 2)
                x = torch.relu(x + conv(phi[l - 1], l))
            else:
                x = torch.relu(x + conv(phi[0], 0))
    x = torch.relu(x @ params["fc2"]["w"] + params["fc2"]["b"])
    return x @ params["fc3"]["w"] + params["fc3"]["b"]


def _as_tensors(g: MultipoleGraph1D) -> MultipoleGraph1D:
    """A host graph moves to the default device (CUDA, or an error)."""
    return g if isinstance(g.x, torch.Tensor) else g.to()


def mgkn_orthogonal_apply(params, cfg: MGKNOrthogonalConfig,
                          g: MultipoleGraph1D) -> torch.Tensor:
    """Forward on one sample -> [s, out_width] on the graph's device."""
    g = _as_tensors(g)
    batch = MultipoleGraph1D(x=g.x[None], senders=[v[None] for v in g.senders],
                             receivers=[v[None] for v in g.receivers],
                             attrs=[v[None] for v in g.attrs])
    return mgkn_orthogonal_apply_batched(params, cfg, batch)[0]


def mgkn_orthogonal_apply_batched(params, cfg: MGKNOrthogonalConfig,
                                  graphs: MultipoleGraph1D) -> torch.Tensor:
    """Forward on a stacked batch -> [B, s, out_width], run as one
    flattened graph per edge list."""
    graphs = _as_tensors(graphs)
    b, s = graphs.x.shape[0], graphs.x.shape[1]
    if s != cfg.s:
        raise ValueError(f"graph has s={s} nodes, the config s={cfg.s}")
    params = params_to(params, graphs.x.device)
    x, senders, receivers, attrs = _flatten(graphs, s)
    gate = [se.shape[-1] for se in graphs.senders]
    out = _forward(params, cfg, x, senders, receivers, attrs, gate)
    return out.reshape(b, s, -1)


__all__ = [
    "MultipoleGraph1D",
    "MGKNOrthogonalConfig",
    "mgkn_orthogonal_init",
    "mgkn_orthogonal_apply",
    "mgkn_orthogonal_apply_batched",
    "multipole_batch",
    "level_kernel_width",
]
