"""MGKN (general, non-nested multilevel): the multipole graph kernel
network (counterpart of graph_pde_tpu/models/mgkn_general.py).

Three variants of the reference:

- ``mkgn`` (MGKN_general_darcy2d.py:21-94), the flagship: each V-cycle
  runs the downward residual K_{l,l+1} convs with ReLU; upward, K_ll
  replaces the level's node slice (no ReLU, root weight) and is followed
  by the residual K_{l+1,l} conv with ReLU; the finest level is decoded.
- ``induced`` (neurips1_MGKN.py:20-89): K_ll is a residual on the
  level's slice with ReLU; no conv has a root weight or a bias.
- ``single`` (neurips2_MGKN.py:74-78): only the finest level's K_00 runs
  (residual + ReLU) each depth step; the other convs keep their
  parameters and never run.

Kernel widths halve per level (``ker_width // 2**l``); mid kappas have
two hidden layers, down and up kappas one (MGKN_general_darcy2d.py:
43-62). The reference's in-place slice update is a new tensor here (the
level's slice concatenated between the untouched rows), so autograd
never sees a saved tensor written to.

Every conv is one ``edge_kernel_conv``. ``impl='kcached'`` evaluates
every conv's kappa once per forward and hands each conv its K, through
the port's kcached layer (ops/kcached_loop.py). On CUDA, 'auto' takes
the K1 kernel (ops/fused_edge_conv.py) at every conv the JAX gate
admits, and B1-bwd in the backward.

A batch runs as one flattened graph per edge list: sample b's mid edges
offset by b * n_l (local indices on the level's slice), its down and up
edges by b * N_tot; each level's slice is taken on the [B, N_tot, w]
view. The impl gate sees one sample's edge count.

Spans (``utils.tracing``): ``kbuild`` around the kcached K build, and
one ``conv.mid``, ``conv.down`` or ``conv.up`` around each conv (its
gather, contraction, aggregation and root weight), 7 a V-cycle at
three levels.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..device import DeviceLike
from ..graph.graph import MultiLevelGraph
from ..ops.dense import dense_init, linear_init, pyg_uniform_init
from ..ops.edge_conv import edge_kernel_conv
from ..ops.kcached_loop import build_cached_k
from ..utils import tracing
from .gkn import params_to

VARIANTS = ("mkgn", "induced", "single")
_CONV_SPANS = {"mid": "conv.mid", "down": "conv.down", "up": "conv.up"}


@dataclasses.dataclass(frozen=True)
class MGKNGeneralConfig:
    width: int = 64
    ker_width: int = 256
    depth: int = 5
    ker_in: int = 6
    in_width: int = 6
    out_width: int = 1
    points: Tuple[int, ...] = (400, 100, 25)  # per-level node counts
    variant: str = "mkgn"  # 'mkgn' (flagship) | 'induced' (neurips1) |
    #                        'single' (neurips2 level ablation)
    impl: str = "auto"
    compute_dtype: Optional[str] = None
    # kcached only: fp8 straight-through storage of the cached kernel
    # matrices ('float8_e4m3' / 'float8_e5m2')
    k_storage: Optional[str] = None

    @property
    def level(self) -> int:
        return len(self.points)

    def offsets(self) -> Tuple[int, ...]:
        out = [0]
        for p in self.points:
            out.append(out[-1] + p)
        return tuple(out)


def level_kernel_width(cfg: MGKNGeneralConfig, l: int) -> int:
    """The kappa width of level l's convs: ker_width halved per level."""
    return cfg.ker_width // (2 ** l)


def mgkn_general_init(gen: torch.Generator, cfg: MGKNGeneralConfig, *,
                      device: DeviceLike = None):
    """Parameters drawn from ``gen`` with the JAX package's
    distributions, in its layout and order, on ``device`` (None: CUDA,
    or an error without a GPU)."""
    if cfg.variant not in VARIANTS:
        raise ValueError(f"unknown variant {cfg.variant!r}")
    w2 = cfg.width ** 2
    params = {"fc_in": linear_init(gen, cfg.in_width, cfg.width,
                                   device=device),
              "conv_down": [], "conv_mid": [], "conv_up": []}
    for l in range(1, cfg.level):
        kw = level_kernel_width(cfg, l)
        params["conv_down"].append({"kernel": dense_init(
            gen, (cfg.ker_in, kw, w2), device=device)})
    for l in range(cfg.level):
        kw = level_kernel_width(cfg, l)
        conv = {"kernel": dense_init(gen, (cfg.ker_in, kw, kw, w2),
                                     device=device)}
        if cfg.variant == "mkgn":   # root_weight=True on K_ll
            conv["root"] = pyg_uniform_init(gen, cfg.width,
                                            (cfg.width, cfg.width),
                                            device=device)
        params["conv_mid"].append(conv)
    for l in range(1, cfg.level):
        kw = level_kernel_width(cfg, l)
        params["conv_up"].append({"kernel": dense_init(
            gen, (cfg.ker_in, kw, w2), device=device)})
    params["fc_out1"] = linear_init(gen, cfg.width, cfg.ker_width,
                                    device=device)
    params["fc_out2"] = linear_init(gen, cfg.ker_width, cfg.out_width,
                                    device=device)
    return params


@dataclasses.dataclass
class _Edges:
    """One conv's edge list of a flattened batch."""
    senders: torch.Tensor
    receivers: torch.Tensor
    attr: torch.Tensor
    mask: torch.Tensor
    per_graph: int      # one sample's edge count, for the impl gate


def _edges(g: MultiLevelGraph, kind: str, l: int, stride: int) -> _Edges:
    """Level l's range of edge list ``kind`` ('mid', 'down', 'up'), sample
    b's node indices offset by b * stride."""
    r0, r1 = getattr(g, f"{kind}_ranges")[l]
    se = getattr(g, f"{kind}_senders")[:, r0:r1]
    b = se.shape[0]
    off = (torch.arange(b, device=se.device) * stride)[:, None]
    attr = getattr(g, f"{kind}_attr")[:, r0:r1]
    return _Edges(senders=(se + off).reshape(-1),
                  receivers=(getattr(g, f"{kind}_receivers")[:, r0:r1]
                             + off).reshape(-1),
                  attr=attr.reshape(-1, attr.shape[-1]),
                  mask=getattr(g, f"{kind}_mask")[:, r0:r1].reshape(-1),
                  per_graph=r1 - r0)


def _precompute_kernels(params, cfg, edges) -> dict:
    """impl='kcached': the K of every conv that runs ('single' runs only
    K_00, and ``edges`` holds only its list), once per forward."""
    return {kind: [build_cached_k(params[f"conv_{kind}"][l]["kernel"],
                                  ed.attr, compute_dtype=cfg.compute_dtype,
                                  k_storage=cfg.k_storage)
                   for l, ed in enumerate(edges[kind])]
            for kind in ("down", "mid", "up")}


def _set_rows(x3, p0, p1, rows):
    """x3 [B, N, w] with rows p0:p1 replaced by ``rows``, as a new
    tensor."""
    return torch.cat([x3[:, :p0], rows, x3[:, p1:]], dim=1)


def _forward(params, cfg: MGKNGeneralConfig, g: MultiLevelGraph):
    if cfg.variant not in VARIANTS:
        raise ValueError(f"unknown variant {cfg.variant!r}")
    offs = cfg.offsets()
    b, n_tot, w = g.x.shape[0], offs[-1], cfg.width
    single = cfg.variant == "single"
    levels = 1 if single else cfg.level
    edges = {
        "mid": [_edges(g, "mid", l, offs[l + 1] - offs[l])
                for l in range(levels)],
        "down": [] if single else [_edges(g, "down", l, n_tot)
                                   for l in range(cfg.level - 1)],
        "up": [] if single else [_edges(g, "up", l, n_tot)
                                 for l in range(cfg.level - 1)],
    }
    kks = None
    if cfg.impl == "kcached":
        with tracing.span("kbuild"):
            kks = _precompute_kernels(params, cfg, edges)

    def conv(x, kind, l):
        """One conv (mean aggregation, the conv's root weight where it
        has one, no bias) on a flattened node array."""
        ed, cp = edges[kind][l], params[f"conv_{kind}"][l]
        with tracing.span(_CONV_SPANS[kind]):
            return edge_kernel_conv(
                x, ed.senders, ed.receivers, ed.attr, ed.mask, cp["kernel"],
                in_channels=w, out_channels=w, aggr="mean",
                root=cp.get("root"), bias=None, impl=cfg.impl,
                compute_dtype=cfg.compute_dtype, gate_edges=ed.per_graph,
                cached_k=None if kks is None else kks[kind][l])

    def mid(x3, l):
        """K_ll on level l's slice of every sample: [B, n_l, w]."""
        p0, p1 = offs[l], offs[l + 1]
        out = conv(x3[:, p0:p1].reshape(b * (p1 - p0), w), "mid", l)
        return out.view(b, p1 - p0, w)

    def residual(x3, kind, l):
        x = x3.reshape(b * n_tot, w)
        return torch.relu(x + conv(x, kind, l)).view(b, n_tot, w)

    x3 = (g.x @ params["fc_in"]["w"] + params["fc_in"]["b"])
    for _ in range(cfg.depth):
        if single:
            # neurips2_MGKN.py:74-78: residual K_00 on the finest
            # level's slice + ReLU on the full array; no down/up pass
            x3 = torch.relu(_set_rows(x3, 0, offs[1],
                                      x3[:, :offs[1]] + mid(x3, 0)))
            continue
        for l in range(cfg.level - 1):
            x3 = residual(x3, "down", l)
        for l in reversed(range(cfg.level)):
            p0, p1 = offs[l], offs[l + 1]
            if cfg.variant == "mkgn":
                # K_ll replaces the slice, no ReLU
                # (MGKN_general_darcy2d.py:84-86)
                x3 = _set_rows(x3, p0, p1, mid(x3, l))
            else:
                # residual K_ll on the slice + ReLU (neurips1_MGKN.py:79-81)
                x3 = torch.relu(_set_rows(x3, p0, p1,
                                          x3[:, p0:p1] + mid(x3, l)))
            if l > 0:
                x3 = residual(x3, "up", l - 1)

    x0 = x3[:, :offs[1]]
    x0 = torch.relu(x0 @ params["fc_out1"]["w"] + params["fc_out1"]["b"])
    return x0 @ params["fc_out2"]["w"] + params["fc_out2"]["b"]


def _as_tensors(g: MultiLevelGraph) -> MultiLevelGraph:
    """A host graph moves to the default device (CUDA, or an error)."""
    return g if isinstance(g.x, torch.Tensor) else g.to()


def mgkn_general_apply(params, cfg: MGKNGeneralConfig,
                       g: MultiLevelGraph) -> torch.Tensor:
    """Forward on one multilevel graph -> [points[0], out_width] (the
    finest level's nodes) on the graph's device."""
    g = _as_tensors(g)
    batch = dataclasses.replace(g, **{
        f.name: getattr(g, f.name)[None]
        for f in dataclasses.fields(g)
        if isinstance(getattr(g, f.name), torch.Tensor)})
    return mgkn_general_apply_batched(params, cfg, batch)[0]


def mgkn_general_apply_batched(params, cfg: MGKNGeneralConfig,
                               graphs: MultiLevelGraph) -> torch.Tensor:
    """Forward on a stacked batch -> [B, points[0], out_width], run as one
    flattened graph per edge list."""
    graphs = _as_tensors(graphs)
    if tuple(graphs.points) != cfg.offsets():
        raise ValueError(f"graph levels {graphs.points} are not the "
                         f"config's {cfg.offsets()}")
    params = params_to(params, graphs.x.device)
    return _forward(params, cfg, graphs)


__all__ = [
    "MGKNGeneralConfig",
    "mgkn_general_init",
    "mgkn_general_apply",
    "mgkn_general_apply_batched",
    "level_kernel_width",
]
