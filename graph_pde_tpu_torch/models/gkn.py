"""GKN, the Graph Kernel Network (counterpart of
graph_pde_tpu/models/gkn.py).

Forward: x = fc1(x); depth x [shared edge-kernel conv + ReLU, except
after the last step unless relu_last]; decode. The conv weights are
shared across the depth steps.

``impl='kcached'`` computes the kernel matrices K once per forward and
reuses them at every depth step, either through the port's kcached layer
(ops/kcached_loop.py: ``build_cached_k`` and ``edge_kernel_conv``'s
kcached path) or, with ``kcached_fused``, through the K2 kernel
(ops/fused_iterate.py).
``k_storage`` ('float8_e4m3' / 'float8_e5m2') stores K in fp8: the fused
path hands both kernels a 1-byte copy k8 and its dK lands on the
full-precision K; the unfused path quantizes K behind a straight-through
estimator. Every path is differentiable: the fused ops are autograd
Functions with backward kernels, and autograd differentiates the cached
K's build. ``loop_vjp`` (unfused path, flat graphs) runs the depth loop
as one autograd Function whose backward builds dK once. A batch runs as
one flattened graph, but its gates read one graph's sizes (as the JAX
package's per-graph vmap does), so a config takes the same branch in
both packages, and on the CPU the same K dtype.

The cached K is stored in the configuration's dtype (bf16 under a bf16
compute dtype, else float32; ``cached_k_dtype``). On a card that holds
whatever the card holds: a K too large for it fails loudly. On the CPU
the JAX package's 2 GiB gate stays, so that the parity tests keep its K
dtype: a float32 K above it is bf16, and the counter ``k_lowered`` says
so.

Spans and counters (``utils.tracing``, impl='kcached'): ``kbuild`` around
the K build and ``k_bytes`` adding K's bytes once a forward;
``conv.iterate`` around each depth step of the fused loop.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..device import DeviceLike
from ..graph.graph import Graph, flatten_stacked
from ..ops.cached_contraction import to_fp8
from ..ops.dense import dense_init, linear_init, pyg_uniform_init
from ..ops.edge_conv import edge_kernel_conv
from ..ops.fused_iterate import (fused_iterate_supported,
                                 fused_iterate_total, sorted_iterate_setup)
from ..ops.kcached_loop import build_cached_k, kcached_depth_loop
from ..utils import tracing

# The JAX package's one-hot gate (ops/segment.py _ONEHOT_MAX_BYTES): the
# kcached_fused='auto' rule fuses only where that one-hot would not apply.
_ONEHOT_MAX_BYTES = 64 * 1024 * 1024
# On the CPU, above this many bytes of float32 K per graph the cached K
# is bf16 (the JAX package's gate, models/gkn.py:154 there).
_KCACHED_F32_MAX_BYTES = 2 * 1024 ** 3


@dataclasses.dataclass(frozen=True)
class GKNConfig:
    width: int = 64
    ker_width: int = 1024
    depth: int = 6
    ker_in: int = 6
    in_width: int = 6
    out_width: int = 1
    kernel_layers: Optional[Tuple[int, ...]] = None  # default: KernelNN
    relu_last: bool = True      # ReLU after the final conv iteration
    decoder_mlp: bool = False   # two-layer decoder
    aggr: str = "mean"
    root_weight: bool = True
    use_bias: bool = True
    impl: str = "auto"
    compute_dtype: Optional[str] = None  # e.g. 'bfloat16'
    loop_vjp: bool = False      # kcached: one backward for the depth loop
    batch_mode: str = "vmap"    # gates see one graph ('vmap') or the batch
    k_storage: Optional[str] = None  # kcached K: 'float8_e4m3'|'float8_e5m2'
    kcached_fused: str = "off"  # 'off' | 'on' | 'auto'

    def resolved_kernel_layers(self) -> Tuple[int, ...]:
        if self.kernel_layers is not None:
            return tuple(self.kernel_layers)
        return (self.ker_in, self.ker_width, self.ker_width,
                self.width ** 2)

    @staticmethod
    def kernel_nn3_layers(ker_in: int, ker_width: int, width: int):
        return (ker_in, ker_width // 2, ker_width, width ** 2)


def gkn_init(gen: torch.Generator, cfg: GKNConfig, *,
             device: DeviceLike = None):
    """Parameters drawn from ``gen`` with the JAX package's
    distributions (torch.nn.Linear defaults; PyG uniform for root and
    bias), in the JAX layout, on ``device`` (``None``: CUDA, or an error
    without a GPU)."""
    params = {
        "fc1": linear_init(gen, cfg.in_width, cfg.width, device=device),
        "kernel": dense_init(gen, cfg.resolved_kernel_layers(),
                             device=device),
    }
    if cfg.root_weight:
        params["root"] = pyg_uniform_init(gen, cfg.width,
                                          (cfg.width, cfg.width),
                                          device=device)
    if cfg.use_bias:
        params["bias"] = pyg_uniform_init(gen, cfg.width, (cfg.width,),
                                          device=device)
    if cfg.decoder_mlp:
        params["fc2"] = linear_init(gen, cfg.width, cfg.ker_width,
                                    device=device)
        params["fc3"] = linear_init(gen, cfg.ker_width, cfg.out_width,
                                    device=device)
    else:
        params["fc2"] = linear_init(gen, cfg.width, cfg.out_width,
                                    device=device)
    return params


def params_to(params, device: torch.device):
    """The parameter tree with every tensor (and tensor-parallel kappa,
    parallel.TPKernel) on ``device``."""
    if hasattr(params, "to"):
        return params.to(device)
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    return tuple(params_to(v, device) for v in params)


def _relu_after(cfg: GKNConfig, t: int) -> bool:
    return t != cfg.depth - 1 or cfg.relu_last


def cached_k_dtype(cfg: GKNConfig, gate_e: int,
                   device: torch.device) -> torch.dtype:
    """The dtype of the cached K of a graph of ``gate_e`` edges: bf16
    under a bf16 compute dtype; else float32, except on the CPU above
    ``_KCACHED_F32_MAX_BYTES``, where it is bf16, counted in
    ``k_lowered``."""
    if cfg.compute_dtype is not None:
        return torch.bfloat16
    if (device.type == "cuda"
            or gate_e * cfg.width * cfg.width * 4 <= _KCACHED_F32_MAX_BYTES):
        return torch.float32
    tracing.count("k_lowered")
    return torch.bfloat16


def _kcached(params, cfg: GKNConfig, graph: Graph, x, edge_mask,
             gate_e: int, gate_n: int):
    """impl='kcached': builds K and runs the fused or loop_vjp depth loop
    where the config takes one, returning (its output, None); otherwise
    (x, K) for the model's depth loop."""
    w = cfg.width
    k_dtype = cached_k_dtype(cfg, gate_e, x.device)
    n = x.shape[0]
    use_fused = (not graph.node_block and not cfg.loop_vjp
                 and graph.sorted_span > 0
                 and cfg.aggr in ("mean", "add")
                 and fused_iterate_supported(gate_e, w, w, graph.sorted_span)
                 and (cfg.kcached_fused == "on"
                      or (cfg.kcached_fused == "auto"
                          and gate_e * gate_n * 4 > _ONEHOT_MAX_BYTES)))
    with tracing.span("kbuild"):
        kk = build_cached_k(params["kernel"], graph.edge_attr,
                            compute_dtype=cfg.compute_dtype, k_dtype=k_dtype,
                            k_storage=None if use_fused else cfg.k_storage)
    tracing.count("k_bytes", kk.numel() * kk.element_size())
    if use_fused:
        # fp8 storage: both kernels stream the 1-byte copy; dK lands on
        # the full-precision kk (gkn.py:185-195 in JAX)
        k8 = (None if cfg.k_storage is None
              else to_fp8(kk.detach(), cfg.k_storage))
        setup = sorted_iterate_setup(graph.receivers, edge_mask, n)
        recip = (1.0 / setup.counts) if cfg.aggr == "mean" else None
        for t in range(cfg.depth):
            with tracing.span("conv.iterate"):
                out = fused_iterate_total(x, graph.senders, kk, setup,
                                          in_channels=w, out_channels=w,
                                          k8=k8)
                if recip is not None:
                    out = out * recip
                x = _root_bias(params, x, out)
                if _relu_after(cfg, t):
                    x = torch.relu(x)
        return x, None
    if cfg.loop_vjp and not graph.node_block:
        # one backward for the whole depth loop, dK built once
        return kcached_depth_loop(
            x, kk, params.get("root"), params.get("bias"), graph.senders,
            graph.receivers, edge_mask, depth=cfg.depth, width=w,
            aggr=cfg.aggr, relu_last=cfg.relu_last), None
    return x, kk


def _root_bias(params, x, out):
    if "root" in params:
        out = out + x @ params["root"]
    if "bias" in params:
        out = out + params["bias"]
    return out


def _forward(params, cfg: GKNConfig, graph: Graph, gate_e: int,
             gate_n: int) -> torch.Tensor:
    params = params_to(params, graph.device)
    x = graph.x @ params["fc1"]["w"] + params["fc1"]["b"]
    edge_mask = graph.edge_mask()
    kk = None
    if cfg.impl == "kcached":
        x, kk = _kcached(params, cfg, graph, x, edge_mask, gate_e, gate_n)
        if kk is None:
            return _gkn_decode(params, cfg, x)

    for t in range(cfg.depth):
        x = edge_kernel_conv(
            x, graph.senders, graph.receivers, graph.edge_attr, edge_mask,
            params["kernel"], in_channels=cfg.width, out_channels=cfg.width,
            aggr=cfg.aggr, root=params.get("root"), bias=params.get("bias"),
            impl=cfg.impl, compute_dtype=cfg.compute_dtype,
            node_block=graph.node_block, gate_edges=gate_e, cached_k=kk)
        if _relu_after(cfg, t):
            x = torch.relu(x)
    return _gkn_decode(params, cfg, x)


def _as_tensors(graph: Graph) -> Graph:
    """A host graph moves to the default device (CUDA, or an error)."""
    if isinstance(graph.x, torch.Tensor):
        return graph
    return graph.to()


def gkn_apply(params, cfg: GKNConfig, graph: Graph) -> torch.Tensor:
    """Forward on one padded graph -> [N_pad, out_width] on the graph's
    device. A host graph moves to the default device (CUDA, or an
    error)."""
    graph = _as_tensors(graph)
    return _forward(params, cfg, graph, graph.num_edges_padded,
                    graph.num_nodes_padded)


def _gkn_decode(params, cfg: GKNConfig, x):
    if cfg.decoder_mlp:
        x = torch.relu(x @ params["fc2"]["w"] + params["fc2"]["b"])
        return x @ params["fc3"]["w"] + params["fc3"]["b"]
    return x @ params["fc2"]["w"] + params["fc2"]["b"]


def gkn_apply_batched(params, cfg: GKNConfig, graphs: Graph) -> torch.Tensor:
    """Batched forward over a stacked batch -> [B, N_pad, out_width].

    The batch always runs as one disjoint-union graph (identical math:
    per-edge messages are unchanged and the mean counts each graph's
    valid edges). With batch_mode='vmap' (the JAX default) the gates see
    one graph's sizes, with 'flatten' the whole batch's, as in JAX."""
    graphs = _as_tensors(graphs)
    if graphs.node_block:
        return torch.stack([
            gkn_apply(params, cfg, _member(graphs, b))
            for b in range(graphs.x.shape[0])])
    b, n_pad = graphs.x.shape[0], graphs.x.shape[1]
    flat = flatten_stacked(graphs)
    if cfg.batch_mode == "flatten":
        out = _forward(params, cfg, flat, flat.num_edges_padded,
                       flat.num_nodes_padded)
    else:
        out = _forward(params, cfg, flat, graphs.num_edges_padded,
                       n_pad)
    return out.reshape(b, n_pad, -1)


def _member(graphs: Graph, b: int) -> Graph:
    def pick(v):
        return None if v is None else v[b]
    return dataclasses.replace(
        graphs, x=graphs.x[b], senders=graphs.senders[b],
        receivers=graphs.receivers[b], edge_attr=graphs.edge_attr[b],
        n_node=graphs.n_node[b], n_edge=graphs.n_edge[b],
        y=pick(graphs.y), sample_idx=pick(graphs.sample_idx),
        edge_valid=pick(graphs.edge_valid),
        sender_perm=pick(graphs.sender_perm))


__all__ = ["GKNConfig", "gkn_init", "gkn_apply", "gkn_apply_batched",
           "params_to", "cached_k_dtype"]
