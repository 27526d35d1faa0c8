"""Data and tensor parallelism (counterpart of
graph_pde_tpu/parallel/sharding.py).

The JAX package annotates shardings and lets GSPMD insert the
collectives. Here the same specs drive explicit placement:

- ``batch_sharding`` gives this rank its block of a stacked batch on the
  'data' axis; the train step sums the gradients over that axis
  (train/trainer.py ``make_train_step(..., data_group=...)``).
- ``replicated_sharding`` broadcasts a tree from the mesh's first rank.
- ``param_sharding`` keeps on each 'model' rank only its shard of every
  kernel-MLP layer, in a ``TPKernel`` that replaces the 'kernel' tuple.
  The edge convolution hands the messages to it: ``TPKernel.messages``
  for the plain paths ('reference', 'scan'), ``TPKernel.fused_messages``
  (K1 on every rank, B1-bwd in the backward) for 'pallas', which 'auto'
  picks on CUDA where the JAX gate admits the whole kappa's shapes.

TP scheme for the edge-kernel MLP, Megatron-style alternating column/row
parallelism:
  layer 0 (and even layers): weight sharded on the OUTPUT dim (column
    parallel; activations become hidden-sharded),
  odd layers: weight sharded on the INPUT dim (row parallel; an
    all-reduce sums the partial products).
A column-parallel last layer [ker_width, w_in * w_out / tp] holds a
contiguous range of input channels (K is in-major), so each rank
contracts its slice of x_src and the partial messages are summed; a
row-parallel last layer sums K before its bias. The fused path runs the
kappa MLP inside K1, which takes whole layers: each rank gathers the
small layers before the last (their gradients are summed back onto the
shards) and keeps its own shard of the last one, whose [kw, w_in * w_out]
weight no rank holds whole.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from ..data.datasets import map_arrays
from ._comm import (all_gather_rows, axis_index, axis_size, copy_to,
                    reduce_from)


class P(tuple):
    """A partition spec: one mesh axis name (or None) per tensor dim, as
    jax.sharding.PartitionSpec."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(tuple(self))


def batch_spec() -> P:
    return P("data")


def batch_sharding(mesh, pytree: Any):
    """This rank's block of every array of a stacked batch along its
    leading axis, split over the mesh's 'data' axis."""
    group = mesh.get_group("data")
    dp, r = axis_size(group), axis_index(group)

    def take(a):
        if a.shape[0] % dp:
            raise ValueError(f"batch of {a.shape[0]} does not split over "
                             f"{dp} data ranks")
        blk = a.shape[0] // dp
        return a[r * blk:(r + 1) * blk]

    return map_arrays(take, pytree)


def _dense_layer_specs(n_layers: int, tp_axis: str):
    """Alternating column/row parallel specs for a DenseNet."""
    specs = []
    for j in range(n_layers):
        if j % 2 == 0:  # column parallel: shard output dim (+ bias)
            specs.append({"w": P(None, tp_axis), "b": P(tp_axis)})
        else:           # row parallel: shard input dim; bias replicated
            specs.append({"w": P(tp_axis, None), "b": P(None)})
    return tuple(specs)


def param_specs(params: Any, tp_axis: str = "model") -> Any:
    """Specs for a model param tree: kernel MLPs TP-sharded, everything
    else replicated. Any dict key named 'kernel' holding a DenseNet
    tuple gets the alternating scheme."""
    def walk(node):
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                if k == "kernel" and isinstance(v, (tuple, list)):
                    out[k] = _dense_layer_specs(len(v), tp_axis)
                else:
                    out[k] = walk(v)
            return out
        if isinstance(node, (tuple, list)):
            return type(node)(walk(v) for v in node)
        return P()
    return walk(params)


class TPKernel(tuple):
    """A kernel DenseNet under tensor parallelism: this rank's shard of
    each layer (a tuple of {'w', 'b'} dicts, as the DenseNet), the
    layers' specs and the 'model' process group. The edge convolution
    takes its messages from ``messages`` (plain) or ``fused_messages``
    (K1) and gates 'auto' on ``whole_shapes``."""

    def __new__(cls, layers, specs, group):
        self = super().__new__(cls, layers)
        self.specs = tuple(specs)
        self.group = group
        return self

    def to(self, device) -> "TPKernel":
        return TPKernel(tuple({k: v.to(device) for k, v in p.items()}
                              for p in self), self.specs, self.group)

    @property
    def whole_shapes(self):
        """The whole DenseNet as meta tensors of its layers' shapes,
        which the edge convolution's shape gates read."""
        tp = axis_size(self.group)

        def whole(t, spec):
            shape = [n * tp if name is not None else n
                     for n, name in zip(t.shape, spec)]
            return torch.empty(shape, device="meta")

        return tuple({k: whole(v, s[k]) for k, v in p.items()}
                     for p, s in zip(self, self.specs))

    def messages(self, x_src, edge_attr, in_channels: int,
                 out_channels: int, kernel_type: str,
                 compute_dtype) -> torch.Tensor:
        """Per-edge messages x_j @ kappa(e), float32 [E', w_out], the
        kappa MLP run on this rank's shards with the Megatron
        collectives; every rank of the group returns the whole result."""
        if kernel_type != "full":
            raise ValueError("a tensor-parallel kappa takes kernel_type "
                             "'full'")
        layers, h = tuple(self), edge_attr
        if compute_dtype is not None:
            x_src, h = x_src.to(compute_dtype), h.to(compute_dtype)
            layers = tuple({k: v.to(compute_dtype) for k, v in p.items()}
                           for p in layers)
        g, n = self.group, len(layers)
        for j, (p, spec) in enumerate(zip(layers, self.specs)):
            if _column(spec):
                h = copy_to(h, g) @ p["w"] + p["b"]
            else:
                h = reduce_from(h @ p["w"], g) + p["b"]
            if j != n - 1:
                h = torch.relu(h)
        e = x_src.shape[0]
        if not _column(self.specs[-1]):
            k = h.view(e, in_channels, out_channels)
            return torch.einsum("ei,eio->eo", x_src.to(torch.float32),
                                k.to(torch.float32))
        # column-parallel last layer: K's in-major columns on this rank
        # are input channels [r * c, (r + 1) * c)
        c = in_channels // axis_size(g)
        r = axis_index(g)
        xs = copy_to(x_src, g)[:, r * c:(r + 1) * c]
        k = h.view(e, c, out_channels)
        return reduce_from(torch.einsum("ei,eio->eo", xs.to(torch.float32),
                                        k.to(torch.float32)), g)


    def fused_messages(self, x, senders, edge_attr, *, in_channels: int,
                       out_channels: int, compute_dtype=None
                       ) -> torch.Tensor:
        """[E, w_out] float32 messages x[senders] @ kappa(edge_attr) by
        ops.fused_edge_messages (K1, and B1-bwd in the backward) on
        this rank's part of the kappa: the layers before the last
        gathered whole, except the column-parallel one whose hidden
        slice a row-parallel last layer takes, and the last layer's
        own shard. A column-parallel last layer contracts this rank's
        input channels; a row-parallel one its hidden slice, with the
        replicated bias's 1/tp share. The partial messages are summed
        over the group, so every rank returns the whole result."""
        from ..ops.fused_edge_conv import fused_edge_messages

        g, tp, r = self.group, axis_size(self.group), axis_index(self.group)
        n, last_column = len(self), _column(self.specs[-1])
        layers = []
        for j, (p, spec) in enumerate(zip(self, self.specs)):
            if j == n - 1 and not last_column:
                layers.append({"w": p["w"], "b": copy_to(p["b"], g) / tp})
            elif j == n - 1 or (j == n - 2 and not last_column):
                layers.append(p)
            else:
                layers.append(_gathered(p, spec, g))
        x = copy_to(x, g)
        if last_column:
            in_channels //= tp
            x = x[:, r * in_channels:(r + 1) * in_channels]
        msg = fused_edge_messages(x, senders, copy_to(edge_attr, g),
                                  tuple(layers), in_channels=in_channels,
                                  out_channels=out_channels,
                                  compute_dtype=compute_dtype)
        return reduce_from(msg, g)


def _column(spec) -> bool:
    return spec["w"][1] is not None


def _gathered(p, spec, group):
    """A layer's shards gathered whole on every rank of ``group``; the
    backward sums each rank's gradient of the whole layer onto the
    shards (a replicated bias: over the group)."""
    if _column(spec):
        return {"w": all_gather_rows(p["w"].t(), group).t(),
                "b": all_gather_rows(p["b"], group)}
    return {"w": all_gather_rows(p["w"], group), "b": copy_to(p["b"], group)}


def _shard(t: torch.Tensor, spec: P, tp_axis: str, r: int, tp: int):
    index = []
    for d, name in enumerate(spec):
        if name == tp_axis:
            if t.shape[d] % tp:
                raise ValueError(f"dim {d} of {tuple(t.shape)} does not "
                                 f"split over {tp} model ranks")
            n = t.shape[d] // tp
            index.append(slice(r * n, (r + 1) * n))
        else:
            index.append(slice(None))
    return (t.detach()[tuple(index)].clone()
            .requires_grad_(t.requires_grad))


def param_sharding(mesh, params: Any, tp_axis: str = "model"):
    """The tree with every 'kernel' DenseNet replaced by a ``TPKernel``
    holding only this rank's shard of each layer (new autograd leaves
    where the given ones were); every other leaf is the given tensor.
    Make the tree trainable before sharding it, and build the optimizer
    over ``param_leaves`` of the result."""
    group = mesh.get_group(tp_axis)
    tp, r = axis_size(group), axis_index(group)

    def walk(node):
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                if k == "kernel" and isinstance(v, (tuple, list)):
                    specs = _dense_layer_specs(len(v), tp_axis)
                    out[k] = TPKernel(
                        tuple({n: _shard(t, s[n], tp_axis, r, tp)
                               for n, t in p.items()}
                              for p, s in zip(v, specs)), specs, group)
                else:
                    out[k] = walk(v)
            return out
        if isinstance(node, (tuple, list)):
            return type(node)(walk(v) for v in node)
        return node
    return walk(params)


def gather_params(params: Any, grad: bool = False):
    """The inverse of ``param_sharding``: every ``TPKernel`` gathered
    back into the whole DenseNet (detached), on every rank. With
    ``grad``, the tree of the leaves' gradients instead."""
    def leaf(t):
        return (t.grad if grad else t).detach()

    def whole(t, spec, group):
        t = leaf(t)
        parts = [torch.empty_like(t) for _ in range(axis_size(group))]
        dist.all_gather(parts, t.contiguous(), group=group)
        dims = [d for d, name in enumerate(spec) if name is not None]
        return torch.cat(parts, dims[0]) if dims else t

    def walk(node):
        if isinstance(node, TPKernel):
            return tuple({n: whole(t, s[n], node.group)
                          for n, t in p.items()}
                         for p, s in zip(node, node.specs))
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return type(node)(walk(v) for v in node)
        return leaf(node)
    return walk(params)


def replicated_sharding(mesh, pytree: Any):
    """Every tensor of the tree broadcast from the mesh's first rank
    (copies; a leaf that requires grad gives one that does)."""
    src = int(mesh.mesh.flatten()[0])

    def bcast(t):
        out = t.detach().clone().contiguous()
        dist.broadcast(out, src=src)
        return out.requires_grad_(t.requires_grad)

    return map_arrays(lambda a: bcast(a) if isinstance(a, torch.Tensor)
                      else a, pytree)


__all__ = [
    "batch_spec", "batch_sharding", "param_specs", "param_sharding",
    "replicated_sharding", "gather_params", "TPKernel", "P",
]
