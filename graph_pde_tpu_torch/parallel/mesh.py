"""Device mesh construction (counterpart of graph_pde_tpu/parallel/mesh.py).

Axes:

- 'data': graph samples (data parallel; gradients summed over the axis).
- 'model': tensor parallel over the kernel-MLP hidden/output dims.

Node sharding of one graph (parallel/halo.py, parallel/halo_mgkn.py)
uses a 1-d mesh of its own. A mesh spans the ranks of the process group
that ``initialize`` joined; each axis's process group is
``mesh.get_group(name)``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_mesh(axis_sizes: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = ("data", "model"),
              device_type: Optional[str] = None) -> DeviceMesh:
    """A DeviceMesh over every rank of the world, on ``device_type``
    (None: 'cuda'; the CPU is an explicit 'cpu').

    axis_sizes=None puts every rank on the first axis."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.initialize() "
                           "first")
    n = dist.get_world_size()
    if axis_sizes is None:
        axis_sizes = (n,) + (1,) * (len(axis_names) - 1)
    if int(np.prod(axis_sizes)) != n:
        raise ValueError(f"mesh {tuple(axis_sizes)} does not match {n} "
                         "ranks")
    device_type = device_type or "cuda"
    if device_type == "cuda":
        # several ranks may share a card: rank r computes on card r mod
        # the cards there are
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(device_type, tuple(axis_sizes),
                            mesh_dim_names=tuple(axis_names))


def default_mesh_shape(n_devices: int, tp: int = 1) -> Tuple[int, int]:
    """(data, model) split: tp-way tensor parallel, rest data parallel."""
    assert n_devices % tp == 0
    return (n_devices // tp, tp)


__all__ = ["make_mesh", "default_mesh_shape"]
