"""Process-group initialization (counterpart of
graph_pde_tpu/parallel/distributed.py).

Call ``initialize()`` once per process before building a mesh. It wraps
``torch.distributed.init_process_group`` with a ``tcp://`` rendezvous at
the coordinator's address; nothing on a machine tells a program of a
cluster, so the caller (or the environment's ``MASTER_ADDR`` /
``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``) names the coordinator, the
world size and the rank.

Backend rule for ``backend=None``: NCCL when the ranks compute on CUDA
(``device_type='cuda'``, the default) and every rank has a card of its
own (``world_size <= torch.cuda.device_count()``; rank r then takes card
r); gloo otherwise, which covers ranks that compute on the CPU and
several ranks sharing one card (NCCL refuses two ranks on one GPU).
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def default_backend(world_size: int, device_type: str = "cuda") -> str:
    """The backend rule above for a world of ``world_size`` ranks that
    compute on ``device_type``."""
    if (device_type == "cuda" and torch.cuda.is_available()
            and world_size <= torch.cuda.device_count()):
        return "nccl"
    return "gloo"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               device_type: str = "cuda") -> None:
    """Joins the process group at ``coordinator_address``
    ('host:port'), as rank ``process_id`` of ``num_processes``, the
    ranks computing on ``device_type`` ('cuda' or 'cpu', for the backend
    rule). A no-op when a group already exists, and when neither a
    coordinator nor ``MASTER_ADDR`` and ``WORLD_SIZE`` in the
    environment configure one (a single process, as JAX's initialize
    is)."""
    if dist.is_initialized():
        return
    env = os.environ
    if coordinator_address is None:
        if "MASTER_ADDR" not in env or "WORLD_SIZE" not in env:
            return
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    if num_processes is None and "WORLD_SIZE" not in env:
        raise ValueError("initialize: a coordinator needs the world size "
                         "(num_processes, or WORLD_SIZE in the "
                         "environment)")
    world = int(env["WORLD_SIZE"] if num_processes is None
                else num_processes)
    rank = int(env.get("RANK", 0) if process_id is None else process_id)
    backend = backend or default_backend(world, device_type)
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=world, rank=rank)


def is_multiprocess() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


__all__ = ["initialize", "is_multiprocess", "default_backend"]
