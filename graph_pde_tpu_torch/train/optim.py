"""Optimizer: Adam + StepLR (counterpart of graph_pde_tpu/train/optim.py).

The reference trains with ``torch.optim.Adam(lr, weight_decay=5e-4)``
and ``StepLR(step_size, gamma)`` stepped once per epoch. torch's Adam
adds ``weight_decay * p`` to the gradient before the moment updates (L2
regularisation, not AdamW's decoupled decay); the JAX package reproduces
that with optax ``add_decayed_weights`` before ``scale_by_adam``, and
this module is the torch original.
"""
from __future__ import annotations

from typing import Iterable, Tuple

import torch


def step_lr(base_lr: float, steps_per_epoch: int, step_size_epochs: int,
            gamma: float):
    """StepLR as a schedule over optimizer steps: the learning rate at
    step ``count`` (the JAX package's optax schedule)."""
    def schedule(count):
        epoch = count // max(steps_per_epoch, 1)
        return base_lr * (gamma ** (epoch // step_size_epochs))
    return schedule


def adam_steplr(params: Iterable[torch.Tensor], base_lr: float, *,
                weight_decay: float = 0.0, step_size_epochs: int = 50,
                gamma: float = 0.5, eps: float = 1e-8
                ) -> Tuple[torch.optim.Adam, torch.optim.lr_scheduler.StepLR]:
    """Adam (weight decay added to the gradient) and its StepLR
    scheduler. Step the scheduler once per epoch."""
    opt = torch.optim.Adam(params, lr=base_lr, betas=(0.9, 0.999), eps=eps,
                           weight_decay=weight_decay)
    sched = torch.optim.lr_scheduler.StepLR(opt, step_size=step_size_epochs,
                                            gamma=gamma)
    return opt, sched


__all__ = ["adam_steplr", "step_lr"]
