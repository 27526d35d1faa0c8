"""Kernel MLPs (counterpart of graph_pde_tpu/ops/dense.py).

Parameters keep the JAX layout: a tuple of ``{"w": [in, out], "b":
[out]}`` dicts, applied as ``x @ w + b``. Initialisation matches
torch.nn.Linear's defaults (U(+-1/sqrt(fan_in)) for weight and bias), the
same distributions the JAX package draws. Draws come from an explicit
CPU ``torch.Generator`` and are then moved to ``device`` (``None``:
CUDA, or an error without a GPU), so a seed gives the same weights on
every device.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device


def _uniform(gen: torch.Generator, shape, bound: float, device: DeviceLike,
             dtype=torch.float32) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, dtype=dtype)
    return ((2.0 * u - 1.0) * bound).to(resolve_device(device))


def linear_init(gen: torch.Generator, fan_in: int, fan_out: int, *,
                device: DeviceLike = None, dtype=torch.float32):
    """torch.nn.Linear default init, stored [in, out]."""
    bound = 1.0 / np.sqrt(fan_in)
    w = _uniform(gen, (fan_in, fan_out), bound, device, dtype)
    b = _uniform(gen, (fan_out,), bound, device, dtype)
    return {"w": w, "b": b}


def pyg_uniform_init(gen: torch.Generator, size: int, shape, *,
                     device: DeviceLike = None, dtype=torch.float32):
    """PyG's ``uniform(size, tensor)`` init: U(+-1/sqrt(size))."""
    return _uniform(gen, tuple(shape), 1.0 / np.sqrt(size), device, dtype)


def dense_init(gen: torch.Generator, layers: Sequence[int], *,
               device: DeviceLike = None, dtype=torch.float32) -> Tuple:
    """A DenseNet with the given layer widths (len >= 2)."""
    if len(layers) < 2:
        raise ValueError("a DenseNet needs at least two layer widths")
    return tuple(
        linear_init(gen, layers[j], layers[j + 1], device=device,
                    dtype=dtype)
        for j in range(len(layers) - 1))


def dense_apply(params, x: torch.Tensor,
                nonlinearity: Callable = torch.relu,
                out_nonlinearity: Optional[Callable] = None) -> torch.Tensor:
    """Linear stack with ``nonlinearity`` between layers and an optional
    output nonlinearity."""
    n = len(params)
    for j, layer in enumerate(params):
        x = x @ layer["w"] + layer["b"]
        if j != n - 1:
            x = nonlinearity(x)
    if out_nonlinearity is not None:
        x = out_nonlinearity(x)
    return x


def dense_sin_apply(params, x: torch.Tensor) -> torch.Tensor:
    """DenseNet_sin forward: ``dense_apply`` with sin between layers."""
    return dense_apply(params, x, nonlinearity=torch.sin)


def layer_dims(kernel_params) -> Tuple[Tuple[int, int], ...]:
    """((in, out), ...) of each layer of a DenseNet."""
    return tuple((p["w"].shape[0], p["w"].shape[1]) for p in kernel_params)


def flatten_params(kernel_params) -> list:
    """A DenseNet's tensors as (w0, b0, w1, b1, ...), the form autograd
    Functions take them in."""
    return [t for p in kernel_params for t in (p["w"], p["b"])]


def unflatten_params(weights) -> Tuple:
    """The inverse of ``flatten_params``."""
    return tuple({"w": w, "b": b} for w, b in zip(weights[0::2],
                                                  weights[1::2]))


__all__ = ["linear_init", "pyg_uniform_init", "dense_init", "dense_apply",
           "dense_sin_apply", "layer_dims", "flatten_params", "unflatten_params"]
