"""Seeded weights, made on the device in a few large draws.

A model's weights are a flat, ordered {name: tensor} dict (the
benchmark's own layout); each system maps it onto the program's tree and
each reference reads it by name. Every tensor is drawn uniform in
(-bound, bound), the torch.nn.Linear default for a linear layer (bound
1 / sqrt(fan_in)) and PyG's for a root weight or bias (1 / sqrt(width)).
"""
from __future__ import annotations

import math

import torch


def linear(name: str, fan_in: int, fan_out: int) -> list:
    b = 1.0 / math.sqrt(fan_in)
    return [(f"{name}.w", (fan_in, fan_out), b), (f"{name}.b", (fan_out,), b)]


def dense(name: str, layers) -> list:
    return [spec for j, (a, b) in enumerate(zip(layers[:-1], layers[1:]))
            for spec in linear(f"{name}.{j}", a, b)]


def draw(specs: list, seed: int, device) -> dict:
    """One uniform draw for every tensor of ``specs`` ((name, shape,
    bound) triples), float32 on ``device``."""
    sizes = [math.prod(shape) for _, shape, _ in specs]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(sum(sizes), generator=gen, device=device)
    out, i = {}, 0
    for (name, shape, bound), size in zip(specs, sizes):
        out[name] = ((2.0 * flat[i:i + size] - 1.0) * bound).view(shape)
        i += size
    return out
