"""Carries weights and normalizer state over from the JAX package.

``gkn_params_from_numpy`` takes a GKN parameter tree as numpy arrays
(for example ``jax.tree.map(np.asarray, params)`` of a JAX ``gkn_init``
or checkpoint tree) and returns the same tree of float32 tensors. The
layout is the same in both packages, so the port computes the same
function from the same numbers.

``mgkn_orthogonal_params_from_numpy`` does the same for the orthogonal
MGKN's tree ``{"fc1", "conv": [{"kernel", "root", "bias"}, ...], "fc2",
"fc3"}``, keeping "conv" a list of one entry per level, and
``mgkn_general_params_from_numpy`` for the general MGKN's tree ``{"fc_in",
"conv_down", "conv_mid", "conv_up", "fc_out1", "fc_out2"}``, each conv
list a list, and ``gcn_params_from_numpy`` for the GCN's tree ``{"fc_in",
"convs", "fc_out1", "fc_out2"}``, "convs" a list of the four layers.

``normalizer_from_state`` rebuilds a normalizer from the state dict the
JAX package's bundle export writes (train/export.py): ``{"kind": "unit"
| "gaussian", "mean", "std", "eps"}`` or ``{"kind": "range", "a",
"b"}``. ``normalizer_state`` is its inverse and writes the same dict.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .utils.normalizers import (GaussianNormalizer, RangeNormalizer,
                                UnitGaussianNormalizer)


def gkn_params_from_numpy(tree, device: DeviceLike = None):
    """Numpy parameter tree (dicts, tuples, lists of arrays) -> the same
    tree of float32 tensors on ``device`` (None -> CUDA)."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, Mapping):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return tuple(conv(v) for v in node)
        return torch.from_numpy(np.array(node, np.float32)).to(dev)

    return conv(tree)


def mgkn_orthogonal_params_from_numpy(tree, device: DeviceLike = None):
    """The orthogonal MGKN's numpy parameter tree -> the same tree of
    float32 tensors on ``device`` (None -> CUDA), "conv" a list."""
    params = gkn_params_from_numpy(tree, device)
    params["conv"] = list(params["conv"])
    return params


def mgkn_general_params_from_numpy(tree, device: DeviceLike = None):
    """The general MGKN's numpy parameter tree -> the same tree of
    float32 tensors on ``device`` (None -> CUDA), the conv lists
    lists."""
    params = gkn_params_from_numpy(tree, device)
    for kind in ("conv_down", "conv_mid", "conv_up"):
        params[kind] = list(params[kind])
    return params


def gcn_params_from_numpy(tree, device: DeviceLike = None):
    """The GCN's numpy parameter tree -> the same tree of float32 tensors
    on ``device`` (None -> CUDA), "convs" a list."""
    params = gkn_params_from_numpy(tree, device)
    params["convs"] = list(params["convs"])
    return params


def _f32(v) -> torch.Tensor:
    return torch.from_numpy(np.array(v, np.float32))


def normalizer_from_state(state: Mapping[str, Any]):
    """A normalizer from its exported state (stats as CPU tensors)."""
    kind = state["kind"]
    if kind == "unit":
        norm = UnitGaussianNormalizer.__new__(UnitGaussianNormalizer)
    elif kind == "gaussian":
        norm = GaussianNormalizer.__new__(GaussianNormalizer)
    elif kind == "range":
        norm = RangeNormalizer.__new__(RangeNormalizer)
        norm.a, norm.b = _f32(state["a"]), _f32(state["b"])
        return norm
    else:
        raise ValueError(f"unknown normalizer kind {kind!r}")
    norm.mean, norm.std = _f32(state["mean"]), _f32(state["std"])
    norm.eps = state["eps"]
    return norm


def _list(t) -> list:
    return torch.as_tensor(t).detach().cpu().numpy().tolist()


def normalizer_state(norm) -> dict:
    """The JSON-ready state of a normalizer, as the JAX package's bundle
    export writes it."""
    if isinstance(norm, UnitGaussianNormalizer):
        return {"kind": "unit", "mean": _list(norm.mean),
                "std": _list(norm.std), "eps": norm.eps}
    if isinstance(norm, GaussianNormalizer):
        return {"kind": "gaussian", "mean": float(norm.mean),
                "std": float(norm.std), "eps": norm.eps}
    if isinstance(norm, RangeNormalizer):
        return {"kind": "range", "a": _list(norm.a), "b": _list(norm.b)}
    raise TypeError(f"no state for a {type(norm).__name__}")


__all__ = ["gkn_params_from_numpy", "mgkn_orthogonal_params_from_numpy",
           "mgkn_general_params_from_numpy", "gcn_params_from_numpy",
           "normalizer_from_state", "normalizer_state"]
