"""Imports the reference's PyTorch checkpoints (counterpart of
graph_pde_tpu/compat/torch_import.py).

The reference saves whole-model pickles (``torch.save(model, path)``)
whose classes (KernelNN, NNConv_old, DenseNet) live in its training
scripts' ``__main__``. Nothing of the reference is imported: a stub
unpickler materialises a placeholder class for every class it cannot
find, and the converter walks the module tree's ``_parameters`` and
``_modules`` dicts.

``convert_kernelnn`` maps the tree onto the GKN parameter layout:
``torch.nn.Linear`` stores its weight [out, in] and the port stores
[in, out], so weights are transposed; NNConv_old's root is [in, out]
already (applied as x @ root).
"""
from __future__ import annotations

import pickle
import types
from typing import Any, Tuple

import torch

from ..convert import gkn_params_from_numpy
from ..device import DeviceLike
from ..models.gkn import GKNConfig


class _Stub:
    pass


class _StubUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        try:
            return super().find_class(module, name)
        except (ImportError, AttributeError):
            return type(name, (_Stub,), {"__module__": module})


def load_torch_module(path: str) -> Any:
    """Unpickles a full-model checkpoint into a stub object tree; no
    class of the checkpoint's own code is imported or run."""
    fake = types.ModuleType("gpde_stub_pickle")
    fake.Unpickler = _StubUnpickler
    fake.load = pickle.load
    fake.loads = pickle.loads
    return torch.load(path, map_location="cpu", pickle_module=fake,
                      weights_only=False)


def _params_of(mod) -> dict:
    return {k: (None if v is None else v.detach().numpy())
            for k, v in mod.__dict__.get("_parameters", {}).items()}


def _modules_of(mod) -> dict:
    return mod.__dict__.get("_modules", {})


def _linear(mod) -> dict:
    p = _params_of(mod)
    return {"w": p["weight"].T, "b": p["bias"]}


def convert_kernelnn(obj, device: DeviceLike = None
                     ) -> Tuple[dict, GKNConfig]:
    """A reference KernelNN module tree -> (GKN params as float32 tensors
    on ``device`` (None: CUDA), GKNConfig)."""
    mods = _modules_of(obj)
    params: dict = {"fc1": _linear(mods["fc1"])}
    conv = mods["conv1"]
    cp = _params_of(conv)
    for key in ("root", "bias"):
        if cp.get(key) is not None:
            params[key] = cp[key]
    layers = _modules_of(_modules_of(_modules_of(conv)["nn"])["layers"])
    kernel = []
    for key in sorted(layers, key=int):
        p = _params_of(layers[key])
        if "weight" in p:  # a Linear (activations hold no parameters)
            kernel.append({"w": p["weight"].T, "b": p["bias"]})
    params["kernel"] = tuple(kernel)
    decoder_mlp = "fc3" in mods
    params["fc2"] = _linear(mods["fc2"])
    if decoder_mlp:
        params["fc3"] = _linear(mods["fc3"])

    ker_in = kernel[0]["w"].shape[0]
    out = params["fc3" if decoder_mlp else "fc2"]["w"].shape[1]
    cfg = GKNConfig(
        width=params["fc1"]["w"].shape[1],
        ker_width=params["fc2"]["w"].shape[1] if decoder_mlp else 0,
        depth=int(obj.__dict__.get("depth", 6)),
        ker_in=ker_in,
        in_width=params["fc1"]["w"].shape[0],
        out_width=out,
        kernel_layers=tuple([ker_in] + [k["w"].shape[1] for k in kernel]),
        # the two-layer decoder's conv loop skips the final ReLU
        # (neurips5_GKN.py:36-39), the one-layer KernelNN's does not
        relu_last=not decoder_mlp,
        decoder_mlp=decoder_mlp,
        aggr=str(conv.__dict__.get("aggr", "mean")),
    )
    return gkn_params_from_numpy(params, device=device), cfg


def load_reference_kernelnn(path: str, device: DeviceLike = None):
    """A reference KernelNN pickle -> (params, GKNConfig)."""
    return convert_kernelnn(load_torch_module(path), device=device)


__all__ = ["load_torch_module", "convert_kernelnn",
           "load_reference_kernelnn"]
