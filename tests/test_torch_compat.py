"""Port parity: compat/torch_import of graph_pde_tpu_torch against
graph_pde_tpu's, on a stand-in for the reference's KernelNN pickles.

The reference checkpoints are whole-model pickles of classes defined in
its training scripts' ``__main__``. The stand-in defines such classes in
a throwaway module, pickles a model with ``torch.save(model)`` and drops
the module, so both converters must go through their stub unpicklers.
Both must give the same parameters (bit for bit) and the same config.
"""
import dataclasses
import sys
import types

import numpy as np
import pytest
import torch
from torch import nn

from graph_pde_tpu.compat import torch_import as jimport
from graph_pde_tpu_torch.compat import torch_import as timport
from graph_pde_tpu_torch.train.trainer import param_leaves

_MOD = "kernelnn_reference_standin"


def _standin_module():
    mod = types.ModuleType(_MOD)

    class DenseNet(nn.Module):
        def __init__(self, layers):
            super().__init__()
            seq = []
            for j in range(len(layers) - 1):
                seq.append(nn.Linear(layers[j], layers[j + 1]))
                if j != len(layers) - 2:
                    seq.append(nn.ReLU())
            self.layers = nn.Sequential(*seq)

    class NNConv_old(nn.Module):
        def __init__(self, width, kernel):
            super().__init__()
            self.nn = kernel
            self.aggr = "mean"
            self.root = nn.Parameter(torch.randn(width, width))
            self.bias = nn.Parameter(torch.randn(width))

    class KernelNN(nn.Module):
        def __init__(self, width, ker_width, depth, ker_in, in_width,
                     decoder_mlp):
            super().__init__()
            self.depth = depth
            self.fc1 = nn.Linear(in_width, width)
            self.conv1 = NNConv_old(width, DenseNet(
                [ker_in, ker_width // 2, ker_width, width ** 2]))
            if decoder_mlp:
                self.fc2 = nn.Linear(width, ker_width)
                self.fc3 = nn.Linear(ker_width, 1)
            else:
                self.fc2 = nn.Linear(width, 1)

    for cls in (DenseNet, NNConv_old, KernelNN):
        cls.__module__, cls.__qualname__ = _MOD, cls.__name__
        setattr(mod, cls.__name__, cls)
    return mod


@pytest.fixture(params=[False, True], ids=["kernelnn", "decoder_mlp"])
def checkpoint(request, tmp_path):
    torch.manual_seed(0)
    sys.modules[_MOD] = mod = _standin_module()
    try:
        model = mod.KernelNN(8, 16, 3, 6, 6, decoder_mlp=request.param)
        path = str(tmp_path / "model.pt")
        torch.save(model, path)
    finally:
        del sys.modules[_MOD]
    return path


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}{k}.").items()}
    if isinstance(tree, (tuple, list)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}{i}.").items()}
    return {prefix[:-1]: np.asarray(tree)}


def test_kernelnn_import_matches_jax(checkpoint):
    jparams, jcfg = jimport.load_reference_kernelnn(checkpoint)
    tparams, tcfg = timport.load_reference_kernelnn(checkpoint,
                                                    device="cpu")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    jflat, tflat = _flat(jparams), _flat(tparams)
    assert sorted(tflat) == sorted(jflat)
    for k, v in jflat.items():
        assert tflat[k].dtype == np.float32
        np.testing.assert_array_equal(tflat[k], v, err_msg=k)
    assert all(t.device.type == "cpu" for t in param_leaves(tparams))


def test_stub_unpickler_imports_nothing_of_the_checkpoint(checkpoint):
    obj = timport.load_torch_module(checkpoint)
    assert isinstance(obj, timport._Stub)
    assert type(obj).__name__ == "KernelNN"
    assert _MOD not in sys.modules
