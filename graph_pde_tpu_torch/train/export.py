"""Serving bundles (counterpart of graph_pde_tpu/train/export.py).

A bundle is a directory holding everything a predictor needs besides
the code: ``params/`` (a ``train/checkpoint.py`` checkpoint of the
parameter tree, through ``torch.save``) and ``bundle.json`` with the JAX
package's schema: ``model_config_class``, ``model_config`` (the config
dataclass as a dict), ``normalizers`` (name -> ``convert.
normalizer_state``) and ``extra`` (family, dataset, radius or train_s,
experiment). GKN, GCN, general MGKN and orthogonal MGKN bundles load.
A JAX bundle's params are an orbax checkpoint, which only the JAX
package reads; its ``bundle.json`` loads here as it is.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional

from ..convert import normalizer_from_state, normalizer_state
from ..data.datasets import map_arrays
from ..models.gcn import GCNConfig
from ..models.gkn import GKNConfig
from ..models.mgkn_general import MGKNGeneralConfig
from ..models.mgkn_orthogonal import MGKNOrthogonalConfig
from .checkpoint import restore_checkpoint, save_checkpoint

_MODEL_CONFIGS = {"GKNConfig": GKNConfig, "GCNConfig": GCNConfig,
                  "MGKNGeneralConfig": MGKNGeneralConfig,
                  "MGKNOrthogonalConfig": MGKNOrthogonalConfig}
_META = "bundle.json"


def save_bundle(directory: str, params, model_cfg,
                normalizers: Optional[Dict[str, Any]] = None,
                extra: Optional[Dict[str, Any]] = None) -> str:
    """Writes ``params/`` and ``bundle.json`` under ``directory``."""
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    save_checkpoint(os.path.join(directory, "params"), 0,
                    map_arrays(lambda t: t.detach().cpu(), params))
    meta = {
        "model_config_class": type(model_cfg).__name__,
        "model_config": dataclasses.asdict(model_cfg),
        "normalizers": {k: normalizer_state(v)
                        for k, v in (normalizers or {}).items()},
        "extra": extra or {},
    }
    with open(os.path.join(directory, _META), "w") as f:
        json.dump(meta, f)
    return directory


def load_meta(directory: str):
    """(model config, normalizers, extra) of a bundle's ``bundle.json``:
    the part a JAX bundle shares with the port's."""
    with open(os.path.join(os.path.abspath(directory), _META)) as f:
        meta = json.load(f)
    cfg = _MODEL_CONFIGS[meta["model_config_class"]](**{
        k: tuple(v) if isinstance(v, list) else v
        for k, v in meta["model_config"].items()})
    norms = {k: normalizer_from_state(v)
             for k, v in meta["normalizers"].items()}
    return cfg, norms, meta.get("extra", {})


def load_bundle(directory: str):
    """``(params, model config, normalizers, extra)``; the params and
    normalizer statistics are CPU tensors (a predictor moves them to its
    device)."""
    cfg, norms, extra = load_meta(directory)
    restored = restore_checkpoint(
        os.path.join(os.path.abspath(directory), "params"))
    if restored is None:
        raise FileNotFoundError(f"no parameter checkpoint in {directory}")
    return restored["params"], cfg, norms, extra


__all__ = ["save_bundle", "load_bundle", "load_meta"]
