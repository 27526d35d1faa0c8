"""Checkpoint and resume through ``torch.save`` (counterpart of
graph_pde_tpu/train/checkpoint.py, which uses orbax).

A checkpoint is a directory ``<directory>/step_<n>/`` holding
``state.pt``: the parameter tree, the optimizer state (for the trainer,
the Adam and StepLR state dicts) and nothing else. Saves are atomic (a
temporary directory renamed into place) and the newest ``keep`` steps
are kept.
"""
from __future__ import annotations

import os
import shutil
import tempfile
from typing import Any, Optional

import torch

_STATE = "state.pt"


def _steps(directory: str):
    return sorted(int(d.split("_", 1)[1]) for d in os.listdir(directory)
                  if d.startswith("step_") and d.split("_", 1)[1].isdigit())


def save_checkpoint(directory: str, step: int, params: Any,
                    opt_state: Any = None, keep: int = 3) -> str:
    """Writes step ``step`` and prunes all but the newest ``keep``."""
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"step_{step}")
    ckpt = {"params": params}
    if opt_state is not None:
        ckpt["opt_state"] = opt_state
    tmp = tempfile.mkdtemp(prefix=".tmp_step_", dir=directory)
    torch.save(ckpt, os.path.join(tmp, _STATE))
    if os.path.isdir(path):
        shutil.rmtree(path)
    os.replace(tmp, path)
    for s in _steps(directory)[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s}"),
                      ignore_errors=True)
    return path


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = _steps(directory)
    return steps[-1] if steps else None


def restore_checkpoint(directory: str, step: Optional[int] = None,
                       map_location: Any = "cpu") -> Optional[dict]:
    """``{"params", "opt_state"?, "step"}`` of ``step`` (default: the
    latest), or None when there is no checkpoint."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            return None
    path = os.path.join(os.path.abspath(directory), f"step_{step}", _STATE)
    restored = torch.load(path, map_location=map_location,
                          weights_only=True)
    restored["step"] = step
    return restored


__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step"]
