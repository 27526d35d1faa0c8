"""Device resolution for the port's entry points.

The port is written for one CUDA device. ``device=None`` means that
device; a machine without one raises rather than running on the CPU
unnoticed. ``device="cpu"`` is the explicit opt-in (the parity tests use
it), and there every kernel wrapper takes its plain PyTorch version.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; anything else as given. A CUDA device
    raises without a GPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU explicitly")
    return dev


__all__ = ["resolve_device", "DeviceLike"]
