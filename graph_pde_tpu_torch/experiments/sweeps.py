"""Parameter sweeps (counterpart of graph_pde_tpu/experiments/sweeps.py):
the reference's for-loops over inlined literals (UAI3_resolution.py:38,
UAI6_sample_radius.py:39-40, neurips3_MGKN.py:97) as sweep specs over
registry configs."""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Sequence

from ..device import DeviceLike, resolve_device
from .registry import ExperimentConfig, get
from .runners import run_experiment


# The reference's sweep axes, per script:
REFERENCE_SWEEPS: Dict[str, Dict[str, Sequence]] = {
    # UAI3: train downsampling r in {1,2,4,8,16} (UAI3_resolution.py:38)
    "uai3_resolution": {"downsample": (16, 8, 4, 2, 1)},
    # UAI4: training sample count (UAI4_equation_sample.py:41-42)
    "uai4_equation_sample": {"ntrain": (5, 10, 20, 50, 100)},
    # UAI5: train-m vs test handled in-config; sweep train m
    "uai5_sample_generalize": {"nystrom_m": (100, 200, 400, 800)},
    # UAI6: m x radius grid (UAI6_sample_radius.py:39-40)
    "uai6_sample_radius": {"nystrom_m": (100, 200, 400),
                           "radius_train": (0.05, 0.15, 0.4)},
    # UAI8: kernel width (UAI8_kernel.py)
    "uai8_kernel": {"ker_width": (64, 128, 256, 512)},
    # neurips1_GKN: node count cases (neurips1_GKN.py:48)
    "neurips1_gkn": {"nystrom_m": (100, 200, 400, 800)},
    # neurips3_MGKN: train downsampling (neurips3_MGKN.py:97)
    "neurips3_mgkn": {"downsample": (8, 6, 4, 2, 1)},
}


def sweep_configs(name: str,
                  axes: Dict[str, Sequence] = None) -> List[ExperimentConfig]:
    base = get(name)
    axes = axes or REFERENCE_SWEEPS.get(name)
    if not axes:
        return [base]
    keys = list(axes)
    out = []
    for combo in itertools.product(*(axes[k] for k in keys)):
        out.append(dataclasses.replace(base, **dict(zip(keys, combo))))
    return out


def run_sweep(name: str, axes: Dict[str, Sequence] = None,
              smoke: bool = False, device: DeviceLike = None) -> List[Dict]:
    """Runs every point of a sweep on ``device`` (None: CUDA); returns
    the list of result dicts annotated with the swept values. A point
    that raises is recorded with its error and the sweep goes on."""
    device = resolve_device(device)   # no device: raise before any point
    results = []
    axes = axes or REFERENCE_SWEEPS.get(name) or {}
    for cfg in sweep_configs(name, axes):
        swept = {k: getattr(cfg, k) for k in axes}
        if smoke:
            # shrink first, then re-apply the swept axis — smoke()'s
            # blanket shrink would otherwise clobber it and every
            # point would silently run the same config
            cfg = dataclasses.replace(cfg.smoke(), **swept)
        try:
            res = run_experiment(cfg, smoke=False, device=device)
        except Exception as ex:  # e.g. out of device memory on the
            # biggest cell: record the failure, keep the completed cells
            res = {"config": cfg.name,
                   "error": f"{type(ex).__name__}: {str(ex)[:300]}"}
        res.pop("params", None)
        res.pop("_bundle", None)
        res["swept"] = swept
        results.append(res)
    return results


__all__ = ["REFERENCE_SWEEPS", "sweep_configs", "run_sweep"]
