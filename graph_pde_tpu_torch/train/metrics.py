"""Metric logging and profiling (counterpart of
graph_pde_tpu/train/metrics.py; the triptych figures are not ported yet).

``MetricsLogger`` writes a per-epoch metric stream (stdout line, JSONL
file, in-memory history) and the reference's ``np.savetxt`` error-curve
files. ``profile_trace`` captures a ``torch.profiler`` trace.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Optional

import numpy as np
import torch


class MetricsLogger:
    """Per-epoch metric stream: stdout line + JSONL file + in-memory
    history; ``save_txt`` emits the reference's np.savetxt layout."""

    def __init__(self, out_dir: Optional[str] = None,
                 name: str = "run", echo: bool = True):
        self.out_dir = out_dir
        self.name = name
        self.echo = echo
        self.history: list = []
        self._t0 = time.perf_counter()
        self._file = None
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            self._file = open(os.path.join(out_dir, f"{name}.jsonl"), "a")

    def log(self, step: int, **metrics) -> None:
        rec = {"step": step, "time": time.perf_counter() - self._t0}
        rec.update({k: (float(v) if v is not None else None)
                    for k, v in metrics.items()})
        self.history.append(rec)
        if self.echo:
            msg = " ".join(f"{k}={v:.6g}" if isinstance(v, float) else
                           f"{k}={v}" for k, v in rec.items())
            print(msg, flush=True)
        if self._file:
            self._file.write(json.dumps(rec) + "\n")
            self._file.flush()

    def save_txt(self, key: str, path: Optional[str] = None) -> np.ndarray:
        """Reference-style error-curve file (np.savetxt of the per-epoch
        array)."""
        arr = np.asarray([r.get(key, np.nan) for r in self.history])
        if path is None and self.out_dir:
            path = os.path.join(self.out_dir, f"{self.name}_{key}.txt")
        if path:
            np.savetxt(path, arr)
        return arr

    def close(self) -> None:
        if self._file:
            self._file.close()
            self._file = None


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Captures a ``torch.profiler`` trace of the enclosed block (CPU
    and, where there is one, CUDA activity) and writes it as
    ``<log_dir>/trace.json`` (Chrome trace format). Yields the
    profiler, whose ``key_averages()`` sums the time by operator."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


__all__ = ["MetricsLogger", "profile_trace"]
