"""Metric logging, profiling and figures (counterpart of
graph_pde_tpu/train/metrics.py).

``MetricsLogger`` writes a per-epoch metric stream (stdout line, JSONL
file, in-memory history) and the reference's ``np.savetxt`` error-curve
files. ``profile_trace`` captures a ``torch.profiler`` trace. The
``save_*_triptych`` functions write the truth/approx/error figures the
reference saves per run (UAI1_full_resolution.py:335-461); each returns
None where matplotlib cannot be imported.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from ..utils import tracing


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
    ``<log_dir>/trace.json`` (Chrome trace format). The program's spans
    (``utils.tracing``) enter it as ranges above the operators and
    kernels they launched. Yields the profiler, whose
    ``key_averages()`` sums the time by operator and span."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        with tracing.recording(profiler_ranges=True):
            yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _pyplot():
    """matplotlib.pyplot on the Agg backend, or None where matplotlib
    cannot be imported."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return None
    return plt


def _save(plt, fig, path: str, title: str) -> str:
    if title:
        fig.suptitle(title)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fig.savefig(path, dpi=100, bbox_inches="tight")
    plt.close(fig)
    return path


def _triptych(plt, truth, approx, draw, path: str, title: str) -> str:
    """Truth, approx and error panels, each drawn by ``draw(ax, values)``
    with a colorbar."""
    t, a = np.asarray(truth), np.asarray(approx)
    fig, axes = plt.subplots(1, 3, figsize=(12, 4))
    for ax, (vals, name) in zip(axes, [(t, "truth"), (a, "approx"),
                                       (t - a, "error")]):
        fig.colorbar(draw(ax, vals), ax=ax, fraction=0.046)
        ax.set_title(name)
    return _save(plt, fig, path, title)


def save_field_triptych(truth: np.ndarray, approx: np.ndarray,
                        path: str, title: str = "") -> Optional[str]:
    """Truth / prediction / error triptych on a square grid."""
    plt = _pyplot()
    if plt is None:
        return None
    s = int(round(np.sqrt(np.asarray(truth).size)))
    return _triptych(plt, np.reshape(truth, (s, s)),
                     np.reshape(approx, (s, s)),
                     lambda ax, img: ax.imshow(img), path, title)


def save_points_triptych(xy: np.ndarray, truth: np.ndarray,
                         approx: np.ndarray, path: str,
                         title: str = "") -> Optional[str]:
    """Truth / prediction / error triptych for scattered (Nystrom) nodes,
    where no full grid exists."""
    plt = _pyplot()
    if plt is None:
        return None

    def draw(ax, vals):
        ax.set_aspect("equal")
        return ax.scatter(xy[:, 0], xy[:, 1], c=vals, s=14)

    return _triptych(plt, truth, approx, draw, path, title)


def save_line_triptych(x: np.ndarray, truth: np.ndarray,
                       approx: np.ndarray, path: str,
                       title: str = "") -> Optional[str]:
    """1-D variant (Burgers): truth and prediction overlaid, and the
    error."""
    plt = _pyplot()
    if plt is None:
        return None
    t, a = np.asarray(truth), np.asarray(approx)
    fig, axes = plt.subplots(1, 2, figsize=(10, 4))
    axes[0].plot(x, t, label="truth")
    axes[0].plot(x, a, "--", label="approx")
    axes[0].legend()
    axes[0].set_title("truth vs approx")
    axes[1].plot(x, t - a)
    axes[1].set_title("error")
    return _save(plt, fig, path, title)


__all__ = ["MetricsLogger", "profile_trace", "save_field_triptych",
           "save_points_triptych", "save_line_triptych"]
