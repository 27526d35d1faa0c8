"""ctypes bindings for the compiled cell-list graph builder
(``native/graph_build.cpp``; counterpart of graph_pde_tpu/graph/native.py).

The library is compiled with g++ at first use (the flags of
``native/Makefile``) into the package's ``_build/`` directory, under a name
that carries a hash of the source and the flags; it is written to a
temporary file and renamed into place, so several processes may build it
at once. Nothing builds at import time, and nothing is written into
``native/``. Where no toolchain exists, ``available()`` is False and the
callers in ``graph.build`` fall back to cKDTree or dense numpy.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "graph_build.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17",
             "-Wall")

_lock = threading.Lock()
_lib = None
_build_failed = False

_f64p = ctypes.POINTER(ctypes.c_double)
_i64p = ctypes.POINTER(ctypes.c_int64)


def library_path() -> Path:
    h = hashlib.sha1(" ".join(CXX_FLAGS).encode() + b"\0"
                     + SOURCE.read_bytes())
    return BUILD_DIR / f"libgpde_graph-{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compiles the library if it is missing; returns its path. Raises
    RuntimeError when there is no source or no compiler, or g++ fails."""
    if not SOURCE.exists():
        raise RuntimeError(f"{SOURCE} not found")
    path = library_path()
    if path.exists():
        return path
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler: the graph builder cannot be "
                           "built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return path


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            lib = ctypes.CDLL(str(build()))
        except (RuntimeError, OSError, subprocess.SubprocessError):
            _build_failed = True
            return None
        lib.gpde_radius_graph.restype = ctypes.c_int64
        lib.gpde_radius_graph.argtypes = [_f64p, ctypes.c_int64, _f64p,
                                          ctypes.c_int64, ctypes.c_int64,
                                          ctypes.c_double]
        lib.gpde_copy_edges.restype = None
        lib.gpde_copy_edges.argtypes = [_i64p, _i64p]
        lib.gpde_torus2d_graph.restype = ctypes.c_int64
        lib.gpde_torus2d_graph.argtypes = [_f64p, ctypes.c_int64,
                                           ctypes.c_double]
        lib.gpde_copy_torus_edges.restype = None
        lib.gpde_copy_torus_edges.argtypes = [_i64p, _i64p, _f64p, _f64p,
                                              _f64p]
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the compiled builder loads (building it if needed)."""
    return _load() is not None


def _ptr(a: np.ndarray, kind):
    return a.ctypes.data_as(kind)


def native_radius(points: np.ndarray, points_b: Optional[np.ndarray],
                  r: float) -> Tuple[np.ndarray, np.ndarray]:
    """All (i, j) with |a_i - b_j| <= r (b = a when ``points_b`` is None),
    self-pairs included, in the builder's order (callers sort). Raises
    RuntimeError when the library is unavailable or d > 3."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native graph builder unavailable")
    a = np.ascontiguousarray(points, np.float64)
    if a.ndim == 1:
        a = a[:, None]
    na, dim = a.shape
    if dim > 3:
        raise RuntimeError("native builder supports d <= 3")
    b_ptr, nb = None, 0
    if points_b is not None:
        b = np.ascontiguousarray(points_b, np.float64)
        if b.ndim == 1:
            b = b[:, None]
        if b.shape[1] != dim:
            raise ValueError("points and points_b differ in dimension")
        b_ptr, nb = _ptr(b, _f64p), b.shape[0]
    # The library keeps its edges in thread-local buffers between the two
    # calls; the lock keeps two Python threads from interleaving them.
    with _lock:
        count = lib.gpde_radius_graph(_ptr(a, _f64p), na, b_ptr, nb, dim,
                                      float(r))
        if count < 0:
            raise RuntimeError("native radius graph failed")
        src = np.empty(count, np.int64)
        dst = np.empty(count, np.int64)
        if count > 0:
            lib.gpde_copy_edges(_ptr(src, _i64p), _ptr(dst, _i64p))
    return src, dst


def native_torus2d(points: np.ndarray, r: float):
    """Periodic minimum-image radius graph on [0, 1)^2: (edge_index
    [2, E], dist, dx, dy) sorted by (src, dst), the order and geometry of
    the dense numpy path. Raises RuntimeError when the library is
    unavailable."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native graph builder unavailable")
    p = np.ascontiguousarray(points, np.float64).reshape(-1, 2)
    with _lock:
        count = lib.gpde_torus2d_graph(_ptr(p, _f64p), p.shape[0], float(r))
        if count < 0:
            raise RuntimeError("native torus graph failed")
        src = np.empty(count, np.int64)
        dst = np.empty(count, np.int64)
        dist, dx, dy = (np.empty(count, np.float64) for _ in range(3))
        if count > 0:
            lib.gpde_copy_torus_edges(_ptr(src, _i64p), _ptr(dst, _i64p),
                                      _ptr(dist, _f64p), _ptr(dx, _f64p),
                                      _ptr(dy, _f64p))
    order = np.lexsort((dst, src))
    return (np.stack([src[order], dst[order]]), dist[order], dx[order],
            dy[order])


__all__ = ["native_radius", "native_torus2d", "available", "build",
           "library_path"]
