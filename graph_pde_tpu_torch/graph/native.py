"""ctypes bindings for the compiled cell-list graph builder
(``native/graph_build.cpp``; counterpart of graph_pde_tpu/graph/native.py)
and the port's own window pass (``graph/window_graphs.cpp``: one window of
the general MGKN's splitter, its edge lists sorted, typed and attributed
as the padded ``MultiLevelGraph`` holds them).

Both sources are compiled with g++ at first use (the flags of
``native/Makefile``) into one library in the package's ``_build/``
directory, under a name that carries a hash of the sources and the flags;
it is written to a temporary file and renamed into place, so several
processes may build it at once. Nothing builds at import time, and
nothing is written into ``native/``. Where no toolchain exists,
``available()`` is False and the callers in ``graph.build`` and
``graph.splitters`` fall back to cKDTree, dense numpy or the numpy chain.
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

SOURCES = (Path(__file__).resolve().parents[2] / "native" / "graph_build.cpp",
           Path(__file__).resolve().parent / "window_graphs.cpp")
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17",
             "-Wall")

_lock = threading.Lock()
_lib = None
_build_failed = False

_f64p = ctypes.POINTER(ctypes.c_double)
_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_f32p = ctypes.POINTER(ctypes.c_float)
_u8p = ctypes.POINTER(ctypes.c_uint8)


def library_path() -> Path:
    h = hashlib.sha1(" ".join(CXX_FLAGS).encode())
    for src in SOURCES:
        h.update(b"\0" + src.read_bytes())
    return BUILD_DIR / f"libgpde_graph-{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compiles the library if it is missing; returns its path. Raises
    RuntimeError when a source or the compiler is missing, or g++ fails."""
    for src in SOURCES:
        if not src.exists():
            raise RuntimeError(f"{src} not found")
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
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp,
                           *(str(src) for src in SOURCES)],
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
        lib.gpde_window_graphs.restype = ctypes.c_int64
        lib.gpde_window_graphs.argtypes = [_f64p, ctypes.c_int64, _i64p,
                                           ctypes.c_int64, _f64p, _f64p,
                                           _f64p, ctypes.c_int64, _i64p]
        lib.gpde_place_window.restype = ctypes.c_int64
        lib.gpde_place_window.argtypes = [ctypes.c_int64, ctypes.c_int64,
                                          _i64p, _i64p, ctypes.c_int64,
                                          _i32p, _i32p, _f32p, _u8p]
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


def native_window_graphs(points: np.ndarray, level_sizes, r_inner,
                         r_inter, theta: np.ndarray, slot: int
                         ) -> np.ndarray:
    """Builds one splitter window's 3L - 2 edge lists (mid_0..mid_{L-1},
    down_0..down_{L-2}, up_0..up_{L-2}) into the calling thread's slot
    ``slot``, from its points [n_tot, d] (level l in consecutive rows,
    ``level_sizes[l]`` of them) and its edge attributes' field theta
    [n_tot]; returns each list's edge count [3L - 2]. Each list holds
    exactly the edges, indices, order and attributes that
    ``build_multilevel_graph`` pads from ``radius_connectivity`` and
    ``edge_attributes``: sorted by (receiver, sender), mid indices local
    to their level, down and up global; ``native_place_windows`` writes
    them out. The slots keep their memory between calls. Raises
    RuntimeError when the library is unavailable, d > 3 or an input is
    out of its range."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native graph builder unavailable")
    p = np.ascontiguousarray(points, np.float64)
    if p.ndim == 1:
        p = p[:, None]
    n_tot, dim = p.shape
    if dim > 3:
        raise RuntimeError("native builder supports d <= 3")
    sizes = np.ascontiguousarray(level_sizes, np.int64)
    levels = sizes.shape[0]
    if sizes.sum() != n_tot:
        raise ValueError(f"{n_tot} points for levels of {sizes.tolist()}")
    r_in = np.ascontiguousarray(r_inner[:levels], np.float64)
    r_out = np.ascontiguousarray(list(r_inter[:levels - 1]) or [1.0],
                                 np.float64)
    if r_in.shape[0] != levels or r_out.shape[0] < levels - 1:
        raise RuntimeError("one inner radius a level and one inter radius "
                           "a pair of levels")
    th = np.ascontiguousarray(theta, np.float64).reshape(n_tot)
    counts = np.empty(3 * levels - 2, np.int64)
    # the slots are the calling thread's own: no lock
    total = lib.gpde_window_graphs(
        _ptr(p, _f64p), dim, _ptr(sizes, _i64p), levels, _ptr(r_in, _f64p),
        _ptr(r_out, _f64p), _ptr(th, _f64p), slot, _ptr(counts, _i64p))
    if total < 0:
        raise RuntimeError("native window graphs failed")
    return counts


def native_place_windows(slots, caps, parks, a_dim: int):
    """The lists that ``native_window_graphs`` built into the calling
    thread's ``slots``, one row a slot: list k padded to ``caps[k]`` as
    ``build_multilevel_graph`` pads (padding parked at receiver
    ``parks[k] - 1``) and the lists concatenated: (senders int32 [W, C],
    receivers int32 [W, C], attributes float32 [W, C, a_dim], mask bool
    [W, C]), C = sum(caps). One block a field, so that numpy backs a
    large request with huge pages. Raises RuntimeError when a slot holds
    no window of these lists and ``a_dim`` attributes, or a list exceeds
    its capacity."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native graph builder unavailable")
    caps = np.ascontiguousarray(caps, np.int64)
    parks = np.ascontiguousarray(parks, np.int64)
    if parks.shape != caps.shape:
        raise ValueError("one parking receiver a capacity")
    shape = (len(slots), int(caps.sum()))
    senders = np.empty(shape, np.int32)
    receivers = np.empty(shape, np.int32)
    attr = np.empty(shape + (a_dim,), np.float32)
    mask = np.empty(shape, bool)
    for row, slot in enumerate(slots):
        rc = lib.gpde_place_window(
            slot, caps.shape[0], _ptr(caps, _i64p), _ptr(parks, _i64p),
            a_dim, _ptr(senders[row], _i32p), _ptr(receivers[row], _i32p),
            _ptr(attr[row], _f32p), _ptr(mask[row], _u8p))
        if rc != 0:
            raise RuntimeError(f"window slot {slot} holds no window of "
                               "these lists within these caps")
    return senders, receivers, attr, mask


__all__ = ["native_radius", "native_torus2d", "native_window_graphs",
           "native_place_windows", "available", "build", "library_path"]
