"""Dataset builders: PDE fields -> padded, stacked graph batches
(counterpart of graph_pde_tpu/data/datasets.py; Darcy GKN and Burgers).

- ``load_or_generate_darcy`` / ``load_or_generate_burgers``: synthetic
  fields, cached on disk.
- ``prepare_darcy``: downsample, flatten, normalize (GaussianNormalizer
  on coeff/Kcoeff/Kcoeff_x/Kcoeff_y; UnitGaussian or Gaussian on sol).
- ``darcy_gkn_graphs``: full-grid (UAI1 protocol, one mesh shared by all
  samples) or Nystrom-sampled (m nodes, k graphs per sample) GKN graphs,
  flat or blocked-CSR (``node_block``). Node features [x, y, a, a_smooth,
  a_gradx, a_grady]; edge attributes [x_i, x_j, a_i, a_j].
- ``prepare_burgers``, ``burgers_gkn_graphs`` (1-d Nystrom GKN graphs,
  node features [x, a]) and ``burgers_multipole_data`` (the orthogonal
  MGKN's level grids, FMM edge lists and per-sample edge attributes).
- ``darcy_mgkn_graphs``: the general MGKN's multilevel Darcy graphs.
- ``batch_iterator``: stacked sub-batches of a leading-batch-axis tree
  (Graphs, other dataclasses such as MultipoleGraph1D, dicts, lists);
  ``prefetch_to_device`` keeps a few of them in flight to the device.

The builders are host numpy and give the same arrays as the JAX
package's from the same seed.
"""
from __future__ import annotations

import collections
import dataclasses
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..graph.graph import (_ARRAY_FIELDS, Graph, build_graph,
                           build_multilevel_graph, round_up, stack_graphs)
from ..graph.mesh import (RandomMeshGenerator, RandomMultiMeshGenerator,
                          SquareMeshGenerator)
from ..graph.multipole import get_edge_attr, multi_pole_grid1d
from ..utils.normalizers import GaussianNormalizer, UnitGaussianNormalizer


def load_or_generate_darcy(n: int, s: int, seed: int = 0,
                           cache_dir: str = ".data_cache"
                           ) -> Dict[str, np.ndarray]:
    """Synthetic Darcy fields, cached as ``.npz`` under ``cache_dir``
    (generation at s=241 costs about half a second per sample)."""
    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, f"darcy_n{n}_s{s}_seed{seed}.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    from .synthetic import darcy_dataset

    data = darcy_dataset(n, s, seed=seed)
    np.savez_compressed(path, **data)
    return data


def load_or_generate_burgers(n: int, s: int, seed: int = 0,
                             cache_dir: str = ".data_cache",
                             nu: float = 0.01) -> Dict[str, np.ndarray]:
    """Synthetic Burgers pairs ``{"a", "u"}`` [n, s], cached as ``.npz``
    under ``cache_dir`` (the JAX package's file name)."""
    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, f"burgers_n{n}_s{s}_nu{nu}_seed{seed}.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    from .synthetic import burgers_dataset

    data = burgers_dataset(n, s, seed=seed, nu=nu)
    np.savez_compressed(path, **data)
    return data


def _np(v) -> np.ndarray:
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


@dataclasses.dataclass
class DarcyArrays:
    """Normalized flat per-sample fields [n, s*s] and the u normalizer."""
    a: np.ndarray
    a_smooth: np.ndarray
    a_gradx: np.ndarray
    a_grady: np.ndarray
    u: np.ndarray           # encoded
    u_normalizer: object
    s: int


def prepare_darcy(fields: Dict[str, np.ndarray], n: int, r: int = 1,
                  normalizers: Optional[dict] = None,
                  u_norm: str = "unit",
                  u_normalizer=None) -> Tuple[DarcyArrays, dict]:
    """Downsamples by r, flattens and normalizes. Returns the arrays and
    the fitted input normalizers (pass them back in for a test set). With
    ``u_normalizer`` given, u stays un-encoded, as in the reference."""
    def ds(x):
        return x[:n, ::r, ::r].reshape(n, -1)

    a = ds(fields["coeff"])
    a_s = ds(fields["Kcoeff"])
    a_gx = ds(fields["Kcoeff_x"])
    a_gy = ds(fields["Kcoeff_y"])
    u = ds(fields["sol"])
    s = fields["coeff"][:, ::r, ::r].shape[1]

    if normalizers is None:
        normalizers = {
            "a": GaussianNormalizer(a),
            "a_smooth": GaussianNormalizer(a_s),
            "a_gradx": GaussianNormalizer(a_gx),
            "a_grady": GaussianNormalizer(a_gy),
        }
    a = _np(normalizers["a"].encode(a))
    a_s = _np(normalizers["a_smooth"].encode(a_s))
    a_gx = _np(normalizers["a_gradx"].encode(a_gx))
    a_gy = _np(normalizers["a_grady"].encode(a_gy))

    if u_normalizer is None:
        u_normalizer = (UnitGaussianNormalizer(u) if u_norm == "unit"
                        else GaussianNormalizer(u))
        u_enc = _np(u_normalizer.encode(u))
    else:
        u_enc = u
    return (DarcyArrays(a, a_s, a_gx, a_gy, u_enc, u_normalizer, s),
            normalizers)


def _darcy_node_features(grid, arrays: DarcyArrays, j: int, idx):
    cols = [grid]
    for f in (arrays.a, arrays.a_smooth, arrays.a_gradx, arrays.a_grady):
        v = f[j] if idx is None else f[j][idx]
        cols.append(v.reshape(-1, 1))
    return np.concatenate(cols, axis=1)


def darcy_gkn_graphs(
    arrays: DarcyArrays,
    *,
    m: Optional[int] = None,
    k: int = 1,
    radius: float = 0.25,
    seed: int = 0,
    edge_multiple: int = 512,
    n_edge_pad: Optional[int] = None,
    node_block: int = 0,
) -> Graph:
    """Stacked host GKN graphs. m=None: the full grid, one mesh shared
    by every sample; m set: Nystrom sampling, k graphs per sample.
    ``node_block`` > 0 emits the blocked-CSR layout with one per-block
    edge capacity across the batch."""
    s = arrays.s
    n = arrays.a.shape[0]
    raw = []
    if m is None:
        gen = SquareMeshGenerator([[0, 1], [0, 1]], [s, s])
        ei = gen.ball_connectivity(radius)
        grid = gen.get_grid()
        for j in range(n):
            attr = gen.attributes(theta=arrays.a[j])
            x = _darcy_node_features(grid, arrays, j, None)
            raw.append((x, ei, attr, arrays.u[j], np.arange(s * s)))
    else:
        gen = RandomMeshGenerator([[0, 1], [0, 1]], [s, s], sample_size=m,
                                  seed=seed)
        for j in range(n):
            for _ in range(k):
                idx = gen.sample()
                grid = gen.get_grid()
                ei = gen.ball_connectivity(radius)
                attr = gen.attributes(theta=arrays.a[j])
                x = _darcy_node_features(grid, arrays, j, idx)
                raw.append((x, ei, attr, arrays.u[j][idx], idx))

    e_max = max(r[1].shape[1] for r in raw)
    e_pad = n_edge_pad or round_up(e_max, edge_multiple)
    n_pad = round_up(raw[0][0].shape[0], 8)
    if node_block:
        bec = 0
        for (x, ei, attr, y, si) in raw:
            g = build_graph(x, ei[0], ei[1], attr, node_block=node_block,
                            edge_multiple=edge_multiple)
            bec = max(bec, g.senders.shape[0] // (g.x.shape[0] // node_block))
        graphs = [
            build_graph(x, ei[0], ei[1], attr, y=y, sample_idx=si,
                        n_node_pad=n_pad, node_block=node_block,
                        block_edge_cap=bec, edge_multiple=edge_multiple)
            for (x, ei, attr, y, si) in raw
        ]
        return stack_graphs(graphs)
    graphs = [
        build_graph(x, ei[0], ei[1], attr, y=y, sample_idx=si,
                    n_node_pad=n_pad, n_edge_pad=e_pad)
        for (x, ei, attr, y, si) in raw
    ]
    return stack_graphs(graphs)


@dataclasses.dataclass
class BurgersArrays:
    a: np.ndarray          # encoded [n, s]
    u: np.ndarray          # encoded [n, s] (raw with encode_u=False)
    a_normalizer: object
    u_normalizer: object
    s: int


def darcy_mgkn_graphs(
    arrays: DarcyArrays,
    *,
    points: Sequence[int],
    radius_inner: Sequence[float],
    radius_inter: Sequence[float],
    k: int = 1,
    seed: int = 0,
    edge_multiple: int = 256,
    caps: Optional[tuple] = None,
):
    """Stacked host multilevel graphs of the general MGKN, k draws per
    sample from one RandomMultiMeshGenerator (MGKN_general_darcy2d.py:
    226-257), and their (mid, down, up) edge capacities. ``caps`` are
    minimums: random radius graphs have sample-dependent edge counts, so
    another sample set (test, evaluation) may need more, and grows
    them."""
    s = arrays.s
    n = arrays.a.shape[0]
    level = len(points)
    gen = RandomMultiMeshGenerator([[0, 1], [0, 1]], [s, s], level=level,
                                   sample_sizes=list(points), seed=seed)
    raw = []
    for j in range(n):
        for _ in range(k):
            idx, idx_all = gen.sample()
            gen.ball_connectivity(radius_inner, radius_inter)
            attr, attr_down, attr_up = gen.attributes(theta=arrays.a[j])
            rng_mid, rng_down, rng_up = gen.get_edge_index_range()
            mid_attrs = [attr[rng_mid[l, 0]:rng_mid[l, 1]]
                         for l in range(level)]
            down_attrs = [attr_down[rng_down[l, 0]:rng_down[l, 1]]
                          for l in range(level - 1)]
            up_attrs = [attr_up[rng_up[l, 0]:rng_up[l, 1]]
                        for l in range(level - 1)]
            _, grid_all = gen.get_grid()
            x = _darcy_node_features(grid_all, arrays, j, idx_all)
            y = arrays.u[j][idx[0]]
            raw.append((x, [e.copy() for e in gen.edge_index], mid_attrs,
                        [e.copy() for e in gen.edge_index_down], down_attrs,
                        [e.copy() for e in gen.edge_index_up], up_attrs,
                        y, idx[0]))

    need_mid = tuple(
        round_up(max(r[1][l].shape[1] for r in raw), edge_multiple)
        for l in range(level))
    need_down = tuple(
        round_up(max(r[3][l].shape[1] for r in raw), edge_multiple)
        for l in range(level - 1))
    if caps is None:
        mid_caps, down_caps, up_caps = need_mid, need_down, need_down
    else:
        mid_caps = tuple(max(a, b) for a, b in zip(caps[0], need_mid))
        down_caps = tuple(max(a, b) for a, b in zip(caps[1], need_down))
        up_caps = tuple(max(a, b) for a, b in zip(caps[2], need_down))
    graphs = [
        build_multilevel_graph(
            x, points, mid_e, mid_a, down_e, down_a, up_e, up_a,
            y=y, sample_idx=si,
            mid_caps=mid_caps, down_caps=down_caps, up_caps=up_caps)
        for (x, mid_e, mid_a, down_e, down_a, up_e, up_a, y, si) in raw
    ]
    return stack_graphs(graphs), (mid_caps, down_caps, up_caps)


def prepare_burgers(fields: Dict[str, np.ndarray], n: int, r: int = 1,
                    a_normalizer=None, u_normalizer=None,
                    encode_u: bool = True) -> BurgersArrays:
    """Downsamples by r and normalizes: a Gaussian normalizer on a, a
    unit (per-point) one on u, each fitted here unless given."""
    a = fields["a"][:n, ::r]
    u = fields["u"][:n, ::r]
    s = a.shape[1]
    if a_normalizer is None:
        a_normalizer = GaussianNormalizer(a)
    if u_normalizer is None:
        u_normalizer = UnitGaussianNormalizer(u)
    a = _np(a_normalizer.encode(a))
    if encode_u:
        u = _np(u_normalizer.encode(u))
    return BurgersArrays(a, u, a_normalizer, u_normalizer, s)


def burgers_gkn_graphs(
    arrays: BurgersArrays,
    *,
    m: int,
    k: int = 1,
    radius: float = 0.25,
    seed: int = 0,
    edge_multiple: int = 512,
    n_edge_pad: Optional[int] = None,
) -> Graph:
    """Stacked 1-d Nystrom GKN graphs (neurips5_GKN.py:110-135): node
    features [x, a], edge attributes [x_i, x_j, a_i, a_j]."""
    s = arrays.s
    n = arrays.a.shape[0]
    gen = RandomMeshGenerator([[0, 1]], [s], sample_size=m, seed=seed)
    raw = []
    for j in range(n):
        for _ in range(k):
            idx = gen.sample()
            grid = gen.get_grid()
            ei = gen.ball_connectivity(radius)
            attr = gen.attributes(theta=arrays.a[j])
            x = np.concatenate([grid, arrays.a[j][idx][:, None]], axis=1)
            raw.append((x, ei, attr, arrays.u[j][idx], idx))
    e_max = max(r[1].shape[1] for r in raw)
    e_pad = n_edge_pad or round_up(e_max, edge_multiple)
    graphs = [
        build_graph(x, ei[0], ei[1], attr, y=y, sample_idx=si,
                    n_node_pad=round_up(m, 8), n_edge_pad=e_pad)
        for (x, ei, attr, y, si) in raw
    ]
    return stack_graphs(graphs)


def burgers_multipole_data(arrays: BurgersArrays, is_periodic: bool = True):
    """The orthogonal MGKN's data (MGKN_orthogonal_burgers1d.py:146-183):
    (xs [n, s, 2] = [x, a], ys [n, s, 1], senders, receivers: one int64
    [E_l] array per edge list, shared by every sample, attrs: one
    [n, E_l, 4] array per edge list). Edge list 0 (nearest neighbors)
    and 1 take the finest level's grid and a, edge list l > 1 level l's."""
    n, s = arrays.a.shape
    theta = arrays.a[:, :, None]
    grids, thetas, edges = multi_pole_grid1d(theta, 1, s, n,
                                             is_periodic=is_periodic)
    senders = [e[0].astype(np.int64) for e in edges]
    receivers = [e[1].astype(np.int64) for e in edges]
    attrs = []
    for i, e in enumerate(edges):
        li = max(i - 1, 0)
        attrs.append(np.stack([
            get_edge_attr(grids[li], thetas[li][j, :, 0], e)
            for j in range(n)]))
    xs = np.stack([np.stack([grids[0], arrays.a[j]], axis=1)
                   for j in range(n)])
    ys = arrays.u[:, :, None]
    return (xs.astype(np.float32), ys.astype(np.float32), senders,
            receivers, attrs)


def map_arrays(fn, tree):
    """``fn`` applied to every array (numpy or torch) of a tree of
    Graphs, other dataclasses, dicts, tuples and lists; other leaves are
    kept."""
    if isinstance(tree, Graph):
        return dataclasses.replace(tree, **{
            f: fn(getattr(tree, f)) for f in _ARRAY_FIELDS
            if getattr(tree, f) is not None})
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: map_arrays(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: map_arrays(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_arrays(fn, v) for v in tree)
    if isinstance(tree, (np.ndarray, torch.Tensor)):
        return fn(tree)
    return tree


def leading_size(tree) -> int:
    """The leading (batch) size of a stacked tree."""
    if isinstance(tree, Graph):
        return tree.x.shape[0]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return leading_size(getattr(tree, dataclasses.fields(tree)[0].name))
    if isinstance(tree, dict):
        return leading_size(next(iter(tree.values())))
    if isinstance(tree, (tuple, list)):
        return leading_size(tree[0])
    return tree.shape[0]


def batch_iterator(stacked, batch_size: int,
                   rng: Optional[np.random.Generator] = None,
                   drop_remainder: bool = True):
    """Yields stacked sub-batches of a leading-batch-axis tree, in an
    order shuffled by ``rng`` when one is given."""
    n = leading_size(stacked)
    order = np.arange(n)
    if rng is not None:
        rng.shuffle(order)
    end = (n // batch_size) * batch_size if drop_remainder else n
    for i in range(0, end, batch_size):
        sel = order[i: i + batch_size]

        def take(a, sel=sel):
            if isinstance(a, torch.Tensor):
                return a[torch.as_tensor(sel, device=a.device)]
            return a[sel]

        yield map_arrays(take, stacked)


def prefetch_to_device(iterator, size: int = 2, sharding=None,
                       device: DeviceLike = None):
    """Yields the batches of ``iterator`` on ``device`` (None: CUDA),
    keeping ``size`` of them in flight: each batch's arrays are copied
    with non-blocking copies from pinned host memory, so the copies of
    the next batches overlap the current step's work. ``sharding``, a
    function from a batch to this rank's part of it (e.g.
    ``functools.partial(parallel.batch_sharding, mesh)``), is applied on
    the host first, so each rank copies only its data shard."""
    dev = resolve_device(device)

    def move(a):
        t = torch.as_tensor(a)
        if dev.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory()
        return t.to(dev, non_blocking=True)

    it, queue, end = iter(iterator), collections.deque(), object()

    def put():
        batch = next(it, end)
        if batch is not end:
            if sharding is not None:
                batch = sharding(batch)
            queue.append(map_arrays(move, batch))

    for _ in range(size):
        put()
    while queue:
        out = queue.popleft()
        put()
        yield out


__all__ = ["load_or_generate_darcy", "load_or_generate_burgers",
           "DarcyArrays", "prepare_darcy", "darcy_gkn_graphs",
           "darcy_mgkn_graphs", "BurgersArrays", "prepare_burgers",
           "burgers_gkn_graphs",
           "burgers_multipole_data", "batch_iterator", "prefetch_to_device",
           "map_arrays", "leading_size"]
