"""Serving API (counterpart of graph_pde_tpu/inference.py; GKN and the
general and orthogonal MGKN).

``GKNPredictor`` maps raw Darcy coefficient fields to decoded solution
fields at any grid resolution:

- small grids: one full radius graph per sample, all samples of a call
  run as one batch;
- large grids (more than ``split_threshold`` nodes): split/assemble
  through ``RandomGridSplitter`` shards, one batch of shards per sample.

Graphs are built on the host as in the JAX package, moved to the
predictor's device once per batch, and run by ``gkn_apply_batched``.

``MGKNGeneralPredictor`` maps raw Darcy coefficient fields to decoded
solution fields through the reference's full-field protocol: windows of
``RandomMultiMeshSplitter`` cover every grid node, the windows' multilevel
graphs run forward stacked (as many a forward as ``window_group_size``
lets fit the device's free memory: every window at once on the host),
and the assembler stitches the finest levels' predictions back.

``MGKNOrthogonalPredictor`` maps raw Burgers initial conditions a [n, s]
to decoded solutions at the training resolution ``cfg.s`` (the level
hierarchy is baked into the weights), all n samples as one batch.

Predictors run on CUDA unless given ``device="cpu"``.

Spans (``utils.tracing``): ``predict`` around each predictor's call,
``predict.encode`` (auxiliary fields and input encoding) inside it; the
general MGKN's windows add ``split`` (the splitter), one ``window`` a
group of stacked windows with ``window.h2d`` (their graphs stacked and
moved to the device), ``window.forward`` (the model's enqueue) and
``window.readback`` (the wait for the device and the copy back), and
``assemble`` (decode and stitch). Counters: ``readbacks`` and
``readback_bytes``, each device tensor copied back to the host;
``window_forwards``, each stacked forward of a group of windows.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .graph import (RandomGridSplitter, RandomMultiMeshSplitter,
                    SquareMeshGenerator, build_graph, edge_attributes,
                    make_box_grid, round_up, stack_graphs)
from .models.gkn import GKNConfig, gkn_apply_batched, params_to
from .models.mgkn_general import (MGKNGeneralConfig,
                                  mgkn_general_apply_batched)
from .models.mgkn_orthogonal import (MGKNOrthogonalConfig,
                                     mgkn_orthogonal_apply_batched,
                                     multipole_batch)
from .ops.edge_conv import resolve_dtype
from .utils import tracing


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        if t.device.type == "cuda":
            tracing.count("readbacks")
            tracing.count("readback_bytes", t.nbytes)
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _check_unit_norm_resolution(u_normalizer, s_nodes: int, family: str):
    """A unit u-normalizer carries per-node stats of the training grid:
    decoding another resolution with positional sample_idx would read
    the wrong rows, so it is refused."""
    u_stats = _np(getattr(u_normalizer, "mean", 0.0))
    if u_stats.ndim >= 1 and u_stats.size > 1 and u_stats.size != s_nodes:
        raise ValueError(
            f"bundle's unit u-normalizer has per-node stats for "
            f"{u_stats.size} training-grid nodes but input has "
            f"{s_nodes} nodes; serve {family} at the training "
            f"resolution, or train/export with u_norm='gaussian' for "
            f"resolution-free serving")


def _encode_darcy(norms, coeff, kcoeff, kx, ky) -> dict:
    """The four input fields, flattened [n, s*s] and encoded."""
    n = coeff.shape[0]
    return {key: _np(norms[key].encode(np.asarray(a).reshape(n, -1)))
            for key, a in (("a", coeff), ("a_smooth", kcoeff),
                           ("a_gradx", kx), ("a_grady", ky))}


def _decode(u_normalizer, values, idx) -> np.ndarray:
    """Decodes on the host, with the stats gathered at ``idx`` where the
    normalizer takes it (falls back as the JAX predictors do)."""
    try:
        return _np(u_normalizer.decode(values, sample_idx=idx))
    except (TypeError, IndexError):
        return _np(u_normalizer.decode(values))


def _decode_rows(u_normalizer, values, idx) -> np.ndarray:
    """One window's decoded predictions, with the stats of its grid
    points ``idx``."""
    return _decode(u_normalizer, values[None], idx[None])[0]


def derive_aux_fields(coeff, kcoeff, kx, ky, s):
    """Derives each missing auxiliary Darcy field independently: the
    smoothed coefficient (gaussian_filter, sigma 1) and its central
    differences on the unit grid, as data/synthetic.py makes them."""
    if kcoeff is None:
        from scipy.ndimage import gaussian_filter as gf

        kcoeff = np.stack([gf(np.asarray(c).reshape(s, s), sigma=1.0)
                           for c in coeff])
    if kx is None or ky is None:
        h = 1.0 / (s - 1)
        grads = [np.gradient(np.asarray(k).reshape(s, s), h)
                 for k in kcoeff]
        if kx is None:
            kx = np.stack([g[0] for g in grads])
        if ky is None:
            ky = np.stack([g[1] for g in grads])
    return kcoeff, kx, ky


@dataclasses.dataclass
class GKNPredictor:
    params: object
    cfg: GKNConfig
    input_normalizers: dict     # 'a', 'a_smooth', 'a_gradx', 'a_grady'
    u_normalizer: object
    radius: float = 0.2
    split_threshold: int = 10_000   # nodes above which to shard
    split_m: int = 400
    device: DeviceLike = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.params = params_to(self.params, self.device)
        self._mesh_cache: Dict[int, tuple] = {}

    # -------------------------------------------------------------- build

    def _node_features(self, grid, fields, j, idx=None):
        cols = [grid]
        for key in ("a", "a_smooth", "a_gradx", "a_grady"):
            v = fields[key][j] if idx is None else fields[key][j][idx]
            cols.append(np.asarray(v).reshape(-1, 1))
        return np.concatenate(cols, axis=1)

    def _fwd(self, batch) -> np.ndarray:
        with torch.inference_mode():
            out = gkn_apply_batched(self.params, self.cfg,
                                    batch.to(self.device))
            return _np(out[:, :, 0])

    # ------------------------------------------------------------ predict

    def predict(self, coeff, kcoeff=None, kx=None, ky=None) -> np.ndarray:
        """coeff (+ optional smoothed/gradient fields): [n, s, s].
        Missing auxiliary fields are derived. Returns decoded solutions
        [n, s*s]."""
        with tracing.span("predict"):
            coeff = np.asarray(coeff)
            n, s = coeff.shape[0], coeff.shape[1]
            _check_unit_norm_resolution(self.u_normalizer, s * s, "gkn")
            with tracing.span("predict.encode"):
                kcoeff, kx, ky = derive_aux_fields(coeff, kcoeff, kx, ky, s)
                fields = _encode_darcy(self.input_normalizers, coeff,
                                       kcoeff, kx, ky)
            if s * s > self.split_threshold:
                return self._predict_split(fields, s)
            return self._predict_full(fields, s)

    def _predict_full(self, fields, s) -> np.ndarray:
        n = fields["a"].shape[0]
        if s not in self._mesh_cache:
            gen = SquareMeshGenerator([[0, 1], [0, 1]], [s, s])
            ei = gen.ball_connectivity(self.radius)
            self._mesh_cache[s] = (gen.get_grid(), ei)
        grid, ei = self._mesh_cache[s]
        graphs = []
        e_pad = round_up(ei.shape[1], 512)
        for j in range(n):
            attr = edge_attributes(grid, ei, theta=fields["a"][j])
            x = self._node_features(grid, fields, j)
            graphs.append(build_graph(
                x, ei[0], ei[1], attr, sample_idx=np.arange(s * s),
                n_edge_pad=e_pad))
        batch = stack_graphs(graphs)
        out = self._fwd(batch)
        dec = self._decode(out, batch.sample_idx)
        return dec[:, : s * s]

    def _predict_split(self, fields, s) -> np.ndarray:
        n = fields["a"].shape[0]
        n_nodes = s * s
        m = _largest_divisor_leq(n_nodes, self.split_m)
        grid = make_box_grid([[0, 1], [0, 1]], [s, s])
        sp = RandomGridSplitter(grid, s, d=2, m=m, l=1, radius=self.radius,
                                seed=0)
        out = np.zeros((n, n_nodes), np.float32)
        for j in range(n):
            theta = np.stack([fields["a"][j], fields["a_smooth"][j],
                              fields["a_gradx"][j],
                              fields["a_grady"][j]], axis=1)
            shards = sp.get_data(theta)
            batch = stack_graphs(shards)
            pred = self._fwd(batch)
            idx = batch.sample_idx
            dec = self._decode(pred, idx)
            preds = [dec[i][:m] for i in range(len(shards))]
            idxs = [idx[i][:m] for i in range(len(shards))]
            out[j] = sp.assemble(preds, idxs)
        return out

    def _decode(self, values, idx) -> np.ndarray:
        return _decode(self.u_normalizer, values, idx)


@dataclasses.dataclass
class MGKNGeneralPredictor:
    """Serves a general-MGKN bundle on raw Darcy coefficient fields
    through the reference's full-field protocol (MGKN_general_darcy2d.py:
    306-333): RandomMultiMeshSplitter windows covering every grid node,
    their multilevel forwards stacked, the assembler's stitch. The graph
    always subsamples to cfg.points, so this is the serving path at any
    grid size."""

    params: object
    cfg: MGKNGeneralConfig
    input_normalizers: dict          # 'a', 'a_smooth', 'a_gradx', 'a_grady'
    u_normalizer: object
    radius_inner: tuple
    radius_inter: tuple
    seed: int = 0
    device: DeviceLike = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.params = params_to(self.params, self.device)
        self._splitters: Dict[int, RandomMultiMeshSplitter] = {}

    def predict(self, coeff, kcoeff=None, kx=None, ky=None) -> np.ndarray:
        """coeff (+ optional smoothed/gradient fields): [n, s, s]. Missing
        auxiliary fields are derived. Returns decoded solutions
        [n, s*s]."""
        with tracing.span("predict"):
            coeff = np.asarray(coeff)
            n, s = coeff.shape[0], coeff.shape[1]
            _check_unit_norm_resolution(self.u_normalizer, s * s,
                                        "mgkn_general")
            with tracing.span("predict.encode"):
                kcoeff, kx, ky = derive_aux_fields(coeff, kcoeff, kx, ky, s)
                enc = _encode_darcy(self.input_normalizers, coeff, kcoeff,
                                    kx, ky)
            if s not in self._splitters:
                self._splitters[s] = RandomMultiMeshSplitter(
                    [[0, 1], [0, 1]], [s, s], level=len(self.cfg.points),
                    sample_sizes=list(self.cfg.points), seed=self.seed)
            sp = self._splitters[s]
            out = np.zeros((n, s * s), np.float32)
            caps = None
            for j in range(n):
                theta_all = np.stack([enc["a"][j], enc["a_smooth"][j],
                                      enc["a_gradx"][j], enc["a_grady"][j]],
                                     axis=1)
                out[j], caps = mgkn_split_predict(
                    self.params, self.cfg, sp, self.radius_inner,
                    self.radius_inter, theta_all, caps, self.u_normalizer,
                    self.device)
            return out


def window_k_bytes(caps, cfg: MGKNGeneralConfig) -> int:
    """The bytes of kernel matrices one window's forward holds at once,
    from its edge capacities ``caps`` (mid, down, up): under
    impl='kcached' every conv's K [E, width**2] in its stored dtype (fp8
    ``k_storage``, else the compute dtype); under 'reference' the
    largest conv's, which the einsum reads in float32 (a bf16 K beside
    its float32 copy). The other impls build no K: 0."""
    lists = [c for part in caps for c in part]
    w2 = cfg.width ** 2
    bf16 = resolve_dtype(cfg.compute_dtype) is not None
    if cfg.impl == "kcached":
        return sum(lists) * w2 * (1 if cfg.k_storage else 2 if bf16 else 4)
    if cfg.impl == "reference":
        return max(lists) * w2 * (6 if bf16 else 4)
    return 0


def window_group_size(caps, cfg: MGKNGeneralConfig, n_windows: int,
                      free_bytes: Optional[int]) -> int:
    """The windows one stacked forward takes: as many as hold their K
    (``window_k_bytes``) in half of ``free_bytes``, the device's free
    memory, and at least one; every window where ``free_bytes`` is None
    (the host) or the impl builds no K."""
    k = window_k_bytes(caps, cfg)
    if free_bytes is None or k == 0:
        return n_windows
    return max(1, min(n_windows, free_bytes // 2 // k))


def mgkn_split_predict(params, cfg: MGKNGeneralConfig,
                       sp: RandomMultiMeshSplitter, radius_inner,
                       radius_inter, theta_all, caps, u_normalizer,
                       device) -> tuple:
    """One sample through the splitter's windows: theta_all [n, 4] its
    encoded fields (a first, the edge attributes' field). The windows,
    padded to one set of capacities, run in order as stacked forwards on
    ``device`` (``window_group_size`` a group: one copy in and one
    readback each); each window is decoded with its own points' stats
    and scattered back (MGKN_general_darcy2d.py:306-332). Returns (the
    decoded field [n], the window capacities, at least ``caps``)."""
    shards, caps = sp.splitter(list(radius_inner), list(radius_inter),
                               theta_all[:, 0], theta_all, caps=caps)
    device = torch.device(device)
    free = (torch.cuda.mem_get_info(device)[0] if device.type == "cuda"
            else None)
    size = window_group_size(caps, cfg, len(shards), free)
    preds = []
    with torch.inference_mode():
        for i in range(0, len(shards), size):
            with tracing.span("window"):
                with tracing.span("window.h2d"):
                    gd = stack_graphs(shards[i:i + size]).to(device)
                with tracing.span("window.forward"):
                    out = mgkn_general_apply_batched(params, cfg, gd)[..., 0]
                    tracing.count("window_forwards")
                with tracing.span("window.readback"):
                    preds.extend(_np(out))
    with tracing.span("assemble"):
        idxs = [np.asarray(g.sample_idx) for g in shards]
        outs = [_decode_rows(u_normalizer, pred, idx)
                for pred, idx in zip(preds, idxs)]
        return sp.assembler(outs, idxs), caps


@dataclasses.dataclass
class MGKNOrthogonalPredictor:
    """Serves an orthogonal-MGKN bundle on raw Burgers initial
    conditions a [n, s] at the training resolution cfg.s (level count
    log2(s) - 1, one conv per level, MGKN_orthogonal_burgers1d.py:21-43)."""

    params: object
    cfg: MGKNOrthogonalConfig
    a_normalizer: object
    u_normalizer: object
    device: DeviceLike = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.params = params_to(self.params, self.device)

    def predict(self, a) -> np.ndarray:
        """a: [n, s] initial conditions at the training resolution.
        Returns decoded solutions [n, s]."""
        from .data.datasets import BurgersArrays, burgers_multipole_data

        with tracing.span("predict"):
            a = np.asarray(a, np.float32)
            n, s = a.shape
            if s != self.cfg.s:
                raise ValueError(
                    f"orthogonal MGKN serves at its training resolution "
                    f"s={self.cfg.s} (the level hierarchy is baked into "
                    f"the weights); got s={s}")
            with tracing.span("predict.encode"):
                enc = _np(self.a_normalizer.encode(a))
            arrays = BurgersArrays(a=enc, u=np.zeros_like(enc),
                                   a_normalizer=self.a_normalizer,
                                   u_normalizer=self.u_normalizer, s=s)
            batch = multipole_batch(*burgers_multipole_data(arrays))
            with torch.inference_mode():
                pred = mgkn_orthogonal_apply_batched(
                    self.params, self.cfg, batch.to(self.device))
                pred = _np(pred[:, :, 0])
            return _np(self.u_normalizer.decode(pred))


def _largest_divisor_leq(n: int, m: int) -> int:
    best = 1
    d = 1
    while d * d <= n:
        if n % d == 0:
            for c in (d, n // d):
                if c <= m:
                    best = max(best, c)
        d += 1
    return best


__all__ = ["GKNPredictor", "MGKNGeneralPredictor", "MGKNOrthogonalPredictor",
           "derive_aux_fields", "mgkn_split_predict", "window_group_size",
           "window_k_bytes"]
