"""One runner for the registered experiments (counterpart of
graph_pde_tpu/experiments/runners.py; GKN on Darcy and Burgers, GCN, the
general MGKN on Darcy and the orthogonal MGKN on Burgers).

data -> graphs -> fit -> evaluation protocol, returning per-epoch
histories and decoded rel-L2 metrics. The protocols are the reference's:
'fixed' (the test set of the training graphs), 'multires' (the same
weights at other resolutions), 'split_random' and 'split_downsample'
(full-field evaluation through split/assemble; on Burgers the 1-d
split_random cover; for the general MGKN the RandomMultiMeshSplitter
windows), and per-m test graphs (``eval_m``). Shard training
(``train_split``) trains on DownsampleGridSplitter shards. GCN trains on
the full-grid lattice, one template graph shared by every sample. The
torus time series trains on one random periodic shard a sample an epoch
with T-step targets and scores the stitched full field per step. The
GKN and MGKN runners write the run figures on request. Runs on CUDA
unless the caller passes ``device='cpu'``.
"""
from __future__ import annotations

import copy
import math
import os
import warnings
from typing import Dict, Optional

import numpy as np
import torch

from ..data import (burgers_gkn_graphs, burgers_multipole_data,
                    darcy_gkn_graphs, darcy_mgkn_graphs,
                    load_or_generate_burgers, load_or_generate_darcy,
                    prepare_burgers, prepare_darcy)
from ..data.datasets import batch_iterator
from ..device import DeviceLike, resolve_device
from ..graph import (DownsampleGridSplitter, NodeBatch, RandomGridSplitter,
                     RandomMultiMeshSplitter, TorusGridSplitter, build_graph,
                     grid_edge, make_box_grid, repad_edges, round_up,
                     stack_graphs)
from ..inference import _largest_divisor_leq as _divisor_near
from ..inference import _np, mgkn_split_predict
from ..models.gcn import GCNConfig, gcn_init
from ..models.gkn import (GKNConfig, gkn_apply, gkn_apply_batched,
                          gkn_init)
from ..models.mgkn_general import MGKNGeneralConfig, mgkn_general_init
from ..models.mgkn_orthogonal import (MGKNOrthogonalConfig,
                                      mgkn_orthogonal_init, multipole_batch)
from ..train import (GCNTask, GKNTask, MGKNGeneralTask, MGKNOrthogonalTask,
                     TrainConfig, evaluate, fit, metrics)
from ..train.optim import adam_steplr
from ..train.trainer import param_leaves, to_device, trainable
from ..utils.filters import gaussian_filter
from ..utils.losses import LpLoss
from ..utils.matio import MatReader
from .registry import ExperimentConfig

def _load_darcy_fields(cfg: ExperimentConfig, n: int, path: Optional[str],
                       seed: int) -> Dict[str, np.ndarray]:
    if path is not None:
        reader = MatReader(path)
        return {k: reader.read_field(k)[:n]
                for k in ("coeff", "Kcoeff", "Kcoeff_x", "Kcoeff_y", "sol")}
    return load_or_generate_darcy(n, cfg.source_res, seed=seed)


def _load_burgers_fields(cfg: ExperimentConfig, n: int,
                         path: Optional[str], seed: int):
    if path is not None:
        reader = MatReader(path)
        return {k: reader.read_field(k)[:n] for k in ("a", "u")}
    return load_or_generate_burgers(n, cfg.source_res, seed=seed)


def _kernel_layers(cfg: ExperimentConfig, ker_in: int):
    w2 = cfg.width ** 2
    if cfg.kernel_variant == "nn":
        return (ker_in, cfg.ker_width, cfg.ker_width, w2)
    if cfg.kernel_variant == "nn5":
        # UAI8_kernel.py:21: a 5-layer kappa
        return (ker_in, cfg.ker_width // 4, cfg.ker_width // 2,
                cfg.ker_width, w2)
    return (ker_in, cfg.ker_width // 2, cfg.ker_width, w2)


def run_experiment(cfg: ExperimentConfig, smoke: bool = False,
                   progress=None, figures_dir: Optional[str] = None,
                   profile_dir: Optional[str] = None,
                   device: DeviceLike = None) -> Dict:
    """Runs ``cfg`` (its ``smoke()`` version with ``smoke``).
    ``progress(epoch, params, train_l2, test_l2)`` runs after each
    epoch; ``figures_dir`` receives truth/approx/error triptychs of the
    worst, median and best test samples (GKN and MGKN runs; the GCN
    runner writes none, as in the JAX package); ``profile_dir`` captures
    a torch.profiler trace of the run (train/metrics.py
    ``profile_trace``)."""
    if smoke:
        cfg = cfg.smoke()
    runners = {"gkn": _run_gkn, "mgkn_general": _run_mgkn_general,
               "mgkn_orthogonal": _run_mgkn_orthogonal}
    no_figures = {"gcn": _run_gcn, "torus_t": _run_torus_timeseries}
    if (cfg.family not in runners and cfg.family not in no_figures) \
            or cfg.dataset not in ("darcy", "burgers"):
        raise ValueError(f"unknown family/dataset {cfg.family!r}/"
                         f"{cfg.dataset!r}")
    dev = resolve_device(device)

    def run():
        if cfg.family in no_figures:
            return no_figures[cfg.family](cfg, progress, dev)
        return runners[cfg.family](cfg, progress, dev, figures_dir)

    if profile_dir:
        with metrics.profile_trace(profile_dir):
            result = run()
        result["profile_dir"] = profile_dir
        return result
    return run()


def _emit_run_figures(figures_dir: str, cfg, task, params, test_data,
                      coords_dim: int, dev: torch.device) -> list:
    """Truth/approx/error figures of the WORST, MEDIAN and BEST test
    samples by decoded rel-L2 (the reference's per-run images,
    UAI1_full_resolution.py:335-461): full-grid samples as imshow
    triptychs, Nystrom subsamples as scatter triptychs, 1-d fields as
    line plots. Returns the paths written (none without matplotlib)."""
    dec_p, dec_y, masks, coords, sample_idx = [], [], [], [], []
    with torch.no_grad():
        for batch in batch_iterator(to_device(test_data, dev), 4,
                                    drop_remainder=False):
            pred = task.forward(params, batch)
            dec_p.append(_np(task.decode(pred[..., 0], batch)))
            dec_y.append(_np(task.decode(task.targets(batch)[..., 0],
                                         batch)))
            masks.append(_np(task.mask(batch)))
            nmax = pred.shape[1]
            coords.append(_np(batch.x)[:, :nmax, :coords_dim])
            si = getattr(batch, "sample_idx", None)
            sample_idx.append(None if si is None else _np(si)[:, :nmax])
    dec_p, dec_y = np.concatenate(dec_p), np.concatenate(dec_y)
    masks, coords = np.concatenate(masks), np.concatenate(coords)
    sample_idx = (None if sample_idx[0] is None
                  else np.concatenate(sample_idx))

    pm, ym = dec_p * masks, dec_y * masks
    rels = (np.linalg.norm(pm - ym, axis=1)
            / np.maximum(np.linalg.norm(ym, axis=1), 1e-12))
    order = np.argsort(rels)
    picks = {"best": order[0], "median": order[len(order) // 2],
             "worst": order[-1]}
    os.makedirs(figures_dir, exist_ok=True)
    written = []
    for tag, j in picks.items():
        valid = masks[j] > 0
        t, a = dec_y[j][valid], dec_p[j][valid]
        path = os.path.join(figures_dir, f"{cfg.name}_{tag}.png")
        title = f"{cfg.name} {tag} rel-L2={rels[j]:.4f}"
        if coords_dim == 1:
            xs = coords[j][valid, 0]
            o = np.argsort(xs)
            out = metrics.save_line_triptych(xs[o], t[o], a[o], path, title)
        else:
            nv = int(valid.sum())
            side = int(round(np.sqrt(nv)))
            full_grid = side * side == nv and (
                sample_idx is None
                or np.array_equal(sample_idx[j][valid][:nv],
                                  np.arange(nv)))
            if full_grid:
                out = metrics.save_field_triptych(t, a, path, title)
            else:
                out = metrics.save_points_triptych(coords[j][valid], t, a,
                                                   path, title)
        if out:
            written.append(out)
    return written


def _gkn_config(cfg: ExperimentConfig) -> GKNConfig:
    # node features [x, y, a, a_smooth, a_gradx, a_grady] on Darcy, [x, a]
    # on Burgers; edge attributes [x_i, x_j, a_i, a_j] in d dimensions.
    # kcached_fused='auto': the fused depth loop (K2, B2-bwd) wherever the
    # segment one-hot would exceed its gate (the full-grid graphs)
    ker_in, in_width = (6, 6) if cfg.dataset == "darcy" else (4, 2)
    return GKNConfig(
        width=cfg.width, ker_width=cfg.ker_width, depth=cfg.depth,
        ker_in=ker_in, in_width=in_width,
        kernel_layers=_kernel_layers(cfg, ker_in),
        relu_last=(cfg.relu_last or cfg.kernel_variant == "nn"),
        decoder_mlp=cfg.decoder_mlp, impl=cfg.impl,
        compute_dtype=cfg.compute_dtype, k_storage=cfg.k_storage,
        kcached_fused="auto")


def _task(cfg: ExperimentConfig, mcfg: GKNConfig, arrays) -> GKNTask:
    # per-node (unit) stats are gathered at each node's grid index
    return GKNTask(mcfg, u_normalizer=arrays.u_normalizer,
                   loss_type=cfg.loss, use_sample_idx=cfg.u_norm == "unit")


def _darcy_data(cfg: ExperimentConfig):
    """Train arrays and fitted normalizers; test arrays with encoded u."""
    fields = _load_darcy_fields(cfg, cfg.ntrain, cfg.data_path,
                                cfg.data_seed)
    arrays, norms = prepare_darcy(fields, n=cfg.ntrain, r=cfg.downsample,
                                  u_norm=cfg.u_norm)
    test_fields = _load_darcy_fields(cfg, cfg.ntest, cfg.test_data_path,
                                     cfg.data_seed + 1)
    test_arrays, _ = prepare_darcy(
        test_fields, n=cfg.ntest, r=cfg.downsample, normalizers=norms,
        u_normalizer=arrays.u_normalizer)
    test_arrays.u = _np(arrays.u_normalizer.encode(test_arrays.u))
    return arrays, norms, test_arrays


def _burgers_data(cfg: ExperimentConfig):
    """Train arrays (normalizers fitted on them) and test arrays, from
    one set of ntrain + ntest fields."""
    fields = _load_burgers_fields(cfg, cfg.ntrain + cfg.ntest,
                                  cfg.data_path, cfg.data_seed)
    arrays = prepare_burgers(fields, n=cfg.ntrain, r=cfg.downsample)
    test_arrays = prepare_burgers(
        {k: v[cfg.ntrain:] for k, v in fields.items()}, n=cfg.ntest,
        r=cfg.downsample, a_normalizer=arrays.a_normalizer,
        u_normalizer=arrays.u_normalizer)
    return arrays, test_arrays


def _run_gkn(cfg: ExperimentConfig, progress, dev: torch.device,
             figures_dir: Optional[str] = None) -> Dict:
    radius_test = cfg.radius_test or cfg.radius_train
    if cfg.dataset == "darcy":
        arrays, norms, test_arrays = _darcy_data(cfg)
        if cfg.train_split:
            # UAI7 shard training (UAI7_evaluate.py:131-141)
            train_g = _darcy_shard_train_graphs(cfg, arrays)
        else:
            train_g = darcy_gkn_graphs(
                arrays, m=cfg.nystrom_m, k=cfg.graphs_per_sample,
                radius=cfg.radius_train, seed=cfg.seed,
                node_block=cfg.node_block)
        test_g = darcy_gkn_graphs(test_arrays, m=cfg.nystrom_m,
                                  radius=radius_test, seed=cfg.seed + 1,
                                  node_block=cfg.node_block)
    else:
        arrays, test_arrays = _burgers_data(cfg)
        norms = {"a": arrays.a_normalizer}
        train_g = burgers_gkn_graphs(arrays, m=cfg.nystrom_m,
                                     k=cfg.graphs_per_sample,
                                     radius=cfg.radius_train, seed=cfg.seed)
        test_g = burgers_gkn_graphs(test_arrays, m=cfg.nystrom_m,
                                    radius=radius_test, seed=cfg.seed + 1)

    mcfg = _gkn_config(cfg)
    params = gkn_init(torch.Generator().manual_seed(cfg.seed), mcfg,
                      device=dev)
    task = _task(cfg, mcfg, arrays)
    tc = TrainConfig(epochs=cfg.epochs, batch_size=cfg.batch_size,
                     learning_rate=cfg.learning_rate,
                     weight_decay=cfg.weight_decay,
                     scheduler_step=cfg.scheduler_step,
                     scheduler_gamma=cfg.scheduler_gamma, loss=cfg.loss,
                     seed=cfg.seed)
    res = fit(task, params, train_g, tc, test_data=test_g,
              callback=progress, device=dev)
    result = {
        "config": cfg.name,
        "train_l2": res.train_l2,
        "test_l2": res.test_l2,
        "test_epochs": res.test_epochs,
        "epoch_times": res.epoch_times,
        "final_test_l2": res.test_l2[-1] if res.test_l2 else None,
    }
    darcy = cfg.dataset == "darcy"
    if figures_dir:
        result["figures"] = _emit_run_figures(
            figures_dir, cfg, task, res.params, test_g,
            2 if darcy else 1, dev)
    if cfg.eval_protocol == "multires" and darcy:
        result["multires"], result["multires_fresh_fields"] = \
            _eval_gkn_multires(cfg, mcfg, res.params, arrays, norms,
                               radius_test, dev)
    elif cfg.eval_protocol == "split_random" and darcy:
        result.update(_eval_gkn_split_random(cfg, mcfg, res.params, arrays,
                                             norms, dev))
    elif cfg.eval_protocol == "split_random":
        result["full_field_l2"] = _eval_gkn_split_random_burgers(
            cfg, mcfg, res.params, arrays, dev)
    elif cfg.eval_protocol == "split_downsample":
        result.update(_eval_gkn_split_downsample(cfg, mcfg, res.params,
                                                 arrays, norms, dev))
    if cfg.eval_m and darcy:
        result["eval_by_m"] = _eval_gkn_by_m(cfg, task, res.params,
                                             test_arrays, radius_test, dev)
    result["params"] = res.params
    # serving-bundle payload (cli run --bundle, train/export.py)
    result["_bundle"] = {
        "model_cfg": mcfg,
        "normalizers": dict(norms, u=arrays.u_normalizer),
        "extra": {"family": "gkn", "dataset": cfg.dataset,
                  "radius": radius_test, "experiment": cfg.name},
    }
    return result


def _eval_gkn_split_random_burgers(cfg, mcfg, params, arrays, dev) -> float:
    """1-d full-grid evaluation through RandomGridSplitter
    (neurips5_GKN.py:138-147): disjoint m-node subgraphs cover all s
    points, each decoded with its own points' stats, stitched; the mean
    rel-L2 over at most 10 test samples."""
    s = arrays.s
    n_eval = min(cfg.ntest, 10)
    fields = _load_burgers_fields(cfg, cfg.ntrain + cfg.ntest,
                                  cfg.data_path, cfg.data_seed)
    test = prepare_burgers(
        {k: v[cfg.ntrain:] for k, v in fields.items()}, n=n_eval,
        r=cfg.downsample, a_normalizer=arrays.a_normalizer,
        u_normalizer=arrays.u_normalizer, encode_u=False)
    m = _divisor_near(s, cfg.nystrom_m or 128)
    sp = RandomGridSplitter(make_box_grid([[0, 1]], [s]), s, d=1, m=m, l=1,
                            radius=cfg.radius_train, seed=cfg.seed)
    lp = LpLoss(size_average=False)
    total = 0.0
    for j in range(n_eval):
        graphs = sp.get_data(test.a[j][:, None])
        preds = _predict_shards(mcfg, params, graphs, dev)
        idxs = [np.asarray(g.sample_idx)[: int(g.n_node)] for g in graphs]
        dec = [_np(arrays.u_normalizer.decode(p[None, :],
                                              sample_idx=idx[None]))[0]
               for p, idx in zip(preds, idxs)]
        full = sp.assemble(dec, idxs)
        total += float(lp.rel(full[None], test.u[j][None]))
    return total / n_eval


def gcn_data(cfg: ExperimentConfig):
    """The GCN run's data: (template, train NodeBatch, test NodeBatch,
    u-normalizer over the padded nodes). GCNConv ignores edge
    attributes, so the s x s lattice is built once, unweighted, as the
    template Graph (host arrays) every sample shares; the s=421 lattice
    takes the blocked layout (node_block 512 from 60,000 nodes, the JAX
    package's rule, so N_pad and the padding agree with it). The
    normalizer's per-node stats are extended over the padding with mean
    0 and std 1 (the node mask keeps those nodes out of the loss)."""
    arrays, _, test_arrays = _darcy_data(cfg)
    s = arrays.s
    n = s * s
    grid, ei, _ = grid_edge(s, s)
    node_block = 512 if n >= 60000 else 0
    tpl = build_graph(np.zeros((n, 6), np.float32), ei[0], ei[1],
                      np.zeros((ei.shape[1], 1), np.float32),
                      node_block=node_block)
    n_pad = tpl.num_nodes_padded

    def stack(arr, count):
        xs = np.zeros((count, n_pad, 6), np.float32)
        ys = np.zeros((count, n_pad, 1), np.float32)
        for j in range(count):
            xs[j, :n] = np.concatenate([
                grid, arr.a[j][:, None], arr.a_smooth[j][:, None],
                arr.a_gradx[j][:, None], arr.a_grady[j][:, None]], axis=1)
            ys[j, :n, 0] = arr.u[j]
        return NodeBatch(x=xs, y=ys, n_node=np.full((count,), n, np.int32))

    u_norm = copy.copy(arrays.u_normalizer)
    pad = n_pad - n
    if pad:
        u_norm.mean = torch.cat([u_norm.mean, torch.zeros(pad)])
        u_norm.std = torch.cat([u_norm.std, torch.ones(pad)])
    return tpl, stack(arrays, cfg.ntrain), stack(test_arrays, cfg.ntest), \
        u_norm


def _run_gcn(cfg: ExperimentConfig, progress, dev: torch.device) -> Dict:
    """The neurips4_GCN.py protocol: GCN on the full-grid 4-neighbor
    lattice, trained on the decoded rel-L2 (lines 178-198), evaluated on
    the held-out test set (lines 205-216). No serving bundle, as in the
    JAX package."""
    tpl, train_b, test_b, u_norm = gcn_data(cfg)
    mcfg = GCNConfig(width=cfg.width, ker_width=cfg.ker_width,
                     depth=cfg.depth, in_width=6)
    params = gcn_init(torch.Generator().manual_seed(cfg.seed), mcfg,
                      device=dev)
    # fit moves the data to the device; the template goes with the task
    task = GCNTask(mcfg, u_normalizer=u_norm, loss_type=cfg.loss,
                   use_sample_idx=False, template=tpl.to(dev))
    tc = TrainConfig(epochs=cfg.epochs, batch_size=cfg.batch_size,
                     learning_rate=cfg.learning_rate,
                     weight_decay=cfg.weight_decay,
                     scheduler_step=cfg.scheduler_step,
                     scheduler_gamma=cfg.scheduler_gamma, loss=cfg.loss,
                     seed=cfg.seed)
    res = fit(task, params, train_b, tc, test_data=test_b,
              callback=progress, device=dev)
    return {"config": cfg.name, "train_l2": res.train_l2,
            "test_l2": res.test_l2, "test_epochs": res.test_epochs,
            "final_test_l2": res.test_l2[-1] if res.test_l2 else None,
            "epoch_times": res.epoch_times, "params": res.params,
            "extra": {"family": "gcn", "s": math.isqrt(int(tpl.n_node)),
                      "node_block": tpl.node_block}}


def _run_mgkn_orthogonal(cfg: ExperimentConfig, progress,
                         dev: torch.device,
                         figures_dir: Optional[str] = None) -> Dict:
    """The orthogonal MGKN on Burgers (MGKN_orthogonal_burgers1d.py): the
    level hierarchy of the training grid, trained on the decoded rel-L2;
    the bundle carries the training s."""
    arrays, test_arrays = _burgers_data(cfg)
    train_g = multipole_batch(*burgers_multipole_data(arrays))
    test_g = multipole_batch(*burgers_multipole_data(test_arrays))
    mcfg = MGKNOrthogonalConfig(width=cfg.width, ker_width=cfg.ker_width,
                                depth=cfg.depth, ker_in=4, in_width=2,
                                s=arrays.s, impl=cfg.impl,
                                compute_dtype=cfg.compute_dtype,
                                k_storage=cfg.k_storage)
    params = mgkn_orthogonal_init(torch.Generator().manual_seed(cfg.seed),
                                  mcfg, device=dev)
    task = MGKNOrthogonalTask(mcfg, u_normalizer=arrays.u_normalizer,
                              loss_type=cfg.loss)
    tc = TrainConfig(epochs=cfg.epochs, batch_size=cfg.batch_size,
                     learning_rate=cfg.learning_rate,
                     weight_decay=cfg.weight_decay,
                     scheduler_step=cfg.scheduler_step,
                     scheduler_gamma=cfg.scheduler_gamma, loss=cfg.loss,
                     seed=cfg.seed)
    res = fit(task, params, train_g, tc, test_data=test_g,
              callback=progress, device=dev)
    figures = (_emit_run_figures(figures_dir, cfg, task, res.params, test_g,
                                 1, dev)
               if figures_dir else None)
    return {"config": cfg.name, "train_l2": res.train_l2,
            "test_l2": res.test_l2, "test_epochs": res.test_epochs,
            "epoch_times": res.epoch_times,
            "final_test_l2": res.test_l2[-1] if res.test_l2 else None,
            "figures": figures,
            "params": res.params,
            "_bundle": {"model_cfg": mcfg,
                        "normalizers": {"a": arrays.a_normalizer,
                                        "u": arrays.u_normalizer},
                        "extra": {"family": "mgkn_orthogonal",
                                  "experiment": cfg.name,
                                  "dataset": cfg.dataset,
                                  "train_s": int(arrays.s)}}}


def _run_mgkn_general(cfg: ExperimentConfig, progress,
                      dev: torch.device,
                      figures_dir: Optional[str] = None) -> Dict:
    """The general MGKN on Darcy (MGKN_general_darcy2d.py and the
    neurips{1,2,3}_MGKN scripts): multilevel graphs of the training and
    test samples (the test capacities at least the training ones),
    trained on the decoded rel-L2; then the configured full-field
    protocol."""
    arrays, norms, test_arrays = _darcy_data(cfg)
    graph_kw = dict(points=cfg.points, radius_inner=cfg.radius_inner,
                    radius_inter=cfg.radius_inter)
    train_g, caps = darcy_mgkn_graphs(arrays, k=cfg.graphs_per_sample,
                                      seed=cfg.seed, **graph_kw)
    test_g, _ = darcy_mgkn_graphs(test_arrays, seed=cfg.seed + 1,
                                  caps=caps, **graph_kw)
    mcfg = MGKNGeneralConfig(
        width=cfg.width, ker_width=cfg.ker_width, depth=cfg.depth,
        ker_in=6, in_width=6, points=tuple(cfg.points),
        variant=cfg.mgkn_variant, impl=cfg.impl,
        compute_dtype=cfg.compute_dtype, k_storage=cfg.k_storage)
    params = mgkn_general_init(torch.Generator().manual_seed(cfg.seed), mcfg,
                               device=dev)
    task = MGKNGeneralTask(mcfg, u_normalizer=arrays.u_normalizer,
                           loss_type=cfg.loss)
    tc = TrainConfig(epochs=cfg.epochs, batch_size=cfg.batch_size,
                     learning_rate=cfg.learning_rate,
                     weight_decay=cfg.weight_decay,
                     scheduler_step=cfg.scheduler_step,
                     scheduler_gamma=cfg.scheduler_gamma, loss=cfg.loss,
                     seed=cfg.seed)
    res = fit(task, params, train_g, tc, test_data=test_g,
              callback=progress, device=dev)
    result = {"config": cfg.name, "train_l2": res.train_l2,
              "test_l2": res.test_l2, "test_epochs": res.test_epochs,
              "epoch_times": res.epoch_times,
              "final_test_l2": res.test_l2[-1] if res.test_l2 else None,
              "params": res.params,
              "_bundle": {"model_cfg": mcfg,
                          "normalizers": dict(norms, u=arrays.u_normalizer),
                          "extra": {"family": "mgkn_general",
                                    "experiment": cfg.name,
                                    "dataset": cfg.dataset,
                                    "radius_inner": list(cfg.radius_inner),
                                    "radius_inter": list(cfg.radius_inter),
                                    "train_s": int(arrays.s)}}}
    if cfg.eval_protocol == "split_random":
        result["full_field_l2"] = _eval_mgkn_split(cfg, mcfg, res.params,
                                                   arrays, norms, dev)
    elif cfg.eval_protocol == "multires":
        result["multires"], result["multires_fresh_fields"] = \
            _eval_mgkn_multires(cfg, task, res.params, arrays, norms, dev)
    if figures_dir:
        result["figures"] = _emit_run_figures(
            figures_dir, cfg, task, res.params, test_g, 2, dev)
    return result


def _eval_mgkn_multires(cfg, task, params, arrays, norms, dev):
    """Zero-shot resolution generalization (neurips3_MGKN.py:357-387):
    the same weights on multilevel graphs sampled from other grids (the
    level node counts stay; the pool they are drawn from changes).
    Returns ({s: rel-L2}, [resolutions evaluated on freshly generated
    fields])."""
    out, fresh = {}, []
    for s_eval in cfg.eval_resolutions:
        fields, r = _multires_fields(cfg, s_eval, fresh)
        test_arrays, _ = prepare_darcy(
            fields, n=cfg.ntest, r=r, normalizers=norms,
            u_normalizer=arrays.u_normalizer)
        test_arrays.u = _np(arrays.u_normalizer.encode(test_arrays.u))
        g, _ = darcy_mgkn_graphs(
            test_arrays, points=cfg.points, radius_inner=cfg.radius_inner,
            radius_inter=cfg.radius_inter, seed=cfg.seed + 3)
        out[int(test_arrays.s)] = evaluate(task, params, g,
                                           batch_size=cfg.batch_size,
                                           device=dev)
    return out, fresh


def _eval_mgkn_split(cfg, mcfg, params, arrays, norms, dev) -> float:
    """Full-field rel-L2 through RandomMultiMeshSplitter windows
    (MGKN_general_darcy2d.py:306-332), over at most 5 test samples: each
    window decoded with its own points' stats, then assembled."""
    s = arrays.s
    n_eval = min(cfg.ntest, 5)
    fields = _load_darcy_fields(cfg, n_eval, cfg.test_data_path,
                                cfg.data_seed + 2)
    test_arrays, _ = prepare_darcy(fields, n=n_eval, r=cfg.downsample,
                                   normalizers=norms,
                                   u_normalizer=arrays.u_normalizer)
    sp = RandomMultiMeshSplitter([[0, 1], [0, 1]], [s, s],
                                 level=len(cfg.points),
                                 sample_sizes=list(cfg.points),
                                 seed=cfg.seed)
    lp = LpLoss(size_average=False)
    total = 0.0
    split_caps = None
    for j in range(n_eval):
        full, split_caps = mgkn_split_predict(
            params, mcfg, sp, cfg.radius_inner, cfg.radius_inter,
            _theta(test_arrays, j), split_caps, arrays.u_normalizer, dev)
        total += float(lp.rel(full[None], test_arrays.u[j][None]))
    return total / n_eval


def _eval_gkn_by_m(cfg, task, params, test_arrays, radius_test, dev):
    """Test-side node-count generalization (UAI5_sample_generalize.py):
    the same weights on test graphs subsampled at each m of eval_m."""
    return {int(m): evaluate(
        task, params, darcy_gkn_graphs(test_arrays, m=m, radius=radius_test,
                                       seed=cfg.seed + 5),
        batch_size=cfg.batch_size, device=dev) for m in cfg.eval_m}


def _eval_gkn_multires(cfg, mcfg, params, arrays, norms, radius_test,
                       dev):
    """Zero-shot resolution generalization (UAI3_resolution.py:240-265):
    the same weights on graphs built at other resolutions. Returns
    ({s: rel-L2}, [resolutions evaluated on freshly generated fields])."""
    out, fresh = {}, []
    task = _task(cfg, mcfg, arrays)
    for s_eval in cfg.eval_resolutions:
        fields, r = _multires_fields(cfg, s_eval, fresh)
        test_arrays, _ = prepare_darcy(
            fields, n=cfg.ntest, r=r, normalizers=norms,
            u_normalizer=arrays.u_normalizer)
        test_arrays.u = _np(arrays.u_normalizer.encode(test_arrays.u))
        g = darcy_gkn_graphs(test_arrays, m=cfg.nystrom_m,
                             radius=radius_test, seed=cfg.seed + 3)
        out[int(test_arrays.s)] = evaluate(task, params, g,
                                           batch_size=cfg.batch_size,
                                           device=dev)
    return out, fresh


def _multires_fields(cfg, s_eval: int, fresh: list):
    """(test fields, stride) of a multires evaluation at ``s_eval``: the
    same test fields stride-downsampled where the source grid derives
    s_eval (the reference evaluates identical samples at every
    resolution), else freshly generated fields at s_eval, noted in
    ``fresh``."""
    if cfg.source_res >= s_eval and (cfg.source_res - 1) % (s_eval - 1) == 0:
        fields = _load_darcy_fields(cfg, cfg.ntest, cfg.test_data_path,
                                    cfg.data_seed + 2)
        return fields, (cfg.source_res - 1) // (s_eval - 1)
    warnings.warn(
        f"multires eval at s={s_eval}: source grid {cfg.source_res} cannot "
        "derive it; using freshly generated fields (flagged in "
        "multires_fresh_fields)")
    fresh.append(int(s_eval))
    return load_or_generate_darcy(cfg.ntest, s_eval,
                                  seed=cfg.data_seed + 2), 1


def _predict_shards(mcfg, params, graphs, dev) -> list:
    """Each shard's [n_node] predictions, one shard at a time."""
    preds = []
    with torch.inference_mode():
        for g in graphs:
            out = gkn_apply(params, mcfg, g.to(dev))[:, 0]
            preds.append(_np(out)[: int(g.n_node)])
    return preds


def _darcy_shard_train_graphs(cfg, arrays):
    """A fixed set of ntrain * k DownsampleGridSplitter training shards
    with labels (UAI7_evaluate.py:131-141), stacked at one capacity."""
    s = arrays.s
    grid = make_box_grid([[0, 1], [0, 1]], [s, s])
    # m >= the largest shard's subgrid (the x=0, y=0 one) fills every
    # shard to exactly m nodes: one node capacity
    sub = (s - 1) // cfg.train_split + 1 if s % 2 == 1 \
        else s // cfg.train_split
    m = max(cfg.nystrom_m or sub * sub, sub * sub)
    sp = DownsampleGridSplitter(grid, s, r=cfg.train_split, m=m,
                                radius=cfg.radius_train, seed=cfg.seed)
    graphs = []
    for j in range(cfg.ntrain):
        theta = _theta(arrays, j)
        for _ in range(cfg.graphs_per_sample):
            graphs.append(sp.sample(theta, arrays.u[j])[0])
    cap = max(int(g.senders.shape[0]) for g in graphs)
    return stack_graphs([repad_edges(g, cap) for g in graphs])


def _theta(arrays, j: int) -> np.ndarray:
    return np.stack([arrays.a[j], arrays.a_smooth[j], arrays.a_gradx[j],
                     arrays.a_grady[j]], axis=1)


def _split_test_arrays(cfg, arrays, norms):
    n = min(cfg.ntest, 10)
    fields = _load_darcy_fields(cfg, n, cfg.test_data_path,
                                cfg.data_seed + 2)
    test_arrays, _ = prepare_darcy(fields, n=n, r=cfg.downsample,
                                   normalizers=norms,
                                   u_normalizer=arrays.u_normalizer)
    return test_arrays


def _shard_l2(cfg, arrays, lp, p, idx, truth) -> float:
    """One shard's rel-L2, decoded with the shard's own per-point
    stats."""
    norm = arrays.u_normalizer
    d = (norm.decode(p[None, :], sample_idx=idx[None])
         if cfg.u_norm == "unit" else norm.decode(p[None, :]))
    return float(lp.rel(_np(d), truth[idx][None]))


def _full_l2(arrays, lp, full_enc, truth) -> float:
    """Decodes an assembled encoded field with the full-grid stats (the
    reference's order: assemble, then decode) and returns its rel-L2."""
    full = _np(arrays.u_normalizer.decode(full_enc[None, :]))
    return float(lp.rel(full, truth[None]))


def _eval_gkn_split_random(cfg, mcfg, params, arrays, norms, dev):
    """Full-field rel-L2 through RandomGridSplitter covers
    (UAI7_evaluate2.py:150-161, 222-231), and the mean shard rel-L2."""
    s = arrays.s
    test_arrays = _split_test_arrays(cfg, arrays, norms)
    grid = make_box_grid([[0, 1], [0, 1]], [s, s])
    m = _divisor_near(s * s, cfg.nystrom_m or 200)
    sp = RandomGridSplitter(grid, s, d=2, m=m, l=cfg.split_l,
                            radius=cfg.radius_train, seed=cfg.seed)
    lp = LpLoss(size_average=False)
    total, shards = 0.0, []
    for j in range(test_arrays.a.shape[0]):
        graphs = sp.get_data(_theta(test_arrays, j))
        preds = _predict_shards(mcfg, params, graphs, dev)
        idxs = [np.asarray(g.sample_idx)[: int(g.n_node)] for g in graphs]
        shards += [_shard_l2(cfg, arrays, lp, p, idx, test_arrays.u[j])
                   for p, idx in zip(preds, idxs)]
        total += _full_l2(arrays, lp, sp.assemble(preds, idxs),
                          test_arrays.u[j])
    count = test_arrays.a.shape[0]
    return {"full_field_l2": total / max(count, 1),
            "shard_l2": sum(shards) / max(len(shards), 1)}


def _eval_gkn_split_downsample(cfg, mcfg, params, arrays, norms, dev):
    """Full-field rel-L2 through DownsampleGridSplitter shards and
    sigma=1 smoothing (UAI7_evaluate.py:218-229), and the mean shard
    rel-L2."""
    s = arrays.s
    test_arrays = _split_test_arrays(cfg, arrays, norms)
    grid = make_box_grid([[0, 1], [0, 1]], [s, s])
    # the test stride is the training stride (UAI7_evaluate.py:174-176),
    # else the sqrt heuristic
    r = cfg.train_split or max(2, int(round(s / np.sqrt(cfg.nystrom_m
                                                        or 200))))
    sub = (s - 1) // r + 1 if s % 2 == 1 else s // r
    m = max(cfg.nystrom_m or sub * sub, sub * sub)
    sp = DownsampleGridSplitter(grid, s, r=r, m=m, radius=cfg.radius_train,
                                seed=cfg.seed)
    lp = LpLoss(size_average=False)
    total, shards = 0.0, []
    for j in range(test_arrays.a.shape[0]):
        graphs, xys = zip(*sp.get_data(_theta(test_arrays, j)))
        preds = _predict_shards(mcfg, params, graphs, dev)
        shards += [_shard_l2(cfg, arrays, lp, p,
                             np.asarray(g.sample_idx)[: len(p)],
                             test_arrays.u[j])
                   for p, g in zip(preds, graphs)]
        total += _full_l2(arrays, lp, sp.assemble(preds, xys, sigma=1.0),
                          test_arrays.u[j])
    count = test_arrays.a.shape[0]
    return {"full_field_l2": total / max(count, 1),
            "shard_l2": sum(shards) / max(len(shards), 1)}


def torus_samples(cfg: ExperimentConfig, rng: np.random.Generator, n: int):
    """n synthetic grain fields on the s x s torus: theta a wrap-smoothed
    Gaussian field at unit std [s*s, 1], targets y_t = sin((t+1) theta)
    [T, s*s]."""
    res, T = cfg.source_res, cfg.torus_T
    out = []
    for _ in range(n):
        raw = rng.normal(size=(res, res)).astype(np.float32)
        theta = gaussian_filter(raw, sigma=2.0, mode="wrap")
        theta = theta / max(float(theta.std()), 1e-6)
        y = np.stack([np.sin((t + 1) * theta) for t in range(T)])
        out.append((theta.reshape(-1, 1), y.reshape(T, -1)))
    return out


def torus_splitter(cfg: ExperimentConfig) -> TorusGridSplitter:
    """The runner's splitter: the s x s torus grid in r x r strided
    shards of (s / r)^2 nodes, drawing its shards from ``cfg.seed``."""
    res = cfg.source_res
    grid = make_box_grid([[0, 1], [0, 1]], [res, res]) * (res - 1) / res
    r = max(cfg.downsample, 1)
    return TorusGridSplitter(grid, res, r=r, m=(-(-res // r)) ** 2,
                             radius=cfg.radius_train, T=cfg.torus_T,
                             seed=cfg.seed)


def torus_model_config(cfg: ExperimentConfig) -> GKNConfig:
    """The torus GKN: node features [x, y, theta], edge attributes [dx,
    dy, dist, theta_i, theta_j], T outputs, no ReLU after the last
    step."""
    return GKNConfig(width=cfg.width, ker_width=cfg.ker_width,
                     depth=cfg.depth, ker_in=5, in_width=3,
                     out_width=cfg.torus_T,
                     kernel_layers=_kernel_layers(cfg, 5), relu_last=False,
                     impl=cfg.impl, compute_dtype=cfg.compute_dtype,
                     k_storage=cfg.k_storage)


def torus_loss(params, mcfg: GKNConfig, batch) -> torch.Tensor:
    """The masked MSE over the T steps of a stacked batch:
    sum(d^2) / max(sum(mask) * T, 1)."""
    out = gkn_apply_batched(params, mcfg, batch)
    mask = batch.node_mask().to(out.dtype)
    d = (out - batch.y) * mask[..., None]
    return torch.sum(d ** 2) / torch.clamp(
        torch.sum(mask) * mcfg.out_width, min=1.0)


def _torus_step(params, mcfg: GKNConfig, opt, batch) -> torch.Tensor:
    """One Adam step on the torus loss; returns the loss (detached)."""
    opt.zero_grad(set_to_none=True)
    loss = torus_loss(params, mcfg, batch)
    loss.backward()
    opt.step()
    return loss.detach()


def _run_torus_timeseries(cfg: ExperimentConfig, progress,
                          dev: torch.device) -> Dict:
    """T-step training on the periodic domain, the grain-microstructure
    workflow behind the reference's TorusGridSplitter checkpoints. Each
    epoch, each training sample gives one random periodic shard with
    T-step targets (``sampleT``); the shards keep one monotone edge
    capacity, and the epoch's steps run in a shuffled order. Evaluation
    stitches every deterministic shard of a test sample with
    ``assembleT`` (wrap-mode smoothing) and scores rel-L2 per step. The
    random streams are the JAX runner's: data (train, then test), the
    splitter's shard draws, one shuffle permutation an epoch."""
    T = cfg.torus_T
    rng = np.random.default_rng(cfg.data_seed)
    train = torus_samples(cfg, rng, cfg.ntrain)
    test = torus_samples(cfg, rng, cfg.ntest)
    sp = torus_splitter(cfg)
    mcfg = torus_model_config(cfg)
    params = trainable(gkn_init(torch.Generator().manual_seed(cfg.seed),
                                mcfg, device=dev), dev)
    opt, sched = adam_steplr(param_leaves(params), cfg.learning_rate,
                             weight_decay=cfg.weight_decay,
                             step_size_epochs=cfg.scheduler_step,
                             gamma=cfg.scheduler_gamma)

    train_hist = []
    shuffle = np.random.default_rng(cfg.seed + 1)
    n_steps = max(cfg.ntrain // cfg.batch_size, 1)
    e_pad = 0   # monotone edge capacity, as in the JAX runner
    for ep in range(cfg.epochs):
        shards = [sp.sampleT(theta, y)[0] for theta, y in train]
        e_pad = max(e_pad, round_up(
            max(g.senders.shape[0] for g in shards), 512))
        shards = [repad_edges(g, e_pad) for g in shards]
        order = shuffle.permutation(cfg.ntrain)
        losses = []
        for i in range(n_steps):
            sel = order[i * cfg.batch_size: (i + 1) * cfg.batch_size]
            batch = stack_graphs([shards[j] for j in sel]).to(dev)
            losses.append(_torus_step(params, mcfg, opt, batch))
        sched.step()
        train_hist.append(float(torch.stack(losses).mean()))
        if progress is not None:
            progress(ep, params, train_hist[-1], None)

    lp = LpLoss(size_average=False)
    totals = np.zeros(T)
    with torch.inference_mode():
        for theta, y in test:
            preds, xys = [], []
            for g, xy in sp.get_data(theta):
                out = gkn_apply(params, mcfg, g.to(dev))
                preds.append(_np(out)[: int(g.n_node)])
                xys.append(xy)
            full = sp.assembleT(preds, xys, sigma=cfg.assemble_sigma)
            for t in range(T):
                totals[t] += float(lp.rel(full[t][None], y[t][None]))
    per_step = (totals / max(cfg.ntest, 1)).tolist()
    return {"config": cfg.name, "train_l2": train_hist,
            "test_l2_per_step": per_step,
            "final_test_l2": float(np.mean(per_step)), "params": params}


__all__ = ["run_experiment"]
