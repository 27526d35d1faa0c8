"""Experiment registry (a copy of graph_pde_tpu/experiments/registry.py;
the port imports nothing of the JAX package, and a test holds the two
equal field by field).

Each of the reference's scripts is an ``ExperimentConfig``, run by
``experiments.runners.run_experiment``; ``smoke()`` shrinks any
experiment to a seconds-scale version of itself. The runner defaults to
synthetic data at ``source_res`` and reads .mat files where
``data_path`` is given. The comments cite the reference file each config
reproduces. The port runs every entry.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    name: str
    family: str                 # 'gkn' | 'mgkn_general' | 'mgkn_orthogonal' | 'gcn'
    dataset: str = "darcy"      # 'darcy' | 'burgers'
    # data
    source_res: int = 241        # generation/source grid (downsampled by r)
    downsample: int = 4
    ntrain: int = 100
    ntest: int = 40
    data_seed: int = 0
    data_path: Optional[str] = None        # train .mat (optional)
    test_data_path: Optional[str] = None   # test .mat (optional)
    u_norm: str = "unit"         # 'unit' | 'gaussian'
    # graph build
    nystrom_m: Optional[int] = None   # None -> full grid
    graphs_per_sample: int = 1
    radius_train: float = 0.25
    radius_test: Optional[float] = None
    points: Tuple[int, ...] = ()      # multilevel node counts
    radius_inner: Tuple[float, ...] = ()
    radius_inter: Tuple[float, ...] = ()
    lattice: bool = False             # GCN lattice graph
    train_split: int = 0              # >0: train on DownsampleGridSplitter
    #                                   shards of stride r=train_split
    #                                   instead of Nystrom subsets
    #                                   (UAI7_evaluate.py:131-141)
    split_l: int = 1                  # RandomGridSplitter covers (UAI7
    #                                   _evaluate2.py:152 uses l=2)
    # model
    width: int = 64
    ker_width: int = 256
    depth: int = 4
    kernel_variant: str = "nn3"       # 'nn' | 'nn3' | 'nn5'
    impl: str = "kcached"             # conv impl: kcached | auto | pallas |
    #                                   scan | reference (kcached = kernel
    #                                   matrices computed once per forward;
    #                                   use 'auto' when E*width^2 is too
    #                                   large for HBM, e.g. full 241 grids)
    relu_last: bool = False
    decoder_mlp: bool = False
    mgkn_variant: str = "mkgn"
    compute_dtype: Optional[str] = None  # 'bfloat16': bf16 kappa MLP +
    #                                   bf16 cached K (halves the HBM-
    #                                   bound per-iteration K stream)
    k_storage: Optional[str] = None   # 'float8_e4m3'/'float8_e5m2':
    #                                   fp8 storage of the cached K
    #                                   (kcached GKN; halves the K
    #                                   stream again, RESULTS.md)
    # the JAX trainer's epochs per compiled dispatch; the port's trainer
    # takes one step at a time and evaluates every epoch, so it has no
    # use for it (kept so that configs carry over)
    epochs_per_jit: int = 1
    torus_T: int = 3                  # T-step targets (torus_t family)
    assemble_sigma: float = 1.0       # assembleT smoothing (reference
    #                                   default, mp/utilities.py:1403)
    node_block: int = 0               # >0: blocked-CSR edge layout —
    #                                   block-local one-hot aggregation,
    #                                   bounded at any N (full grids)

    def __post_init__(self):
        if self.compute_dtype not in (None, "bfloat16", "float32"):
            raise ValueError(
                f"compute_dtype must be None, 'bfloat16' or 'float32', "
                f"got {self.compute_dtype!r}")
        if self.assemble_sigma <= 0:
            raise ValueError(
                f"assemble_sigma must be > 0 (use a tiny value like 1e-6 "
                f"to effectively disable smoothing), got "
                f"{self.assemble_sigma}")
    # training
    epochs: int = 100
    batch_size: int = 2
    learning_rate: float = 1e-4
    weight_decay: float = 5e-4
    scheduler_step: int = 50
    scheduler_gamma: float = 0.5
    loss: str = "l1"
    seed: int = 0
    # evaluation
    eval_protocol: str = "fixed"      # 'fixed' | 'multires' |
    #                                  'split_random' | 'split_downsample'
    eval_resolutions: Tuple[int, ...] = ()
    eval_m: Tuple[int, ...] = ()      # test-side node counts (UAI5)

    def smoke(self) -> "ExperimentConfig":
        """Seconds-scale version for CI: tiny data, few epochs."""
        small = {
            "source_res": min(self.source_res, 33),
            "downsample": 1,
            "ntrain": 8,
            "ntest": 4,
            "epochs": 2,
            "width": 16,
            "ker_width": 32,
            "depth": min(self.depth, 2),
            "batch_size": 2,
        }
        if self.nystrom_m:
            small["nystrom_m"] = min(self.nystrom_m, 48)
        if self.train_split:
            # keep the shard count (train_split^2 on the eval side)
            # seconds-scale
            small["train_split"] = min(self.train_split, 4)
        if self.points:
            small["points"] = tuple(
                max(p // 8, 6) for p in self.points)
        if self.eval_resolutions:
            small["eval_resolutions"] = (17, 33)
        if self.family == "torus_t":
            small["source_res"] = 16
            small["downsample"] = 2
        if self.dataset == "burgers":
            small["source_res"] = 64
            small["nystrom_m"] = min(self.nystrom_m or 48, 32)
        return dataclasses.replace(self, **small)


_R = {}


def register(cfg: ExperimentConfig) -> ExperimentConfig:
    _R[cfg.name] = cfg
    return cfg


def get(name: str) -> ExperimentConfig:
    return _R[name]


def names():
    return sorted(_R)


# ------------------------------------------------------------------ GKN

# UAI1_full_resolution.py: full s=61 grid, radius 0.1, KernelNN (relu all),
# ker_width 1024, depth 6, L1 backward, eval at 16/31/61.
register(ExperimentConfig(
    name="uai1_full_resolution", family="gkn", downsample=4,
    ntrain=100, ntest=40, radius_train=0.1, width=64, ker_width=1024,
    depth=6, kernel_variant="nn", relu_last=True, epochs=200, batch_size=1,
    learning_rate=1e-4, scheduler_step=50, scheduler_gamma=0.8, loss="l1",
    u_norm="gaussian", eval_protocol="multires",
    eval_resolutions=(16, 31, 61)))

# UAI2_full_equation.py: s=31 full grid, 10 train, 5000 epochs, batch 2.
register(ExperimentConfig(
    name="uai2_full_equation", family="gkn", downsample=8, ntrain=10,
    ntest=40, radius_train=0.1, width=64, ker_width=1024, depth=6,
    kernel_variant="nn", relu_last=True, epochs=5000, batch_size=2,
    loss="l1", u_norm="gaussian"))

# UAI3_resolution.py: Nystrom m=200, k=2 graphs/sample, radius 0.25, MSE;
# zero-shot eval at 61/121/241 (the discretization-invariance oracle).
# ReLU after EVERY conv iteration incl. the last (UAI3_resolution.py:29).
register(ExperimentConfig(
    name="uai3_resolution", family="gkn", downsample=4, ntrain=100,
    ntest=40, nystrom_m=200, graphs_per_sample=2, radius_train=0.25,
    width=64, ker_width=256, depth=4, kernel_variant="nn3", relu_last=True,
    loss="mse", u_norm="gaussian", epochs=200, batch_size=2,
    eval_protocol="multires", eval_resolutions=(61, 121, 241)))

# Full-grid s=241 single-graph training: the regime the reference cannot
# reach (its splitters exist to avoid it — UAI4_equation_sample.py trains
# m=200 subsamples of the 241 grid; sklearn pairwise alone would need
# >20 min per graph there). N=58,081 nodes, E~1.2M edges at r=0.01:
# kcached is memory-gated out (bf16 K alone is 9.8 GB), so impl='auto'
# takes the fused pallas path (kappa recomputed per iteration, no
# [E, w^2] materialization) with blocked-CSR aggregation.
register(ExperimentConfig(
    name="uai4_full_grid_241", family="gkn", downsample=1, ntrain=16,
    ntest=4, nystrom_m=None, radius_train=0.01, width=64, ker_width=256,
    depth=4, kernel_variant="nn3", loss="mse", epochs=40, batch_size=1,
    impl="auto", node_block=512, compute_dtype="bfloat16"))

# Grain-microstructure T-step workflow: the use-case behind the
# reference's two shipped TorusGridSplitter checkpoints (driver script
# not in the reference repo — SURVEY.md section 0; sampleT/assembleT
# semantics mp/utilities.py:1321-1438).
register(ExperimentConfig(
    name="grain_torus_timeseries", family="torus_t", source_res=32,
    downsample=2, ntrain=24, ntest=4, radius_train=0.25, width=32,
    ker_width=64, depth=3, kernel_variant="nn3", loss="mse", epochs=24,
    batch_size=4, learning_rate=1e-3, torus_T=3, assemble_sigma=0.5))

# UAI4_equation_sample.py: full 241 resolution, m=200, sample-count sweep.
register(ExperimentConfig(
    name="uai4_equation_sample", family="gkn", downsample=1, ntrain=100,
    ntest=40, nystrom_m=200, radius_train=0.25, width=64, ker_width=256,
    depth=4, kernel_variant="nn3", loss="mse", epochs=200, batch_size=2))

# UAI5_sample_generalize.py: train-m vs test-m generalization at s=121
# (r=2), k=5 graphs/sample, radius 0.15, ker_width 1000, depth 6; ReLU
# incl. last iteration (UAI5_sample_generalize.py:16-34, 44-67). The
# reference's m=800 cell drops to batch 2 / 100 epochs (line 72-74) —
# apply via --set when running that cell.
register(ExperimentConfig(
    name="uai5_sample_generalize", family="gkn", downsample=2, ntrain=100,
    ntest=100, nystrom_m=400, graphs_per_sample=5, radius_train=0.15,
    width=64, ker_width=1000, depth=6, kernel_variant="nn3",
    relu_last=True, loss="mse", epochs=200, batch_size=10,
    eval_m=(100, 200, 400, 800)))

# UAI6_sample_radius.py: m x radius sweep (100/200/400 x 0.05/0.15/0.4)
# at s=121 (r=2), k=5, ker_width 1000, depth 6; ReLU incl. last
# iteration (UAI6_sample_radius.py:14-75). Reference batch exceptions:
# radius 0.4 pairs with batch 2 (m=400) / 5 (m=200) (lines 55-60).
register(ExperimentConfig(
    name="uai6_sample_radius", family="gkn", downsample=2, ntrain=100,
    ntest=100, nystrom_m=200, graphs_per_sample=5, radius_train=0.15,
    width=64, ker_width=1000, depth=6, kernel_variant="nn3",
    relu_last=True, loss="mse", epochs=200, batch_size=10))

# UAI7_evaluate.py: train on DownsampleGridSplitter shards of the full
# 421 grid (r=30 -> 15x15 subgrid + random fill to m=421,
# UAI7_evaluate.py:43-80, 131-141); L1 backward on encoded u; full-grid
# eval via the r^2=900 deterministic shards + sigma=1 gaussian
# smoothing (lines 218-229).
register(ExperimentConfig(
    name="uai7_evaluate", family="gkn", source_res=421, downsample=1,
    ntrain=10, ntest=1, nystrom_m=421, graphs_per_sample=2,
    radius_train=0.2, width=64, ker_width=1024, depth=6,
    kernel_variant="nn3", loss="l1", epochs=20, batch_size=2,
    train_split=30, eval_protocol="split_downsample"))

# UAI7_evaluate2.py: same shard training; eval via RandomGridSplitter
# l=2 covers (UAI7_evaluate2.py:152, 222-231).
register(ExperimentConfig(
    name="uai7_evaluate2", family="gkn", source_res=421, downsample=1,
    ntrain=10, ntest=1, nystrom_m=421, graphs_per_sample=2,
    radius_train=0.2, width=64, ker_width=1024, depth=6,
    kernel_variant="nn3", loss="l1", epochs=20, batch_size=2,
    train_split=30, split_l=2, eval_protocol="split_random"))

# UAI8_kernel.py: 5-layer kernel MLP (nn5) width ablation at full
# s=241 (r=1), m=200, k=2, radius 0.25, depth 6, ReLU except last
# (UAI8_kernel.py:14-70); shipped sweep value ker_width=256.
register(ExperimentConfig(
    name="uai8_kernel", family="gkn", downsample=1, ntrain=100, ntest=100,
    nystrom_m=200, graphs_per_sample=2, radius_train=0.25, width=64,
    ker_width=256, depth=6, kernel_variant="nn5", loss="mse", epochs=200,
    batch_size=5))

# neurips1_GKN.py: the MGKN paper's GKN baseline (m=200, radius 0.2,
# KernelNN3 depth 4) — the bench.py protocol.
register(ExperimentConfig(
    name="neurips1_gkn", family="gkn", downsample=1, ntrain=100, ntest=100,
    nystrom_m=200, radius_train=0.2, width=64, ker_width=256, depth=4,
    kernel_variant="nn3", loss="mse", epochs=100, batch_size=1,
    scheduler_step=50, scheduler_gamma=0.5))

# neurips5_GKN.py: Burgers GKN, two-layer decoder. Reference protocol
# (lines 46-89): s=2^13/8=1024, ntrain=ntest=32, k=2 graphs/sample,
# m=128, radius 0.2, width 64, ker_width 1024, depth 6 (ReLU except
# last, line 31-33), epochs 101, batch 4, lr 1e-4, StepLR(10, 0.85),
# L1 backward on encoded u (line 186-188), unit normalizer with
# sample_idx decode; full-grid eval via RandomGridSplitter d=1
# (lines 140, 206-231).
register(ExperimentConfig(
    name="neurips5_gkn", family="gkn", dataset="burgers", source_res=1024,
    downsample=1, ntrain=32, ntest=32, nystrom_m=128,
    graphs_per_sample=2, radius_train=0.2, width=64, ker_width=1024,
    depth=6, kernel_variant="nn3", decoder_mlp=True, loss="l1",
    u_norm="unit", epochs=101, batch_size=4, learning_rate=1e-4,
    scheduler_step=10, scheduler_gamma=0.85,
    eval_protocol="split_random"))

# ---------------------------------------------------------------- MGKN

# MGKN_general_darcy2d.py: flagship general MGKN, s=85 (421/5),
# m=[400,100,25], ntrain=1024, decoded-rel-L2 backward.
register(ExperimentConfig(
    name="mgkn_general_darcy2d", family="mgkn_general", source_res=421,
    downsample=5, ntrain=1024, ntest=100, points=(400, 100, 25),
    radius_inner=(0.25, 0.5, 1.0), radius_inter=(0.125, 0.25), width=64,
    ker_width=256, depth=5, loss="rel2", epochs=200, batch_size=1,
    learning_rate=1e-4, scheduler_step=20,
    scheduler_gamma=0.8, eval_protocol="split_random"))

# neurips1_MGKN.py: multilevel m=[2400,1600,400,100,25], radii halving;
# lr = 0.1/ntrain (neurips1_MGKN.py:148), StepLR(10, 0.8).
register(ExperimentConfig(
    name="neurips1_mgkn", family="mgkn_general", downsample=1, ntrain=100,
    ntest=100, points=(2400, 1600, 400, 100, 25),
    radius_inner=(0.01, 0.02, 0.04, 0.08, 0.16),
    radius_inter=(0.0075, 0.015, 0.03, 0.06), width=64, ker_width=256,
    depth=4, mgkn_variant="induced", loss="rel2", epochs=200, batch_size=1,
    learning_rate=1e-3, scheduler_step=10, scheduler_gamma=0.8))

# neurips2_MGKN.py: level-count ablation. The shipped case (case==0,
# neurips2_MGKN.py:130-133) is the single-level forward on m=[25,25] at
# full s=241: only K_00 runs (lines 74-78; the multilevel loop is
# commented out). Multilevel counterparts for the ablation table are the
# script's own commented cases — run via --set, e.g.
#   points=[1600,400,100] radius_inner=[0.0625,0.125,0.25]
#   radius_inter=[0.088125,0.17625] mgkn_variant=induced  (case==1)
# lr = 0.1/ntrain, StepLR(10, 0.8) (neurips2_MGKN.py:152-154).
register(ExperimentConfig(
    name="neurips2_mgkn", family="mgkn_general", source_res=241,
    downsample=1, ntrain=100, ntest=100, points=(25, 25),
    radius_inner=(0.5, 0.125), radius_inter=(0.088125,), width=64,
    ker_width=256, depth=4, mgkn_variant="single", loss="rel2",
    epochs=200, batch_size=1, learning_rate=1e-3, scheduler_step=10,
    scheduler_gamma=0.8))

# neurips3_MGKN.py: resolution generalization, m=[400,100,25];
# lr = 0.1/ntrain, StepLR(10, 0.8) (neurips3_MGKN.py:127-129).
register(ExperimentConfig(
    name="neurips3_mgkn", family="mgkn_general", downsample=8, ntrain=100,
    ntest=100, points=(400, 100, 25), radius_inner=(0.25, 0.5, 1.0),
    radius_inter=(0.125, 0.25), width=64, ker_width=256, depth=4,
    mgkn_variant="induced", loss="rel2", epochs=200, batch_size=1,
    learning_rate=1e-3, scheduler_step=10, scheduler_gamma=0.8,
    u_norm="gaussian", eval_protocol="multires",
    eval_resolutions=(61, 121, 241)))

# MGKN_orthogonal_burgers1d.py: flagship orthogonal MGKN, s=1024.
register(ExperimentConfig(
    name="mgkn_orthogonal_burgers1d", family="mgkn_orthogonal",
    dataset="burgers", source_res=8192, downsample=8, ntrain=1024,
    ntest=100, width=64, ker_width=1024, depth=4, loss="rel2", epochs=200,
    batch_size=1, learning_rate=1e-5, scheduler_step=10,
    scheduler_gamma=0.8))

# ----------------------------------------------------------------- GCN

# neurips4_GCN.py: GCN negative control on the 4-neighbor lattice of the
# full 421 grid (neurips4_GCN.py:62-86): width 128, ker_width 1024,
# depth 4 (16 GCNConv applications), epochs 51, lr 1e-4, StepLR(10,
# 0.85), decoded-rel-L2 backward, unit normalizer. The reference trains
# ntrain=1024; the 421-grid lattice is sample-independent so the runner
# shares ONE edge structure across the stacked batch (the TPU-native
# layout — the reference re-ships edge_index per Data object).
register(ExperimentConfig(
    name="neurips4_gcn", family="gcn", source_res=421, downsample=1,
    ntrain=1024, ntest=100, lattice=True, width=128, ker_width=1024,
    depth=4, loss="rel2", u_norm="unit", epochs=51, batch_size=1,
    learning_rate=1e-4, scheduler_step=10, scheduler_gamma=0.85))


__all__ = ["ExperimentConfig", "register", "get", "names"]
