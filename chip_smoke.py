#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (graph_pde_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root
    python3 chip_smoke.py --grad-spread [N]   # only phase 5's fp8
                                 # gradient checks, once deterministic
                                 # and N times (default 8) in the
                                 # default mode, with their distances
                                 # from float64 and the runs over
    python3 chip_smoke.py --grad-locate   # only the e5m2 gradient
                                 # check's two paths against a float64
                                 # version, op by op (grad_locate)
    python3 chip_smoke.py --mgkn  # only the build and phase 9
    python3 chip_smoke.py --b3    # only B3's build and its times at the
                                 # benchmark's kcached MGKN convs
                                 # (b3_cells)
    python3 chip_smoke.py --gcn   # only phase 10 (no kernel to build)
    python3 chip_smoke.py --torus  # only K1's and B1-bwd's build and
                                 # phase 11
    python3 chip_smoke.py --k1-simt  # only K1's build and its SIMT form
                                 # alone (k1_simt_probe)
    python3 chip_smoke.py --parallel  # only K1's and B1-bwd's build and
                                 # phase 12
    python3 chip_smoke.py --gloo-probe  # which torch.distributed ops gloo
                                 # takes on CUDA tensors (gloo_probe)

Phases, each fatal on failure:
  1. card identity (nvidia-smi) and the build of every CUDA kernel;
  2. each kernel against its plain PyTorch version on the card: K1 and
     K2 at the serving shapes (a real s=61, r=0.2 Darcy graph; an edge
     slice where the plain version materialises [E, 64, 64]), B1-bwd
     (all four outputs; bf16 on the tensor cores, fp32 on the SIMT
     units; a second launch bit-identical) on a 65,536-edge slice of
     the uai4 s=241 training graph and at the (6,1024,1024,4096) and
     (6,16,32,256) kappas, B2-bwd (dmsg bit for bit) on a slice of the
     uai1 s=61 training graph (fp32 and bf16 K) and in every K stream
     type at widths 16 and 128 (warp form) and 12 and 512 (block form);
     every kernel at registry shapes the main paths do not reach (the
     general forms; K1's general form and B1-bwd's SIMT form both on
     16,384 edges, where they split the work over channel groups or
     depth splits, and on 131,072 edges, where one group and one split
     fill the card, a second launch bit-identical); B3-fwd and B3-bwd
     (fp32 and bf16 K) at the uai1
     full-graph shape and at widths 12 and 128; K2 and B2-bwd on the
     e4m3 and e5m2 fp8 K streams of the full uai1 graph; K1's bf16
     tensor-core form on the full uai4 s=241 graph, on a ragged prefix
     of it and at the (6,32,128,256) kappa (a second launch
     bit-identical), and its bf16 SIMT form on the full graph. Each K1,
     B1-bwd and B2-bwd check requires the form its shape takes;
  3. serving: the full-width neurips1 GKN (random weights from a seed,
     Gaussian normalizers fitted on synthetic Darcy samples) answers
     requests through GKNPredictor.predict at s=61 (full graph) and
     s=241 (split path), under impl='auto' (kernel K1) and
     impl='kcached', kcached_fused='on' (kernel K2), and one s=61
     request each with k_storage='float8_e4m3' and 'float8_e5m2' (K2's
     fp8 forms). Every launch counter is zeroed just before each (impl,
     request) and read just after: the path's own kernel (and fp8 form)
     must launch once per depth step, the others never. Outputs must be
     finite, and the impls must agree with each other and with
     plain-path requests (impl='scan'; for fp8, kcached_fused='off' with
     the same k_storage); then the B3 op's own path, cached_contraction
     forward and backward through autograd at the uai1 full-graph shape
     (fp32 and bf16 K), one launch of B3-fwd and B3-bwd each;
  4. per-kernel times at the s=61 shapes (CUDA events), bounds, plain
     and library times, and the latency of each request; K1's SIMT grid
     there (one block a tile) timed in turns with G = 1 forced;
  5. training: fit() takes TRAIN_EPOCHS epochs of N_TRAIN steps (batch
     1) at full width on uai4_full_grid_241 (impl='auto', bf16,
     node_block=512, s=241, MSE: K1 + B1-bwd), uai1_full_resolution
     (impl='kcached', kcached_fused='auto', s=61, L1: K2 + B2-bwd) and
     uai1 with compute_dtype='bfloat16' and k_storage='float8_e4m3'
     (the fp8 forms of K2 and B2-bwd). The counters are zeroed around
     every step and every test evaluation: a step must launch its path's
     forward and backward kernel `depth` times each, in their redesigned
     forms (K1 and B1-bwd on the tensor cores in bf16, B2-bwd a warp per
     edge), and the other path's never. Losses and parameters must be
     finite; the peak device memory of each fit is logged. The step-1 gradients of each config
     are held on a smaller graph with the same stencil against the plain
     path (impl='scan', kcached_fused='off'; uai4 in fp32), and uai4's
     in bf16 and uai1's with e4m3 K (bf16 compute) against their
     Functions' plain versions run on the card. uai1's with e5m2 K is
     judged against float64 on the same fp8 K values (phase_fp8_grads):
     each leaf no farther from float64 than 1.1 times the plain
     versions' distance plus 1e-3, the kernels' fp32 ops (K2 sums,
     B2-bwd dxj) within 1e-4 of float64, the kernels-plain distance
     logged;
  6. K1 (bf16, tensor cores beside the SIMT form on the same inputs),
     B1-bwd (bf16 and fp32; bf16 with its tensor-core form's dx_dh, dw
     and reduce kernels timed apart) and B2-bwd times at the full
     training shapes, B3 (fp32 and bf16 K) at the uai1 full-graph shape, K2 and
     B2-bwd on the fp8 streams of the full uai1 graph: bounds, plain and
     library times, and the step time of each training path; beside the
     redesigned forms, the forms they replaced on the main path (K1 and
     B1-bwd bf16 on the SIMT units, B2-bwd a block per edge) on the same
     inputs;
  7. the command line (graph_pde_tpu_torch.cli.main, in this process,
     from a temporary directory): `run uai4_full_grid_241` for one epoch
     of two steps at full width with `--bundle` (each step must launch
     K1 tc and B1-bwd tc `depth` times, the test evaluation K1 tc
     `depth` times, nothing else; the bundle must hold the trained
     params bit for bit), `predict` on that bundle with a fresh s=241
     sample from a .mat file (the split path: K1 tc only; the written
     predictions within 5e-3 of the plain predictor), `run
     uai1_full_resolution` (the runner's fused kcached path on a float32
     K: each step K2 and B2-bwd `depth` times, the evaluations K2 and
     B3-fwd only; the port's counters `iterate_k2` > 0 and no
     `k_lowered`, and one step's `k_bytes` E_pad * 4096 * 4; its warm
     step logged beside phase 5's; multires at 16, 31, 61), `list` and
     a one-point smoke `sweep` (`--uai1` runs the uai1 run alone, then
     the runner's fused step and the unfused kcached step, B3 on the
     same float32 K, in turns on the s=61 graph);
  8. the orthogonal MGKN and Burgers slice (phase_ortho), from a
     temporary directory: K1 and B1-bwd against their plain versions at
     each of the ten level shapes of the full-width model (kappa (4, kw,
     kw, 4096), kw 1024 ... 16, fp32 and bf16, every B1-bwd output); K1
     general and B1-bwd SIMT timed at every level, their grids logged at
     kw 1024 and 512 and each of their kernels profiled at kw 1024; K1
     SIMT at kw 128 (its cluster grid logged, its bf16 rounding checked,
     timed in turns with the single-block design, G = 1 forced); `run
     mgkn_orthogonal_burgers1d` (width 64, ker_width 1024, depth 4,
     s=1024, 2 steps, 1 test sample) under the registry's
     impl='kcached' with `--bundle` (each step B3-fwd 40, B3-bwd 40)
     and under `--set
     impl=auto` (each step K1 general 36, K1 simt 4, B1-bwd simt 40),
     one step of each profiled;
     `predict` on the kcached bundle against the
     plain predictor (impl='reference'; 1e-4); the full-width step-1
     gradients of impl='auto' against 'reference' (1e-4); `run
     neurips5_gkn` (2 steps, split_random evaluation, B3 only);
  9. the general MGKN slice (phase_mgkn), from a temporary directory:
     K1 and B1-bwd against their plain versions at each of the seven
     conv shapes of mgkn_general_darcy2d at full width (mid levels 0-2,
     kappa (6, kw, kw, 4096) with kw 256, 128, 64; down and up levels
     0-1, one hidden layer, (6, kw, 4096) with kw 128, 64; fp32 and
     bf16, every B1-bwd output, a second launch bit-identical), each
     timed beside its bound and plain version, mid level 0's kernels
     profiled, mid level 1's K1 SIMT as at phase 8's kw 128; `run mgkn_general_darcy2d` (width 64, ker_width 256,
     depth 5, points (400, 100, 25), s = 421 / 5 = 85; 2 steps, 1 test
     sample, split_random evaluation) under `--set impl=auto` with
     `--bundle` (each step K1 general 30, K1 simt 5, B1-bwd simt 35;
     the evaluation's 19 windows one forward each) and under the
     registry's impl='kcached' (each step B3-fwd 35, B3-bwd 35), a
     step of each profiled;
     `predict` on the auto bundle with a fresh s=85 sample against the
     plain predictor (impl='reference'; 1e-4); the full-width forward
     and step-1 gradients of impl='auto' against 'reference' (1e-4) for
     mgkn_general_darcy2d (mkgn), neurips1_mgkn (induced, five levels
     at s=241) and neurips2_mgkn (single);
 10. the GCN baseline (phase_gcn), from a temporary directory:
     neurips4_gcn at full width (width 128, ker_width 1024, depth 4:
     16 GCNConv applications) on the full s=421 lattice (177,241 nodes,
     blocked layout, 177,664 padded), trained through run_experiment on
     the card with 2 samples, 1 test sample and 2 epochs of batch 1 (not
     1024 / 100 / 51). Its aggregation is plain torch (index_add_): no
     hand kernel may launch in any step, evaluation or forward. Logs the
     warm step, the evaluation and the peak device memory; holds the
     card forward of the trained parameters on the test sample against
     the same forward on the CPU (1e-4 of the max-abs); profiles a step;
     runs `cli run neurips4_gcn --smoke --figures DIR` (exit 0, no
     figure: the GCN runner writes none, as the JAX package's) and `cli
     run neurips1_gkn --smoke --figures DIR` ('figures' [] without
     matplotlib, else the three files);
 11. the torus family and the last single-device modules (phase_torus),
     from a temporary directory: the native graph builder, built with
     g++ and required to load, its edges bit-equal to cKDTree's and
     dense numpy's on the s=61 GKN grid, the general MGKN's s=85 levels
     (inner and bipartite) and a full-width torus shard (geometry too),
     its host builds and an s=61 GKN and an s=85 general-MGKN request
     with each builder timed in turns (outputs equal); K1 (general
     form) and B1-bwd (SIMT in fp32, tensor cores in bf16) at the torus
     conv (kappa (5, 32, 64, 1024), in = out = 32) on one shard (E_pad
     12,800) and a batch of 4 (51,200), every output, a second launch
     bit-identical, timed beside bounds and plain versions (B1-bwd's
     tensor-core kernels apart); `run
     grain_torus_timeseries` at full width (TORUS_EPOCHS epochs, not
     24) under the registry's kcached (B3 only) and `--set impl=auto`
     (each step K1 general 3, B1-bwd simt 3; the evaluation K1 general
     3 a shard forward), a step of each profiled, peak memory; the
     torus step-1 gradients of auto against reference, and of
     loop_vjp=True against False (torus; uai1 unfused kcached in fp32
     and bf16 compute); uai1's warm steps with loop_vjp on and off, in
     turns, on the full s=61 training graph;
 12. the parallel slice (phase_parallel): PAR_RANKS processes (start
     method spawn) join a gloo group through parallel.initialize and
     compute on the one card: (a) a DP + TP train step of neurips1_gkn
     at full width (impl='auto', MSE, Adam) on a (2, 2) mesh over its
     N_TRAIN Nystrom m=200 training graphs, one a data rank, the kappa
     MLP split over two model ranks (no rank holds its [256, 4096] last
     layer): each rank runs K1 SIMT on its [256, 2048] last-layer shard
     and its 32 input channels, the small layers gathered, and B1-bwd
     SIMT in the backward; on a 1-d mesh of every rank, node-sharded (b)
     GKN on the s=61 serving graph (impl='pallas': K1 SIMT; 'reference';
     the ring variant) and its gradients on a training graph (B1-bwd
     SIMT), (c) general MGKN mgkn_general_darcy2d (mkgn, s=85, pallas
     and reference, gradients) and (d) orthogonal MGKN at s=1024
     (pallas and reference). Each rank zeroes the counters around each
     path and requires its kernels' exact launches (every rank launches
     K1, and B1-bwd in the gradient runs and the DP + TP step; the
     reference and ring paths none). The parent holds every output, the
     step's loss, its gathered gradients (before the Adam update) and
     updated parameters, and every gradient leaf against single-process
     runs on the card (F32_TOL), every rank holding the same output; a
     world of one rank (NCCL, mesh (1, 1)) must take the single-process
     step bit for bit (loss, gradients, parameters). K1 and B1-bwd at
     rank 0's s=61 edge bucket and at the TP shard's shapes against
     their plain versions, timed; each rank's peak memory and wall
     times.

Prints one JSON line of kernel records before the last line, and as the
last line {"ok": true, "device": {...}}. Exits non-zero, with no result
line, when there is no CUDA device or a phase fails.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import re
import subprocess
import sys
import time

# Serving configuration: neurips1_gkn (KernelNN3, width 64, depth 4).
S_FULL = 61
S_SPLIT = 241
RADIUS = 0.2
SEED = 0
SPLIT_THRESHOLD = 10_000  # the predictor's default: s=241 takes the split
N_FIT = 4            # synthetic samples the normalizers are fitted on
N_FULL_REQUESTS = 2  # s=61 requests per impl
SLICE = 65536        # edges of the kernel-vs-plain comparison
GENERAL_SLICE = 16384  # edges of the general-form comparison
GENERAL_TIME_SLICE = 131072  # edges of the general-form timing
B2_WIDE_SLICE = 1024  # edges of the width-512 B2-bwd comparison
K1_RAGGED = 70001    # edges of the ragged K1 comparison (not a tile multiple)
F32_TOL = 1e-4       # max-abs error / max-abs output, fp32
BF16_TOL = 5e-3      # the same, where bf16 rounding enters

# Training configurations (graph_pde_tpu/experiments/registry.py):
# uai4_full_grid_241 (:184-195) and uai1_full_resolution (:157-165), at
# full width and depth; N_TRAIN synthetic samples each.
S_UAI4, R_UAI4 = 241, 0.01
S_UAI1, R_UAI1 = 61, 0.1
N_TRAIN = 2
TRAIN_EPOCHS = 2
# The step-1 gradient check's graphs: the same stencil (radius / grid
# spacing) on a coarser grid, under ~110 k edges.
S_GRAD4, R_GRAD4 = 61, 0.04
S_GRAD1, R_GRAD1 = 31, 0.2

# The orthogonal slice (graph_pde_tpu/experiments/registry.py:339-344):
# mgkn_orthogonal_burgers1d at full width (width 64, ker_width 1024, depth
# 4, s = 8192 / 8 = 1024: 9 levels, 10 level convs), N_TRAIN training
# samples and one test sample; neurips5_gkn (:280-287) at the same counts.
S_ORTHO = 1024
ORTHO_RUN = ("--set", f"ntrain={N_TRAIN}", "--set", "ntest=1", "--set",
             "epochs=1")
# The general MGKN slice (graph_pde_tpu/experiments/registry.py:293-336):
# mgkn_general_darcy2d at full width (width 64, ker_width 256, depth 5,
# points (400, 100, 25), s = 421 / 5 = 85), N_TRAIN training samples and
# one test sample; neurips1_mgkn and neurips2_mgkn at s=241, one graph.
S_MGKN = 85
MGKN_RUN = ORTHO_RUN
# The GCN baseline (graph_pde_tpu/experiments/registry.py:353-357):
# neurips4_gcn at full width on the s=421 lattice, N_TRAIN training
# samples, one test sample, GCN_EPOCHS epochs of batch 1.
S_GCN = 421
GCN_EPOCHS = 2

# The torus family (graph_pde_tpu/experiments/registry.py:202-205):
# grain_torus_timeseries at full width (width 32, ker_width 64: kappa
# (5, 32, 64, 1024), depth 3, source_res 32 in 2 x 2 shards of 256
# nodes, batch 4, T 3), TORUS_EPOCHS epochs (not 24) of ntrain // batch
# steps; TORUS_E: one shard's E_pad and the flattened batch of 4.
TORUS_EPOCHS = 3
TORUS_E = (12800, 51200)

# The parallel slice (graph_pde_tpu/parallel/): PAR_RANKS processes share
# the one card over gloo (NCCL refuses two ranks on one GPU); the DP + TP
# step takes a (2, 2) mesh of them, node sharding all of them.
PAR_RANKS = 4
PAR_TIMEOUT = 420  # seconds for a phase-12 world to finish

# H100 SXM peaks (NVIDIA data sheet, dense): fp32 SIMT rate, bf16 tensor
# core rate and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
SLEEP_CYCLES = 200_000_000  # ~0.1 s of device sleep while device_ms queues
# bf16 step-1 gradients, kernels against the plain versions on the card:
# the CPU test suite measures how far one float32 ulp on every parameter
# moves a depth-3 model's bf16 gradients (tests/test_torch_gkn.py), and
# tests/test_torch_cuda.py holds the card to the same bound.
GRAD_BF16_TOL = 1e-2
# fp8-K step-1 gradients (phase_fp8_grads): each leaf's distance from the
# float64 gradient on the same fp8 K values at most this factor times the
# plain versions' distance, plus this slack
FP8_GRAD_FACTOR = 1.1
FP8_GRAD_SLACK = 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_err(got, want) -> tuple:
    """(max-abs error, max-abs error / max-abs of ``want``)."""
    err = float((got.double() - want.double()).abs().max())
    return err, err / max(float(want.double().abs().max()), 1e-30)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def time_ms(fn, reps: int) -> float:
    """Mean time of ``fn`` over ``reps`` runs after one warm-up, by CUDA
    events around the whole run."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def gpu_identity() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def serving_setup(dev):
    """Full-width config, seeded weights, normalizers fitted on
    synthetic Darcy samples, and the request fields."""
    import torch

    from graph_pde_tpu_torch.data import darcy_dataset
    from graph_pde_tpu_torch.models import GKNConfig, gkn_init
    from graph_pde_tpu_torch.utils import GaussianNormalizer

    cfg = GKNConfig(width=64, ker_width=256, depth=4, ker_in=6, in_width=6,
                    kernel_layers=(6, 128, 256, 4096), relu_last=False,
                    impl="auto")
    params = gkn_init(torch.Generator().manual_seed(SEED), cfg, device=dev)
    fit = darcy_dataset(N_FIT, S_FULL, seed=SEED)
    flat = {k: v.reshape(N_FIT, -1) for k, v in fit.items()}
    norms = {"a": GaussianNormalizer(flat["coeff"]),
             "a_smooth": GaussianNormalizer(flat["Kcoeff"]),
             "a_gradx": GaussianNormalizer(flat["Kcoeff_x"]),
             "a_grady": GaussianNormalizer(flat["Kcoeff_y"])}
    u_norm = GaussianNormalizer(flat["sol"])
    full = darcy_dataset(N_FULL_REQUESTS, S_FULL, seed=SEED + 1)["coeff"]
    split = darcy_dataset(1, S_SPLIT, seed=SEED + 2)["coeff"]
    return cfg, params, norms, u_norm, full, split


def full_graph(dev, params, norms, coeff):
    """The s=61 request graph as the predictor builds it, on the card,
    with the width-64 node features after fc1."""
    import torch

    g = full_graph_host(norms, coeff).to(dev)
    with torch.inference_mode():
        h = g.x @ params["fc1"]["w"] + params["fc1"]["b"]
    return g, h


def full_graph_host(norms, coeff):
    """The s=61 request graph as the predictor builds it, on the host."""
    import numpy as np

    from graph_pde_tpu_torch.graph import (SquareMeshGenerator, build_graph,
                                           edge_attributes, round_up)
    from graph_pde_tpu_torch.inference import derive_aux_fields

    kc, kx, ky = derive_aux_fields(coeff[None], None, None, None, S_FULL)
    enc = [norms[k].encode(v.reshape(1, -1)).numpy()[0]
           for k, v in (("a", coeff), ("a_smooth", kc), ("a_gradx", kx),
                        ("a_grady", ky))]
    gen = SquareMeshGenerator([[0, 1], [0, 1]], [S_FULL, S_FULL])
    ei = gen.ball_connectivity(RADIUS)
    grid = gen.get_grid()
    x = np.concatenate([grid] + [v[:, None] for v in enc], axis=1)
    attr = edge_attributes(grid, ei, theta=enc[0])
    return build_graph(x, ei[0], ei[1], attr,
                       sample_idx=np.arange(S_FULL * S_FULL),
                       n_edge_pad=round_up(ei.shape[1], 512))


def phase_kernels_vs_plain(g, h, params) -> dict:
    """Each kernel against its plain version on the first SLICE edges."""
    import torch

    from graph_pde_tpu_torch.ops.dense import dense_apply
    from graph_pde_tpu_torch.ops.fused_iterate import (
        fused_iterate_total, fused_iterate_total_plain, sorted_iterate_setup)

    kp = params["kernel"]
    s, a = g.senders[:SLICE], g.edge_attr[:SLICE]
    errs = {}
    with torch.inference_mode():
        for dt, tol in ((None, F32_TOL), ("bfloat16", BF16_TOL)):
            name = f"K1 {dt or 'float32'}"
            errs[name] = check_k1(name, h, s, a, kp, 64, dt, tol,
                                  "tc" if dt else "simt")
        setup = sorted_iterate_setup(g.receivers[:SLICE],
                                     g.edge_mask()[:SLICE], g.x.shape[0])
        kk = dense_apply(kp, a)
        for k_dtype in (torch.float32, torch.bfloat16):
            K = kk.to(k_dtype)
            got = fused_iterate_total(h, s, K, setup, in_channels=64,
                                      out_channels=64)
            want = fused_iterate_total_plain(h, s, K, setup, in_channels=64,
                                             out_channels=64)
            torch.cuda.synchronize()
            ab, rel = rel_err(got, want)
            name = f"K2 K={str(k_dtype).split('.')[-1]}"
            log(f"phase 2: {name}: max-abs err {ab:.3e}, "
                f"relative {rel:.3e} (tol {F32_TOL:g})")
            require(rel <= F32_TOL and bool(torch.isfinite(got).all()), name)
            errs[name] = ab
    return errs


def k1_general_grid(e, w, sms) -> dict:
    """K1 general's last-layer grid on e edges, in = out = w: the
    channel groups G that k1_general_groups picks and the blocks."""
    from graph_pde_tpu_torch.ops.fused_edge_conv import k1_general_groups

    groups, per = k1_general_groups(e, w, w, sms)
    return dict(G=groups, channels_a_group=min(per, w),
                blocks=-(-e // 128) * groups * -(-w // 128))


def b1_simt_grid(e, kw, w, sms) -> dict:
    """B1-bwd SIMT's dx and dh grids on e edges, in = out = w: the
    channel groups Gx and depth splits S that b1_bwd_simt_grid picks
    and each kernel's blocks."""
    from graph_pde_tpu_torch.ops.fused_edge_conv import b1_bwd_simt_grid

    gx, _, hs, depth = b1_bwd_simt_grid(e, kw, w, w, sms)
    return dict(Gx=gx, S=hs, depth=min(depth, w * w),
                blocks_dx=-(-e // 128) * gx,
                blocks_dh=-(-e // 128) * -(-kw // 128) * hs)


def phase_general_forms(g, dev) -> dict:
    """K1's general form and K2's column passes against the plain
    versions, at shapes of registry configs that the serving path does
    not reach: the ker_width=1024 'nn' kappa (6, 1024, 1024, 4096), a
    width-16 kappa (6, 16, 32, 256), K2 at width 128 (K rows of 16384)
    and at width 12 (the element-wise path); B1-bwd at the same two
    kappas and B2-bwd at the same two widths. On the first GENERAL_SLICE
    edges of the s=61 graph, weights and features from a seed; K1
    general and B1-bwd's SIMT form also on the first GENERAL_TIME_SLICE
    edges, where their grids take one channel group and one depth
    split (on GENERAL_SLICE edges, several)."""
    import torch

    from graph_pde_tpu_torch.ops.dense import (dense_apply, dense_init,
                                               layer_dims)
    from graph_pde_tpu_torch.ops.cached_contraction import to_fp8
    from graph_pde_tpu_torch.ops.fused_edge_conv import (
        edge_messages_plain, fused_edge_messages, kernel_shape_supported)
    from graph_pde_tpu_torch.ops.fused_iterate import (
        fused_iterate_total, fused_iterate_total_plain, sorted_iterate_setup)

    gen = torch.Generator().manual_seed(SEED + 3)
    n = g.x.shape[0]
    s, a = g.senders[:GENERAL_SLICE], g.edge_attr[:GENERAL_SLICE]
    setup = sorted_iterate_setup(g.receivers[:GENERAL_SLICE],
                                 g.edge_mask()[:GENERAL_SLICE], n)
    errs = {}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    with torch.inference_mode():
        # K1 general on GENERAL_SLICE edges (several channel groups) and
        # on GENERAL_TIME_SLICE edges (one group: the edge tiles fill the
        # card); a second launch bit-identical
        for layers, w in (((6, 1024, 1024, 4096), 64), ((6, 16, 32, 256), 16)):
            kp = dense_init(gen, layers, device=dev)
            require(not kernel_shape_supported(layer_dims(kp), w, w),
                    f"{layers} takes the general form")
            x = torch.randn(n, w, generator=gen).to(dev)
            for ne in (GENERAL_SLICE, GENERAL_TIME_SLICE):
                grid = k1_general_grid(ne, w, sms)
                require((grid["G"] > 1) == (ne == GENERAL_SLICE),
                        f"K1 general {layers} on {ne} edges: grid {grid}")
                sl, al = g.senders[:ne], g.edge_attr[:ne]
                for dt, tol in ((None, F32_TOL), ("bfloat16", BF16_TOL)):
                    kw_args = dict(in_channels=w, out_channels=w,
                                   compute_dtype=dt)
                    zero_counts()
                    got = fused_edge_messages(x, sl, al, kp, **kw_args)
                    again = fused_edge_messages(x, sl, al, kp, **kw_args)
                    counts = read_counts()
                    want = edge_messages_plain(x, sl, al, kp, **kw_args)
                    torch.cuda.synchronize()
                    ab, rel = rel_err(got, want)
                    name = f"K1 general {layers} {dt or 'float32'}"
                    log(f"phase 2: {name}, {ne} edges, grid {grid}: max-abs "
                        f"err {ab:.3e}, relative {rel:.3e} (tol {tol:g}); "
                        f"second launch bit-identical")
                    require(counts["K1 general"] == 2 == counts["K1"],
                            f"{name}: took the general form ({counts})")
                    require(bool(torch.equal(got, again)),
                            f"{name}: a second launch is bit-identical")
                    require(rel <= tol and bool(torch.isfinite(got).all()),
                            name)
                    errs[name] = max(errs.get(name, 0.0), ab)
                del got, again, want
        for w in (128, 12):
            kp = dense_init(gen, (6, 32, w * w), device=dev)
            x = torch.randn(n, w, generator=gen).to(dev)
            kk = dense_apply(kp, a)
            for k_dtype in (torch.float32, torch.bfloat16):
                K = kk.to(k_dtype)
                got = fused_iterate_total(x, s, K, setup, in_channels=w,
                                          out_channels=w)
                want = fused_iterate_total_plain(x, s, K, setup,
                                                 in_channels=w,
                                                 out_channels=w)
                torch.cuda.synchronize()
                ab, rel = rel_err(got, want)
                name = f"K2 width {w} K={str(k_dtype).split('.')[-1]}"
                log(f"phase 2: {name}: max-abs err {ab:.3e}, relative "
                    f"{rel:.3e} (tol {F32_TOL:g})")
                require(rel <= F32_TOL and bool(torch.isfinite(got).all()),
                        name)
                errs[name] = ab
            del kk, K
        # B1-bwd at the same kappas (one code path for every shape); its
        # SIMT form (float32) also on GENERAL_TIME_SLICE edges, where the
        # dx and dh grids take one group and one split
        gen1 = torch.Generator().manual_seed(SEED + 15)
        for layers, w in (((6, 1024, 1024, 4096), 64), ((6, 16, 32, 256), 16)):
            kp = dense_init(gen, layers, device=dev)
            x = torch.randn(n, w, generator=gen).to(dev)
            h2 = dense_apply(kp[:-1], a, out_nonlinearity=torch.relu)
            gg = torch.randn(GENERAL_SLICE, w, generator=gen).to(dev)
            log(f"phase 2: B1-bwd {layers}, {GENERAL_SLICE} edges, SIMT "
                f"grid {b1_simt_grid(GENERAL_SLICE, layers[-2], w, sms)}")
            for dt, tol in ((None, F32_TOL), ("bfloat16", BF16_TOL)):
                name = f"B1-bwd {layers} {dt or 'float32'}"
                check_b1_bwd(name, x, s, h2, gg, kp[-1]["w"], w, dt, tol)
            ne = GENERAL_TIME_SLICE
            grid = b1_simt_grid(ne, layers[-2], w, sms)
            require(grid["Gx"] == 1 == grid["S"],
                    f"B1-bwd {layers} on {ne} edges: grid {grid}")
            h2 = dense_apply(kp[:-1], g.edge_attr[:ne],
                             out_nonlinearity=torch.relu)
            gg = torch.randn(ne, w, generator=gen1).to(dev)
            check_b1_bwd(f"B1-bwd {layers} float32, {ne} edges, grid {grid}",
                         x, g.senders[:ne], h2, gg, kp[-1]["w"], w, None,
                         F32_TOL)
            del h2, gg
        # B2-bwd: the warp form at widths 16 and 128 (64 is the uai1
        # graph's, below), the block form at 12 (element-wise) and 512
        # (K rows of 262,144 columns: the first B2_WIDE_SLICE edges), in
        # every K stream type
        for w in (16, 128, 12, 512):
            ne = B2_WIDE_SLICE if w == 512 else GENERAL_SLICE
            su = setup if w != 512 else sorted_iterate_setup(
                g.receivers[:ne], g.edge_mask()[:ne], n)
            kp = dense_init(gen, (6, 32, w * w), device=dev)
            kk = dense_apply(kp, a[:ne])
            dt = torch.randn(n, w, generator=gen).to(dev)
            for k_name in ("float32", "bfloat16") + FP8_KINDS:
                K = (to_fp8(kk.to(torch.bfloat16), k_name)
                     if k_name in FP8_KINDS
                     else kk.to(getattr(torch, k_name)))
                check_b2_bwd(f"B2-bwd width {w} K={k_name}", K, su, dt, w)
                del K
            del kk
    return errs


def check_k1(name, x, s, a, kp, w_in, dt, tol, form, want=None,
             phase=2, w_out=64) -> float:
    """K1 against its plain version (``want`` if given) in the form its
    shape takes, and a second launch bit-identical; returns the max-abs
    error."""
    import torch

    from graph_pde_tpu_torch.ops.dense import layer_dims
    from graph_pde_tpu_torch.ops.fused_edge_conv import (
        edge_messages_plain, fused_edge_messages, k1_form)

    kw = dict(in_channels=w_in, out_channels=w_out, compute_dtype=dt)
    require(k1_form(layer_dims(kp), w_in, w_out, dt) == form,
            f"{name}: k1_form picks {form}")
    zero_counts()
    got = fused_edge_messages(x, s, a, kp, **kw)
    again = fused_edge_messages(x, s, a, kp, **kw)
    counts = read_counts()
    if want is None:
        want = edge_messages_plain(x, s, a, kp, **kw)
    torch.cuda.synchronize()
    require(counts[f"K1 {form}"] == 2 == counts["K1"],
            f"{name}: took the {form} form ({counts})")
    same = bool(torch.equal(got, again))
    ab, rel = rel_err(got, want)
    log(f"phase {phase}: {name} [{form}] E {s.shape[0]}: max-abs err "
        f"{ab:.3e}, relative {rel:.3e} (tol {tol:g}); second launch "
        f"bit-identical {same}")
    require(rel <= tol and bool(torch.isfinite(got).all()), name)
    require(same, f"{name}: a second launch is bit-identical")
    return ab


def phase_k1_tc_vs_plain(g4, kp4) -> dict:
    """K1's tensor-core form (bf16) against its plain version: on the
    full uai4 s=241 training graph, on a ragged prefix of it (not a
    multiple of the 128-edge tile) and with the (6, 32, 128, 4 * 64)
    kappa; the SIMT form in bf16 on the full graph as well. Features
    from a seed."""
    import torch

    from graph_pde_tpu_torch.ops.dense import dense_init
    from graph_pde_tpu_torch.ops.fused_edge_conv import (edge_messages_plain,
                                                         simt_edge_messages)

    dev = g4.x.device
    gen = torch.Generator().manual_seed(SEED + 11)
    errs = {}
    with torch.inference_mode():
        x = torch.randn(g4.x.shape[0], 64, generator=gen).to(dev)
        s, a = g4.senders, g4.edge_attr
        want = edge_messages_plain(x, s, a, kp4, in_channels=64,
                                   out_channels=64, compute_dtype="bfloat16")
        errs["K1 tc"] = check_k1(f"K1 bf16 (uai4 s={S_UAI4})", x, s, a,
                                 kp4, 64, "bfloat16", BF16_TOL, "tc", want)
        r = K1_RAGGED
        check_k1(f"K1 bf16 (uai4 s={S_UAI4}, ragged)", x, s[:r], a[:r], kp4,
                 64, "bfloat16", BF16_TOL, "tc")
        small = dense_init(gen, (6, 32, 128, 4 * 64), device=dev)
        check_k1("K1 bf16 kappa (6, 32, 128, 256), in 4",
                 x[:, :4].contiguous(), s[:r], a[:r], small, 4, "bfloat16",
                 BF16_TOL, "tc")
        # the SIMT form on the same full-graph inputs (timed beside the
        # tensor-core form in phase 6)
        got = simt_edge_messages(x, s, a, kp4, in_channels=64,
                                 compute_dtype="bfloat16")
        torch.cuda.synchronize()
        ab, rel = rel_err(got, want)
        log(f"phase 2: K1 bf16 SIMT form (uai4 s={S_UAI4}): max-abs err "
            f"{ab:.3e}, relative {rel:.3e} (tol {BF16_TOL:g})")
        require(rel <= BF16_TOL and bool(torch.isfinite(got).all()),
                "K1 bf16 SIMT form")
    return errs


def check_k1_simt_bf16(name, x, s, a, kp, phase) -> float:
    """K1's SIMT form with bf16 rounding (launched past the wrapper, which
    takes the tensor-core form in bf16 at kw1 <= 128) on its grid
    against the plain version within BF16_TOL, a second launch
    bit-identical; returns the max-abs error."""
    import torch

    from graph_pde_tpu_torch.ops.fused_edge_conv import (edge_messages_plain,
                                                         simt_edge_messages)

    got = simt_edge_messages(x, s, a, kp, in_channels=64,
                             compute_dtype="bfloat16")
    again = simt_edge_messages(x, s, a, kp, in_channels=64,
                               compute_dtype="bfloat16")
    want = edge_messages_plain(x, s, a, kp, in_channels=64, out_channels=64,
                               compute_dtype="bfloat16")
    torch.cuda.synchronize()
    same = bool(torch.equal(got, again))
    ab, rel = rel_err(got, want)
    grid = k1_simt_grid(s.shape[0], kp, 64, "bfloat16", x.device)
    log(f"phase {phase}: {name} [simt, bf16 rounding, G {grid['G']}]: "
        f"max-abs err {ab:.3e}, relative {rel:.3e} (tol {BF16_TOL:g}); "
        f"second launch bit-identical {same}")
    require(rel <= BF16_TOL and bool(torch.isfinite(got).all()), name)
    require(same, f"{name}: a second launch is bit-identical")
    return ab


def k1_simt_grid(e, kp, w_in, dt, dev) -> dict:
    """K1 SIMT's grid on e edges: the clusters of G blocks that
    k1_simt_groups picks, each block's channel pairs, the blocks, the
    resident clusters of G the card reports, the largest G it keeps
    resident and the fewest G whose grid reaches two waves (the rule
    takes at most that many)."""
    import torch

    from graph_pde_tpu_torch.ops.dense import layer_dims
    from graph_pde_tpu_torch.ops.fused_edge_conv import (k1_simt_clusters,
                                                         k1_simt_groups)

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clusters = k1_simt_clusters(layer_dims(kp), w_in, int(dt == "bfloat16"),
                                dev)
    groups, per = k1_simt_groups(e, w_in, sms, clusters)
    tiles = -(-e // 128)
    fits = [g for g, n in clusters.items() if n >= 1]
    return dict(G=groups, pairs_a_block=per, blocks=tiles * groups,
                resident_clusters=clusters[groups],
                largest_resident=max(fits),
                two_waves_at=next((g for g in fits
                                   if tiles >= 2 * clusters[g]), None))


def check_b1_bwd(name, x, s, h2, g, wl, w, dt, tol, phase=2,
                 w_in=None) -> float:
    """B1-bwd against its plain version, all four outputs, in the form
    its shape takes (tensor cores in bf16, SIMT in float32, for every
    kappa checked here), and a second launch bit-identical; returns the
    largest max-abs error."""
    import torch

    from graph_pde_tpu_torch.ops.fused_edge_conv import (
        edge_messages_bwd_plain, fused_edge_messages_bwd)

    kw = dict(in_channels=w_in or w, out_channels=w, compute_dtype=dt)
    form = "tc" if dt else "simt"
    zero_counts()
    got = fused_edge_messages_bwd(x, s, h2, g, wl, **kw)
    again = fused_edge_messages_bwd(x, s, h2, g, wl, **kw)
    counts = read_counts()
    want = edge_messages_bwd_plain(x, s, h2, g, wl, **kw)
    torch.cuda.synchronize()
    require(counts[f"B1-bwd {form}"] == 2 == counts["B1-bwd"],
            f"{name}: took the {form} form ({counts})")
    require(all(bool(torch.equal(a, b)) for a, b in zip(got, again)),
            f"{name}: a second launch is bit-identical")
    worst = 0.0
    for out, a, b in zip(("dx_src", "dh2", "dWl", "dbl"), got, want):
        ab, rel = rel_err(a, b)
        log(f"phase {phase}: {name} [{form}] {out}: max-abs err {ab:.3e}, "
            f"relative {rel:.3e} (tol {tol:g}); second launch bit-identical")
        require(rel <= tol and bool(torch.isfinite(a).all()),
                f"{name} {out}")
        worst = max(worst, ab)
    return worst


def check_b2_bwd(name, K, setup, dtotal, w) -> float:
    """B2-bwd against its plain version: dxj within F32_TOL, dmsg bit for
    bit, in the form its width takes (a warp per edge at the GKN widths
    16, 64 and 128, a block per edge at 12 and 512); returns dxj's
    max-abs error."""
    import torch

    from graph_pde_tpu_torch.ops.fused_iterate import (
        fused_iterate_bwd, fused_iterate_bwd_plain)

    kw = dict(in_channels=w, out_channels=w)
    form = "warp" if w in (16, 64, 128) else "general"
    zero_counts()
    dxj, dmsg = fused_iterate_bwd(K, setup, dtotal, **kw)
    counts = read_counts()
    wdx, wdm = fused_iterate_bwd_plain(K, setup, dtotal, **kw)
    torch.cuda.synchronize()
    require(counts[f"B2-bwd {form}"] == 1 == counts["B2-bwd"],
            f"{name}: took the {form} form ({counts})")
    ab, rel = rel_err(dxj, wdx)
    same = bool(torch.equal(dmsg, wdm))
    log(f"phase 2: {name} [{form}] dxj: max-abs err {ab:.3e}, relative "
        f"{rel:.3e} (tol {F32_TOL:g}); dmsg bit-equal {same}")
    require(rel <= F32_TOL and bool(torch.isfinite(dxj).all()), f"{name} dxj")
    require(same, f"{name} dmsg bit-equal")
    return ab


def phase_serving(cfg, params, norms, u_norm, full, split) -> dict:
    """Requests through GKNPredictor.predict on the default device. All
    launch counters are zeroed just before each (impl, request) path and
    read just after it: the path's own kernel must launch once per depth
    step and batch, the other kernels (and the backward ones) never.
    Returns the launches of each path."""
    import numpy as np
    import torch

    from graph_pde_tpu_torch.inference import GKNPredictor

    kcached = dataclasses.replace(cfg, impl="kcached", kcached_fused="on")
    cfgs = {"auto": cfg, "kcached": kcached}
    preds = {k: GKNPredictor(params, c, norms, u_norm, radius=RADIUS,
                             split_threshold=SPLIT_THRESHOLD)
             for k, c in cfgs.items()}
    requests = [(f"s={S_FULL} #{j}", full[j:j + 1])
                for j in range(len(full))]
    requests.append((f"s={S_SPLIT} split", split))
    outs, lat, launches = {}, {}, {}

    def serve(impl, pred, c, name, coeff):
        zero_counts()
        t0 = time.perf_counter()
        out = pred.predict(coeff)
        torch.cuda.synchronize()
        lat[(impl, name)] = time.perf_counter() - t0
        got = read_counts()
        outs[(impl, name)] = out
        launches[f"{impl} {name}"] = got
        # one batch per request: the s=61 samples of a call form one
        # batch, the s=241 shards of one sample form one batch
        want = expected(c, c.depth, 0)
        log(f"phase 3: {impl:8s} {name:12s} latency "
            f"{lat[(impl, name)] * 1e3:.1f} ms, launches {got}")
        require(got == want, f"{impl} {name}: launches {got}, "
                f"expected {want}")

    for impl, pred in preds.items():
        for name, coeff in requests:
            serve(impl, pred, cfgs[impl], name, coeff)
    # fp8 K storage (the k8 stream through K2) on the first s=61 request
    name, coeff = requests[0]
    for ks in ("float8_e4m3", "float8_e5m2"):
        c = dataclasses.replace(kcached, k_storage=ks)
        serve(f"kcached {ks}", GKNPredictor(
            params, c, norms, u_norm, radius=RADIUS,
            split_threshold=SPLIT_THRESHOLD), c, name, coeff)

    for (impl, name), out in outs.items():
        s = S_SPLIT if "split" in name else S_FULL
        log(f"phase 3: {impl:20s} {name:12s} out {out.shape}, "
            f"range [{out.min():.4g}, {out.max():.4g}]")
        require(out.shape == (1, s * s) and bool(np.isfinite(out).all()),
                f"{impl} {name} output")

    def agree(a, b, tol, what):
        # on the model's own scale: the decoded field is out * std + mean,
        # whose mean would hide differences of the model output
        a, b = (u_norm.encode(v).numpy() for v in (a, b))
        err = float(np.abs(a - b).max() / np.abs(b).max())
        log(f"phase 3: {what}: relative max-abs diff {err:.3e} "
            f"(tol {tol:g})")
        require(err <= tol, what)

    # the s=61 kcached K is bf16 (per-graph E * 64 * 64 * 4 B > 2 GiB);
    # the s=241 shards keep a float32 K
    for name, _ in requests:
        tol = F32_TOL if "split" in name else BF16_TOL
        agree(outs[("kcached", name)], outs[("auto", name)], tol,
              f"kcached vs auto, {name}")
    plain = GKNPredictor(params, dataclasses.replace(cfg, impl="scan"),
                         norms, u_norm, radius=RADIUS,
                         split_threshold=SPLIT_THRESHOLD)
    for name, coeff in (requests[0], requests[-1]):
        zero_counts()
        t0 = time.perf_counter()
        ref = plain.predict(coeff)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        log(f"phase 3: plain (impl='scan') {name} latency {dt * 1e3:.1f} ms")
        require(all(v == 0 for v in read_counts().values()),
                f"plain {name} launched no kernel")
        f32 = "split" in name
        agree(outs[("auto", name)], ref, F32_TOL, f"auto vs plain, {name}")
        agree(outs[("kcached", name)], ref, F32_TOL if f32 else BF16_TOL,
              f"kcached vs plain, {name}")
    # each fp8 request against the plain (unfused) path with the same
    # k_storage, and how far fp8 storage moved it from the bf16-K request
    name, coeff = requests[0]
    for ks in ("float8_e4m3", "float8_e5m2"):
        plain8 = GKNPredictor(params, dataclasses.replace(
            kcached, kcached_fused="off", k_storage=ks), norms, u_norm,
            radius=RADIUS, split_threshold=SPLIT_THRESHOLD)
        zero_counts()
        ref = plain8.predict(coeff)
        torch.cuda.synchronize()
        require(all(v == 0 for v in read_counts().values()),
                f"plain {ks} {name} launched no kernel")
        got = outs[(f"kcached {ks}", name)]
        agree(got, ref, BF16_TOL, f"kcached {ks} vs plain {ks}, {name}")
        a, b = (u_norm.encode(v).numpy() for v in (got, outs[("kcached",
                                                              name)]))
        log(f"phase 3: kcached {ks} vs bf16 K, {name}: relative max-abs "
            f"diff {float(np.abs(a - b).max() / np.abs(b).max()):.3e}")
    return launches


def library_spmm(x, senders, K, setup):
    """One torch.sparse.mm that computes the K2 function: a CSR matrix
    A[n, e*in + i] = x[senders[e], i] over valid edges, times K viewed as
    [E*in, out]. Used only as a yardstick."""
    import torch

    e, c = K.shape
    w = x.shape[1]
    valid = setup.mask
    eidx = torch.nonzero(valid).squeeze(1)
    counts = torch.zeros(setup.num_segments, dtype=torch.int64,
                         device=x.device)
    counts.index_add_(0, setup.receivers[eidx],
                      torch.ones_like(eidx))
    crow = torch.zeros(setup.num_segments + 1, dtype=torch.int64,
                       device=x.device)
    crow[1:] = torch.cumsum(counts * w, 0)
    cols = (eidx[:, None] * w + torch.arange(w, device=x.device)).reshape(-1)
    vals = x.index_select(0, senders[eidx]).reshape(-1).to(K.dtype)
    a = torch.sparse_csr_tensor(crow.int(), cols.int(), vals,
                                size=(setup.num_segments, e * w))
    kv = K.view(e * w, c // w)
    return lambda: torch.sparse.mm(a, kv)


def set_bound(r: dict) -> None:
    """bound_ms and bound_by of a kernel record: the larger of its bytes
    over the memory rate and its operations over the peak rate of their
    type (``flops`` on the fp32 SIMT units, ``bf16_flops`` on the bf16
    tensor cores; the two kinds of unit run at once, so the operations
    take the longer of the two)."""
    t_ops = max(r["flops"] / PEAK_F32_FLOPS,
                r.get("bf16_flops", 0.0) / PEAK_BF16_FLOPS) * 1e3
    t_bytes = r["bytes"] / PEAK_BYTES * 1e3
    r["bound_ms"] = max(t_ops, t_bytes)
    r["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"


def k1_cost(kp, e, n, tc=False, w=64, w_in=None) -> dict:
    """K1's operations and bytes on e edges of an n-node graph (in = out
    = w, or in = w_in): the MLP's products and the contraction, every
    input read once
    (x, senders, attr, weights), the messages written once. With ``tc``
    (the bf16 tensor-core form) the products after the first layer run
    on bf16 operands, so they count as ``bf16_flops``; attr @ W0 and the
    contraction stay fp32 ``flops``."""
    from graph_pde_tpu_torch.ops.dense import layer_dims

    dims = layer_dims(kp)
    mlp = [2.0 * e * a * b for a, b in dims]
    fold = 2.0 * e * dims[-1][1]
    wbytes = 4 * sum(p["w"].numel() + p["b"].numel() for p in kp)
    nbytes = (4 * n * (w_in or w) + 8 * e + 4 * e * dims[0][0] + wbytes
              + 4 * e * w)
    if tc:
        return dict(flops=mlp[0] + fold, bf16_flops=sum(mlp[1:]),
                    bytes=nbytes)
    return dict(flops=sum(mlp) + fold, bytes=nbytes)


def forward_times(g, cfg, params) -> dict:
    """Device time of one whole s=61 forward per impl (the rest of a
    request's latency is host work: graph build, encode, decode)."""
    import torch

    from graph_pde_tpu_torch.models import gkn_apply

    cfgs = {"auto": cfg,
            "kcached": dataclasses.replace(cfg, impl="kcached",
                                           kcached_fused="on"),
            "plain scan": dataclasses.replace(cfg, impl="scan")}
    out = {}
    with torch.inference_mode():
        for name, c in cfgs.items():
            out[name] = time_ms(lambda: gkn_apply(params, c, g), 2)
            log(f"phase 4: s={S_FULL} forward, {name}: {out[name]:.1f} ms")
    return out


def phase_times(g, h, params) -> dict:
    """Kernel, plain and library times at the s=61 serving shapes."""
    import torch

    from graph_pde_tpu_torch.ops.kcached_loop import build_cached_k
    from graph_pde_tpu_torch.ops.dense import dense_init, layer_dims
    from graph_pde_tpu_torch.ops.fused_edge_conv import (
        edge_messages_plain, fused_edge_messages, simt_edge_messages)
    from graph_pde_tpu_torch.ops.fused_iterate import (
        fused_iterate_total, fused_iterate_total_plain, sorted_iterate_setup)

    kp = params["kernel"]
    e = g.senders.shape[0]
    n = g.x.shape[0]
    mask = g.edge_mask()
    e_valid = int(mask.sum())
    c = layer_dims(kp)[-1][1]

    def k1_record(kp, s, a, reps):
        k1 = lambda: fused_edge_messages(h, s, a, kp, in_channels=64,
                                         out_channels=64)
        k1p = lambda: edge_messages_plain(h, s, a, kp, in_channels=64,
                                          out_channels=64)
        return dict(ms=time_ms(k1, reps), plain_ms=time_ms(k1p, 2),
                    library_ms=None, **k1_cost(kp, s.shape[0], n))

    rec = {}
    with torch.inference_mode():
        rec["K1"] = k1_record(kp, g.senders, g.edge_attr, 3)
        # the single-block design (G = 1 forced) on the same inputs, in
        # turns with the rule's grid (new, old, old, new)
        old = lambda: simt_edge_messages(h, g.senders, g.edge_attr, kp,
                                         in_channels=64, groups=1)
        t_old = [time_ms(old, 3), time_ms(old, 3)]
        turns = [rec["K1"]["ms"], *t_old,
                 time_ms(lambda: fused_edge_messages(
                     h, g.senders, g.edge_attr, kp, in_channels=64,
                     out_channels=64), 3)]
        rec["K1"].update(ms=(turns[0] + turns[3]) / 2, ms_turns=turns,
                         previous_form_ms=sum(t_old) / 2,
                         grid=k1_simt_grid(e, kp, 64, None, h.device))
        # K1's general form, off the serving path: the ker_width=1024
        # 'nn' kappa on the first GENERAL_TIME_SLICE edges
        wide = dense_init(torch.Generator().manual_seed(SEED + 4),
                          (6, 1024, 1024, 4096), device=h.device)
        rec["K1 general form, kappa (6, 1024, 1024, 4096), "
            f"{GENERAL_TIME_SLICE} edges"] = k1_record(
                wide, g.senders[:GENERAL_TIME_SLICE],
                g.edge_attr[:GENERAL_TIME_SLICE], 2)

        k_dtype = torch.bfloat16   # the s=61 serving dtype of the cached K
        K = build_cached_k(kp, g.edge_attr, k_dtype=k_dtype)
        setup = sorted_iterate_setup(g.receivers, mask, n)
        k2 = lambda: fused_iterate_total(h, g.senders, K, setup,
                                         in_channels=64, out_channels=64)
        k2p = lambda: fused_iterate_total_plain(h, g.senders, K, setup,
                                                in_channels=64,
                                                out_channels=64)
        lib = library_spmm(h, g.senders, K, setup)
        flops = 2.0 * e_valid * c
        nbytes = (e_valid * c * K.element_size() + 9 * e + 4 * n * 64
                  + 8 * (n + 1) + 4 * n * 64)
        rec["K2"] = dict(ms=time_ms(k2, 5), plain_ms=time_ms(k2p, 2),
                         flops=flops, bytes=nbytes,
                         library_ms=time_ms(lib, 3))
        del K, lib
    for r in rec.values():
        set_bound(r)
    log(f"phase 4: s={S_FULL} shapes: E={e} ({e_valid} valid), N={n}")
    log(f"phase 4: K1 simt grid {rec['K1']['grid']}; single-block design "
        f"(G = 1 forced) {rec['K1']['previous_form_ms']:.3f} ms, turns "
        f"{rec['K1']['ms_turns']}")
    for name, r in rec.items():
        log(f"phase 4: {name}: {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} "
            f"ms, bound {r['bound_ms']:.3f} ms ({r['bound_by']}), "
            f"library {r['library_ms']}")
    return rec


# Every launch counter: K2 and B2-bwd count all their launches, and their
# fp8 forms (the k8 stream of k_storage) also count on their own; K1,
# B1-bwd and B2-bwd count each launch once more under the kernel form
# that took it (tensor cores, SIMT or general; warp per edge or block per
# edge).
COUNTED = ("K1", "B1-bwd", "K2", "B2-bwd", "K2 e4m3", "K2 e5m2",
           "B2-bwd e4m3", "B2-bwd e5m2", "B3-fwd", "B3-bwd", "B1-bwd tc",
           "B1-bwd simt", "B2-bwd warp", "B2-bwd general", "K1 tc",
           "K1 simt", "K1 general")


def counters() -> dict:
    """name -> (wrapper, counter attribute)."""
    from graph_pde_tpu_torch.ops.cached_contraction import (
        cached_contraction, cached_contraction_bwd)
    from graph_pde_tpu_torch.ops.fused_edge_conv import (
        fused_edge_messages, fused_edge_messages_bwd)
    from graph_pde_tpu_torch.ops.fused_iterate import (fused_iterate_bwd,
                                                       fused_iterate_total)

    fns = (fused_edge_messages, fused_edge_messages_bwd, fused_iterate_total,
           fused_iterate_bwd, fused_iterate_total, fused_iterate_total,
           fused_iterate_bwd, fused_iterate_bwd, cached_contraction,
           cached_contraction_bwd) + (fused_edge_messages_bwd,) * 2 + (
               fused_iterate_bwd,) * 2 + (fused_edge_messages,) * 3
    attrs = ("launches",) * 4 + ("e4m3_launches", "e5m2_launches") * 2 + (
        "launches",) * 2 + ("tc_launches", "simt_launches", "warp_launches",
                            "general_launches", "tc_launches",
                            "simt_launches", "general_launches")
    return {k: (f, a) for k, f, a in zip(COUNTED, fns, attrs)}


def zero_counts() -> None:
    for fn, attr in counters().values():
        setattr(fn, attr, 0)


def read_counts() -> dict:
    return {k: getattr(fn, attr) for k, (fn, attr) in counters().items()}


def only_b3(counts: dict) -> bool:
    """Whether ``counts`` launched no kernel but B3-fwd and B3-bwd: the
    unfused kcached path contracts a float32 K on the card through B3
    and a bf16 one in plain torch."""
    return not any(v for k, v in counts.items()
                   if k not in ("B3-fwd", "B3-bwd"))


def expected(cfg, n_fwd: int, n_bwd: int) -> dict:
    """The counts of a run of ``cfg``'s path that launches its forward
    kernel n_fwd times and its backward kernel n_bwd times: K1 / B1-bwd
    for impl='auto', K2 / B2-bwd (and their fp8 form, with k_storage)
    for the fused kcached path; every other counter 0. Both kernels of a
    path must take the redesigned form: K1 and B1-bwd on the tensor cores
    in bf16 (their SIMT forms in float32), B2-bwd a warp per edge (the
    configs' width is 64)."""
    if cfg.impl == "auto":
        form = "tc" if cfg.compute_dtype == "bfloat16" else "simt"
        fwd, bwd = ("K1", f"K1 {form}"), ("B1-bwd", f"B1-bwd {form}")
    else:
        fwd, bwd = ("K2",), ("B2-bwd", "B2-bwd warp")
        if cfg.k_storage:
            kind = cfg.k_storage.split("_")[1]
            fwd, bwd = fwd + (f"K2 {kind}",), bwd + (f"B2-bwd {kind}",)
    return {k: n_fwd if k in fwd else n_bwd if k in bwd else 0
            for k in COUNTED}


def uai4_config(dtype="bfloat16"):
    from graph_pde_tpu_torch.models import GKNConfig

    return GKNConfig(width=64, ker_width=256, depth=4, ker_in=6, in_width=6,
                     kernel_layers=(6, 128, 256, 4096), relu_last=False,
                     impl="auto", compute_dtype=dtype)


def uai1_config():
    from graph_pde_tpu_torch.models import GKNConfig

    return GKNConfig(width=64, ker_width=1024, depth=6, ker_in=6, in_width=6,
                     kernel_layers=(6, 1024, 1024, 4096), relu_last=True,
                     impl="kcached", kcached_fused="auto")


def training_data(n, s, r, u_norm, node_block, seed):
    """n synthetic Darcy samples at s x s, prepared and built into the
    stacked host graphs of the full grid at radius r."""
    from graph_pde_tpu_torch.data import (darcy_dataset, darcy_gkn_graphs,
                                          prepare_darcy)

    t0 = time.perf_counter()
    fields = darcy_dataset(n, s, seed=seed)
    arrays, _ = prepare_darcy(fields, n=n, u_norm=u_norm)
    graphs = darcy_gkn_graphs(arrays, radius=r, node_block=node_block)
    log(f"phase 5: data s={s} r={r} node_block={node_block}: {n} graphs, "
        f"N_pad={graphs.x.shape[1]}, E_pad={graphs.senders.shape[1]}, "
        f"valid edges {int(graphs.n_edge[0])} "
        f"({time.perf_counter() - t0:.1f} s on the host)")
    return arrays, graphs


def phase_backward_vs_plain(g4, kp4, g1, kp1) -> dict:
    """B1-bwd on the first SLICE edges of the uai4 s=241 graph (fp32
    and bf16) and B2-bwd on the first SLICE edges of the uai1 s=61 graph
    (fp32 and bf16 K), against their plain versions. x is the fc1 width,
    h2 the recomputed small layers, g and dtotal from a seed."""
    import torch

    from graph_pde_tpu_torch.ops.kcached_loop import build_cached_k
    from graph_pde_tpu_torch.ops.dense import dense_apply
    from graph_pde_tpu_torch.ops.fused_iterate import sorted_iterate_setup

    dev = g4.x.device
    gen = torch.Generator().manual_seed(SEED + 5)
    errs = {}
    with torch.inference_mode():
        x4 = torch.randn(g4.x.shape[0], 64, generator=gen).to(dev)
        s, a = g4.senders[:SLICE], g4.edge_attr[:SLICE]
        h2 = dense_apply(kp4[:-1], a, out_nonlinearity=torch.relu)
        gg = torch.randn(SLICE, 64, generator=gen).to(dev)
        for dt, tol in ((None, F32_TOL), ("bfloat16", BF16_TOL)):
            name = f"B1-bwd {dt or 'float32'}"
            errs[name] = check_b1_bwd(f"{name} (uai4 s={S_UAI4})", x4, s, h2,
                                      gg, kp4[-1]["w"], 64, dt, tol)
        n1 = g1.x.shape[0]
        setup = sorted_iterate_setup(g1.receivers[:SLICE],
                                     g1.edge_mask()[:SLICE], n1)
        kk = build_cached_k(kp1, g1.edge_attr[:SLICE],
                            k_dtype=torch.float32)
        dt = torch.randn(n1, 64, generator=gen).to(dev)
        for k_dtype in (torch.float32, torch.bfloat16):
            name = f"B2-bwd K={str(k_dtype).split('.')[-1]}"
            errs[name] = check_b2_bwd(f"{name} (uai1 s={S_UAI1})",
                                      kk.to(k_dtype), setup, dt, 64)
    return errs


def phase_training(name, cfg, arrays, graphs, loss, u_norm, gamma) -> dict:
    """fit() on the card for TRAIN_EPOCHS epochs of batch-1 steps, with a
    test evaluation on the same graphs after each epoch. Every counter is
    zeroed before fit and after each step and evaluation, and read after
    each: a step launches the path's forward and backward kernel `depth`
    times each, an evaluation the forward kernel `depth` times per
    graph, and the other path's kernels never."""
    import numpy as np
    import torch

    from graph_pde_tpu_torch.models import gkn_init
    from graph_pde_tpu_torch.train import GKNTask, TrainConfig, fit
    from graph_pde_tpu_torch.train.trainer import param_leaves

    task = GKNTask(cfg, u_normalizer=arrays.u_normalizer, loss_type=loss,
                   use_sample_idx=u_norm == "unit")
    params = gkn_init(torch.Generator().manual_seed(SEED), cfg)
    tc = TrainConfig(epochs=TRAIN_EPOCHS, batch_size=1, learning_rate=1e-4,
                     weight_decay=5e-4, scheduler_step=50,
                     scheduler_gamma=gamma, loss=loss, seed=SEED)
    steps, evals, clock = [], [], [0.0]

    def on_step(ep, step, metrics):
        lv = float(metrics["loss"])
        torch.cuda.synchronize()
        now = time.perf_counter()
        got = read_counts()
        zero_counts()
        steps.append(dict(epoch=ep, step=step, loss=lv,
                          ms=(now - clock[0]) * 1e3, launches=got))
        clock[0] = now
        log(f"phase 5: {name} epoch {ep} step {step}: loss {lv:.6g}, "
            f"{steps[-1]['ms']:.1f} ms, launches {got}")
        want = expected(cfg, cfg.depth, cfg.depth)
        require(got == want, f"{name} step launches {got}, expected {want}")
        require(bool(np.isfinite(lv)), f"{name} loss finite")

    def on_epoch(ep, p, train_l2, test_l2):
        torch.cuda.synchronize()
        got = read_counts()
        zero_counts()
        evals.append(got)
        log(f"phase 5: {name} epoch {ep}: train rel-L2 {train_l2:.6g}, "
            f"test rel-L2 {test_l2:.6g}, evaluation launches {got}")
        want = expected(cfg, cfg.depth * N_TRAIN, 0)
        require(got == want, f"{name} evaluation launches {got}")
        require(bool(np.isfinite(train_l2) and np.isfinite(test_l2)),
                f"{name} rel-L2 finite")
        clock[0] = time.perf_counter()

    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    clock[0] = time.perf_counter()
    res = fit(task, params, graphs, tc, test_data=graphs, callback=on_epoch,
              step_callback=on_step)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    require(len(steps) == TRAIN_EPOCHS * N_TRAIN, f"{name} step count")
    require(all(bool(torch.isfinite(t).all())
                for t in param_leaves(res.params)), f"{name} params finite")
    launches = {k: sum(st["launches"][k] for st in steps)
                + sum(ev[k] for ev in evals) for k in COUNTED}
    warm = [st["ms"] for st in steps[1:]]
    log(f"phase 5: {name}: {len(steps)} steps, step times (ms) "
        f"{[round(st['ms'], 1) for st in steps]}, warm mean "
        f"{sum(warm) / len(warm):.1f} ms; launches {launches}; peak "
        f"device memory {peak_gib:.2f} GiB (max_memory_allocated over fit)")
    profile_step(name, task, res.params, graphs)
    return dict(launches=launches, step_ms=[st["ms"] for st in steps],
                warm_step_ms=sum(warm) / len(warm), peak_gib=peak_gib,
                losses=[st["loss"] for st in steps])


def profile_step(name, task, params, graphs, phase=6) -> dict:
    """One more train step on the first graph under torch.profiler: the
    device time of each kernel, the device's busy time and its idle
    share of the step's wall time, the wall time taken in an unprofiled
    step just before."""
    import torch

    from graph_pde_tpu_torch.data.datasets import map_arrays
    from graph_pde_tpu_torch.train import adam_steplr, make_train_step
    from graph_pde_tpu_torch.train.trainer import param_leaves, to_device

    opt, _ = adam_steplr(param_leaves(params), 1e-4, weight_decay=5e-4)
    step = make_train_step(task, opt)
    batch = map_arrays(lambda a: a[:1],
                       to_device(graphs, torch.device("cuda")))
    return profile_fn(name, lambda: step(params, batch), phase)


def profile_fn(name, fn, phase) -> dict:
    """``fn`` (one train step) once to warm up, once timed to a sync,
    and once under torch.profiler: the device time of each kernel, the
    device's busy time and its idle share of the timed step's wall
    time."""
    import torch

    from graph_pde_tpu_torch.train import profile_trace

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    zero_counts()
    with profile_trace(f"results/profile_{name}_step") as prof:
        fn()
        torch.cuda.synchronize()
    rows = kernel_rows(prof)
    busy = sum(r[0] for r in rows)
    idle = max(0.0, 1 - busy / wall)
    log(f"phase {phase}: {name} step profile: wall {wall:.1f} ms "
        f"(unprofiled), device busy {busy:.1f} ms, idle share {idle:.3f}")
    for ms, count, key in rows[:8]:
        log(f"phase {phase}: {name} step profile: {ms:9.3f} ms "
            f"({ms / busy:6.1%}) x {count:4d}  {key[:70]}")
    return dict(wall_ms=wall, busy_ms=busy, idle_share=idle)


@contextlib.contextmanager
def plain_on_card():
    """Within it, the fused edge-message and fused iteration Functions
    run their plain versions on CUDA tensors: the same rounding points as
    K1 / B1-bwd and K2 / B2-bwd, and no launch. The reference of the bf16
    and fp8 gradient checks, where the plain paths (impl='scan',
    kcached_fused='off') round elsewhere."""
    import torch

    from graph_pde_tpu_torch.ops import fused_edge_conv as fe
    from graph_pde_tpu_torch.ops import fused_iterate as fi
    from graph_pde_tpu_torch.ops.dense import unflatten_params

    saved = fe._launch, fe._launch_bwd, fi._launch, fi._launch_bwd
    fe._launch = lambda x, s, a, w, i, o, dt: fe.edge_messages_plain(
        x, s, a, unflatten_params(w), in_channels=i, out_channels=o,
        compute_dtype=dt)
    fe._launch_bwd = lambda x, s, h2, g, wl, i, o, dt: (
        fe.edge_messages_bwd_plain(x, s, h2, g, wl, in_channels=i,
                                   out_channels=o, compute_dtype=dt))
    fi._launch = lambda x, s, K, setup, i, o: fi.fused_iterate_total_plain(
        x, s, K, setup, in_channels=i, out_channels=o)
    fi._launch_bwd = lambda K, setup, dt, i, o: fi.fused_iterate_bwd_plain(
        K, setup, dt.to(torch.float32), in_channels=i, out_channels=o)
    try:
        yield
    finally:
        fe._launch, fe._launch_bwd, fi._launch, fi._launch_bwd = saved


def grad_inputs(cfg, u_norm, s, r, node_block):
    """The step-1 gradient checks' inputs: the prepared arrays of two
    synthetic samples (so that a per-node normalizer has a spread), the
    first as a batch of one on the card, and seeded parameters."""
    import torch

    from graph_pde_tpu_torch.data.datasets import map_arrays
    from graph_pde_tpu_torch.models import gkn_init

    arrays, graphs = training_data(2, s, r, u_norm, node_block, SEED + 7)
    batch = map_arrays(lambda a: a[:1], graphs.to())
    params = gkn_init(torch.Generator().manual_seed(SEED + 8), cfg)
    return arrays, batch, params


def step1_grads(cfg, plain_cfg, loss, u_norm, s, r, node_block,
                plain_ctx=contextlib.nullcontext):
    """A function that takes the step-1 loss gradients of ``cfg``
    (kernels) and of ``plain_cfg`` run inside ``plain_ctx`` (plain
    versions, no kernel launch) from the same parameters and one graph,
    and returns (loss, gradients, launches) of each."""
    import torch

    from graph_pde_tpu_torch.train import GKNTask, make_loss_fn
    from graph_pde_tpu_torch.train.trainer import param_leaves, trainable

    arrays, batch, params = grad_inputs(cfg, u_norm, s, r, node_block)

    def grads(c):
        task = GKNTask(c, u_normalizer=arrays.u_normalizer, loss_type=loss,
                       use_sample_idx=u_norm == "unit")
        p = trainable(params)
        zero_counts()
        lv, _ = make_loss_fn(task, loss)(p, batch)
        lv.backward()
        torch.cuda.synchronize()
        return (float(lv.detach()), [t.grad for t in param_leaves(p)],
                read_counts())

    def run():
        kernel = grads(cfg)
        with plain_ctx():
            return kernel, grads(plain_cfg)

    return run


def phase_train_grads(name, cfg, plain_cfg, loss, u_norm, s, r,
                      node_block, tol=F32_TOL,
                      plain_ctx=contextlib.nullcontext) -> dict:
    """The step-1 loss gradients of ``cfg`` (kernels) against
    ``plain_cfg`` run inside ``plain_ctx`` (plain versions: no kernel
    launch but B3, which the unfused kcached path takes on a float32 K)
    from the same parameters and one graph, every parameter within
    ``tol`` of its max-abs. Returns the kernel run's launches."""
    import torch

    (lk, gk, ck), (lp, gp, cp) = step1_grads(
        cfg, plain_cfg, loss, u_norm, s, r, node_block, plain_ctx)()
    want = expected(cfg, cfg.depth, cfg.depth)
    require(ck == want, f"{name} gradient launches {ck}, expected {want}")
    require(only_b3(cp), f"{name} plain path launches {cp}")
    worst = 0.0
    for j, (a, b) in enumerate(zip(gk, gp)):
        _, rel = rel_err(a, b)
        require(rel <= tol and bool(torch.isfinite(a).all()),
                f"{name} gradient {j}: relative {rel:.3e}")
        worst = max(worst, rel)
    log(f"phase 5: {name} step-1 gradients vs plain: loss {lk:.6g} vs "
        f"{lp:.6g}, worst parameter relative max-abs err {worst:.3e} "
        f"(tol {tol:g}) over {len(gk)} parameters")
    return ck


def fp8_grad_inputs(ks):
    """The fp8 step-1 gradient check's config (uai1, bf16 compute, K in
    fp8 kind ``ks``), task, batch and parameters."""
    from graph_pde_tpu_torch.train import GKNTask

    cfg = dataclasses.replace(uai1_config(), compute_dtype="bfloat16",
                              k_storage=ks)
    arrays, batch, params = grad_inputs(cfg, "gaussian", S_GRAD1, R_GRAD1, 0)
    task = GKNTask(cfg, u_normalizer=arrays.u_normalizer, loss_type="l1",
                   use_sample_idx=False)
    return cfg, task, batch, params


def taped_grads(task, batch, params, ctx) -> dict:
    """The fused kcached path's step-1 L1 loss gradients inside ``ctx``
    (the kernels, or ``plain_on_card``): ``op_tape``'s record, the
    parameter gradients "params" and the launches "launches"."""
    import torch

    from graph_pde_tpu_torch.train import make_loss_fn
    from graph_pde_tpu_torch.train.trainer import param_leaves, trainable

    tape = {}
    p = trainable(params)
    zero_counts()
    with ctx(), op_tape(tape):
        lv, _ = make_loss_fn(task, "l1")(p, batch)
        lv.backward()
    torch.cuda.synchronize()
    tape["params"] = [t.grad for t in param_leaves(p)]
    tape["launches"] = read_counts()
    return tape


def fp32_op_gaps(a, c, batch, cfg, k8) -> list:
    """The kernel path's float32 ops against float64, relative max-abs:
    each depth step's K2 sum against (c)'s, then each backward step's
    B2-bwd dxj against K . dmsg in float64 from (c)'s dtotal."""
    import torch

    from graph_pde_tpu_torch.graph.graph import flatten_stacked

    g = flatten_stacked(batch)
    mask, w = g.edge_mask(), cfg.width
    K64 = k8.double().view(-1, w, w)
    gaps = [rel_err(a["K2"][t], c["K2"][t])[1] for t in range(cfg.depth)]
    for j in range(cfg.depth):
        dm = torch.where(mask[:, None], c["dtotal"][j].double()[g.receivers],
                         0.0)
        gaps.append(rel_err(a["dxj"][j],
                            torch.einsum("eio,eo->ei", K64, dm))[1])
    return gaps


def fp8_grad_margins(a, b, c) -> list:
    """Per parameter leaf j: (kernels-fp64, plain-fp64, kernels-plain,
    margin), relative max-abs; the check passes where every margin
    kernels-fp64 - (1.1 * plain-fp64 + FP8_GRAD_SLACK) is <= 0 and the
    kernels' gradients are finite."""
    import torch

    rows = []
    for ga, gb, gc in zip(a["params"], b["params"], c["params"]):
        ra, rp = rel_err(ga, gc)[1], rel_err(gb, gc)[1]
        margin = ra - (FP8_GRAD_FACTOR * rp + FP8_GRAD_SLACK)
        if not bool(torch.isfinite(ga).all()):
            margin = float("inf")
        rows.append((ra, rp, rel_err(ga, gb)[1], margin))
    return rows


def phase_fp8_grads(ks) -> dict:
    """Phase 5's fp8 step-1 gradient check: the uai1 (bf16 compute, fp8
    K) gradients of the kernels and of the Functions' plain versions on
    the card, each against the same function in float64 on the same fp8
    K values (``fp64_tape``). Every parameter's kernel gradient must be
    finite and no farther from float64 than 1.1 times the plain
    versions' distance plus FP8_GRAD_SLACK; the kernels' float32 ops (K2
    sums, B2-bwd dxj) within F32_TOL of float64. The kernels-plain
    distance is logged, not gated: two correct bf16 roundings of the
    kappa backward differ by about 1.2e-2 there. Returns the kernel
    run's launches."""
    from graph_pde_tpu_torch.ops.cached_contraction import to_fp8

    cfg, task, batch, params = fp8_grad_inputs(ks)
    a = taped_grads(task, batch, params, contextlib.nullcontext)
    b = taped_grads(task, batch, params, plain_on_card)
    want = expected(cfg, cfg.depth, cfg.depth)
    require(a["launches"] == want,
            f"uai1 {ks} gradient launches {a['launches']}, expected {want}")
    require(not any(b["launches"].values()), f"uai1 {ks} plain launches")
    k8 = to_fp8(a["kk"][0], ks)
    c = fp64_tape(cfg, batch, params, k8)
    gaps = fp32_op_gaps(a, c, batch, cfg, k8)
    rows = fp8_grad_margins(a, b, c)
    log(f"phase 5: uai1 {ks} step-1 float32 ops vs float64 (K2 sums, then "
        f"B2-bwd dxj): {[f'{v:.2e}' for v in gaps]} (tol {F32_TOL:g})")
    for j, (ra, rp, rab, margin) in enumerate(rows):
        log(f"phase 5: uai1 {ks} gradient {j}: kernels-fp64 {ra:.4e}, "
            f"plain-fp64 {rp:.4e}, kernels-plain {rab:.4e} (logged), "
            f"margin {margin:.3e}")
    require(max(gaps) <= F32_TOL, f"uai1 {ks} float32 ops vs float64")
    bad = [j for j, r in enumerate(rows) if r[3] > 0]
    require(not bad, f"uai1 {ks} gradients {bad} farther from float64 than "
            f"{FP8_GRAD_FACTOR} x the plain versions' + {FP8_GRAD_SLACK:g}")
    log(f"phase 5: uai1 {ks} step-1 gradients vs float64: worst "
        f"kernels-fp64 {max(r[0] for r in rows):.4e}, plain-fp64 "
        f"{max(r[1] for r in rows):.4e}, kernels-plain "
        f"{max(r[2] for r in rows):.4e}; worst margin "
        f"{max(r[3] for r in rows):.3e} over {len(rows)} parameters")
    return a["launches"]


def grad_spread(repeats: int) -> None:
    """The spread of phase 5's fp8 step-1 gradient check: for each fp8
    K kind, its per-parameter distances once under torch's deterministic
    algorithms, then its worst margin (``fp8_grad_margins``) and worst
    kernels-plain distance in ``repeats`` runs in the default mode,
    where both paths scatter with index_add_ atomics in an order that
    changes from run to run, and the runs over the criterion."""
    import warnings

    import torch

    from graph_pde_tpu_torch.ops.cached_contraction import to_fp8

    warnings.simplefilter("ignore")   # deterministic-mode notices
    for ks in FP8_KINDS:
        cfg, task, batch, params = fp8_grad_inputs(ks)

        def one():
            a = taped_grads(task, batch, params, contextlib.nullcontext)
            b = taped_grads(task, batch, params, plain_on_card)
            c = fp64_tape(cfg, batch, params, to_fp8(a["kk"][0], ks))
            gaps = fp32_op_gaps(a, c, batch, cfg, to_fp8(a["kk"][0], ks))
            return fp8_grad_margins(a, b, c), max(gaps)

        torch.use_deterministic_algorithms(True, warn_only=True)
        det, det_gap = one()
        torch.use_deterministic_algorithms(False)
        runs = [one() for _ in range(repeats)]
        over = sum(max(r[3] for r in rows) > 0 or gap > F32_TOL
                   for rows, gap in runs)
        log(f"grad spread uai1 {ks}: deterministic: kernels-fp64 "
            f"{[f'{r[0]:.3e}' for r in det]}, plain-fp64 "
            f"{[f'{r[1]:.3e}' for r in det]}, kernels-plain "
            f"{[f'{r[2]:.3e}' for r in det]}, float32 ops {det_gap:.2e}")
        log(f"grad spread uai1 {ks}: default mode worst margins "
            f"{[f'{max(r[3] for r in rows):.3e}' for rows, _ in runs]}, "
            f"worst kernels-plain "
            f"{[f'{max(r[2] for r in rows):.3e}' for rows, _ in runs]}; "
            f"{over} of {repeats} over the float64 criterion (kernels-plain "
            f"above {GRAD_BF16_TOL:g} in "
            f"{sum(max(r[2] for r in rows) > GRAD_BF16_TOL for rows, _ in runs)})")


@contextlib.contextmanager
def op_tape(tape: dict):
    """Within it, the kcached fused path records its intermediates in
    ``tape`` (name -> list, in call order): each depth step's forward
    input "x" and sum "K2", each backward step's "dtotal" and B2-bwd's
    "dxj" and "dmsg", `_outer`'s dK "dK step", the Function's "dx"
    (the index_add_ of dxj), the 6-step sum of dK on the cached K "dK
    sum" and the cached K itself "kk". It wraps whatever launches are in
    place, the kernels or (inside plain_on_card) the plain versions."""
    from graph_pde_tpu_torch.models import gkn
    from graph_pde_tpu_torch.ops import fused_iterate as fi

    Fn = fi._FusedIterateTotal
    launch, launch_bwd, outer, cached, bwd = (
        fi._launch, fi._launch_bwd, fi._outer, gkn.build_cached_k,
        Fn.backward)

    def rec(key, val):
        tape.setdefault(key, []).append(val.detach().clone())

    def k2(x, s, K, setup, i, o):
        out = launch(x, s, K, setup, i, o)
        rec("x", x)
        rec("K2", out)
        return out

    def b2(K, setup, dt, i, o):
        dxj, dmsg = launch_bwd(K, setup, dt, i, o)
        rec("dtotal", dt)
        rec("dxj", dxj)
        rec("dmsg", dmsg)
        return dxj, dmsg

    def outer_(x, senders, dmsg, dtype):
        dk = outer(x, senders, dmsg, dtype)
        rec("dK step", dk)
        return dk

    def cached_(kp, attr, **kw):
        kk = cached(kp, attr, **kw)
        rec("kk", kk)
        kk.register_hook(lambda g: rec("dK sum", g))
        return kk

    def backward(ctx, dtotal):
        grads = bwd(ctx, dtotal)
        rec("dx", grads[0])
        return grads

    fi._launch, fi._launch_bwd, fi._outer = k2, b2, outer_
    gkn.build_cached_k = cached_
    Fn.backward = staticmethod(backward)
    try:
        yield
    finally:
        fi._launch, fi._launch_bwd, fi._outer = launch, launch_bwd, outer
        gkn.build_cached_k = cached
        Fn.backward = staticmethod(bwd)


def fp64_tape(cfg, batch, params, k8) -> dict:
    """The fused kcached path's step-1 L1 loss and gradients in float64:
    the forward reads the fp8 values k8 (exact in float64) and dK lands on
    a float64 kappa of the float64 parameters (the straight-through
    estimator), with no bfloat16 rounding anywhere. Records what
    ``op_tape`` records, each backward step's B2-bwd, `_outer` and dx
    values computed in float64 from the recorded cotangent."""
    import torch

    from graph_pde_tpu_torch.data.datasets import map_arrays
    from graph_pde_tpu_torch.graph.graph import flatten_stacked
    from graph_pde_tpu_torch.ops.dense import dense_apply
    from graph_pde_tpu_torch.ops.segment import segment_counts
    from graph_pde_tpu_torch.train.trainer import param_leaves

    tape = {}

    def rec(key, val):
        tape.setdefault(key, []).append(val.detach().clone())

    p = map_arrays(lambda t: t.detach().double().requires_grad_(True),
                   params)
    g = flatten_stacked(batch)
    w, n = cfg.width, g.x.shape[0]
    mask = g.edge_mask()
    x = g.x.double() @ p["fc1"]["w"] + p["fc1"]["b"]
    kk = dense_apply(p["kernel"], g.edge_attr.double())
    kk.register_hook(lambda d: rec("dK sum", d))
    K = kk + (k8.double() - kk).detach()
    counts = segment_counts(g.receivers, mask, n)[:, None].double()
    for t in range(cfg.depth):
        rec("x", x)
        msg = torch.einsum("ei,eio->eo", x[g.senders], K.view(-1, w, w))
        total = x.new_zeros(n, w).index_add(
            0, g.receivers, torch.where(mask[:, None], msg, 0.0))
        total.register_hook(lambda d: rec("dtotal", d))
        rec("K2", total)
        x = total / counts + x @ p["root"] + p["bias"]
        if t != cfg.depth - 1 or cfg.relu_last:
            x = torch.relu(x)
    pred = x @ p["fc2"]["w"] + p["fc2"]["b"]
    node = (torch.arange(n, device=x.device) < batch.n_node[0]).double()
    loss = ((pred[:, 0] - g.y[:, 0].double()) * node).abs().sum()
    loss.backward()
    tape["params"] = [t.grad for t in param_leaves(p)]
    return tape


def kappa_bwd64(kp, attr, dk) -> list:
    """The parameter gradients of the bf16 kappa MLP, pulled back from
    ``dk`` in float64 through the activations (and ReLU pattern) of the
    bf16 forward that the kcached path runs: the backward without its
    bf16 roundings. (dW0, db0, dW1, ...)."""
    import torch

    from graph_pde_tpu_torch.ops.edge_conv import cast_params

    with torch.no_grad():
        kp = cast_params(kp, torch.bfloat16)
        h, hs, ys = attr.to(torch.bfloat16), [], []
        for layer in kp:
            hs.append(h)
            ys.append(h @ layer["w"] + layer["b"])
            h = torch.relu(ys[-1])
        dy, grads = dk.double(), []
        for j in reversed(range(len(kp))):
            grads = [hs[j].double().T @ dy, dy.sum(0)] + grads
            if j:
                dy = (dy @ kp[j]["w"].double().T) * (ys[j - 1] > 0)
    return grads


def grad_locate() -> None:
    """Locates where phase 5's e5m2 step-1 gradient check's two paths
    part: the kernels (a) and the Functions' plain versions on the card
    (b), both under deterministic algorithms, against (c), the same
    function in float64 on the same e5m2 K values (``fp64_tape``). For
    every intermediate of every depth step it logs each path's distance
    from (c), the two paths' distance from each other, and each path's
    local error: its op's output against that op computed in float64 on
    the path's own inputs. Relative max-abs throughout, as the check."""
    import warnings

    import torch

    from graph_pde_tpu_torch.graph.graph import flatten_stacked
    from graph_pde_tpu_torch.ops.cached_contraction import to_fp8

    warnings.simplefilter("ignore")   # deterministic-mode notices
    torch.use_deterministic_algorithms(True, warn_only=True)
    cfg, task, batch, params = fp8_grad_inputs("float8_e5m2")
    a = taped_grads(task, batch, params, contextlib.nullcontext)
    b = taped_grads(task, batch, params, plain_on_card)
    require(a["launches"] == expected(cfg, cfg.depth, cfg.depth),
            f"grad locate kernel launches {a['launches']}")
    require(not any(b["launches"].values()), "grad locate plain launches")
    require(torch.equal(a["kk"][0], b["kk"][0]), "both paths' cached K equal")
    k8 = to_fp8(a["kk"][0], cfg.k_storage)
    c = fp64_tape(cfg, batch, params, k8)
    g = flatten_stacked(batch)
    mask, depth, w = g.edge_mask(), cfg.depth, cfg.width
    K64 = k8.double().view(-1, w, w)
    n = g.x.shape[0]

    def dmsg64(dt):
        return torch.where(mask[:, None], dt.double()[g.receivers], 0.0)

    def outer64(x, dm):
        return (x.double()[g.senders][:, :, None]
                * dm.double()[:, None, :]).reshape(dm.shape[0], -1)

    def index_add64(v, idx):
        return torch.zeros(n, v.shape[1], dtype=torch.float64,
                           device=v.device).index_add(0, idx, v.double())

    def local(path, key, j):
        """path's op output against the op in float64 on its inputs."""
        if key == "K2":
            msg = torch.einsum("ei,eio->eo", path["x"][j].double()[g.senders],
                               K64)
            want = index_add64(torch.where(mask[:, None], msg, 0.0),
                               g.receivers)
        elif key == "dmsg":
            want = dmsg64(path["dtotal"][j])
        elif key == "dxj":
            want = torch.einsum("eio,eo->ei", K64, dmsg64(path["dtotal"][j]))
        elif key == "dK step":
            # the step's x is the forward input of step depth-1-j
            want = outer64(path["x"][depth - 1 - j], path["dmsg"][j])
        elif key == "dx":
            want = index_add64(path["dxj"][j], g.senders)
        else:
            return float("nan")
        return rel_err(path[key][j], want)[1]

    def c_value(key, t):
        """(c)'s value of step t (forward order)."""
        if key in ("x", "K2"):
            return c[key][t]
        dt = c["dtotal"][depth - 1 - t]
        if key == "dtotal":
            return dt
        dm = dmsg64(dt)
        if key == "dmsg":
            return dm
        if key == "dxj":
            return torch.einsum("eio,eo->ei", K64, dm)
        if key == "dK step":
            return outer64(c["x"][t], dm)
        return index_add64(torch.einsum("eio,eo->ei", K64, dm), g.senders)

    log("grad locate: uai1, bf16 compute, e5m2 K, s=31 r=0.2, step-1 "
        "gradients under deterministic algorithms; relative max-abs "
        "distances: a = kernels, b = plain versions on the card, c = "
        "float64; 'local' = the op against itself in float64 on the "
        "path's own inputs")
    log("grad locate: op | step | a-c | b-c | a-b | a local | b local")
    for key in ("K2", "dtotal", "dmsg", "dxj", "dK step", "dx"):
        for t in range(depth):
            j = t if key == "K2" else depth - 1 - t
            want = c_value(key, t)
            log(f"grad locate: {key} | {t} | "
                f"{rel_err(a[key][j], want)[1]:.4e} | "
                f"{rel_err(b[key][j], want)[1]:.4e} | "
                f"{rel_err(a[key][j], b[key][j])[1]:.4e} | "
                f"{local(a, key, j):.4e} | {local(b, key, j):.4e}")
    sums = [sum(path["dK step"][j].double() for j in range(depth))
            for path in (a, b)]
    log(f"grad locate: dK sum | all | "
        f"{rel_err(a['dK sum'][0], c['dK sum'][0])[1]:.4e} | "
        f"{rel_err(b['dK sum'][0], c['dK sum'][0])[1]:.4e} | "
        f"{rel_err(a['dK sum'][0], b['dK sum'][0])[1]:.4e} | "
        f"{rel_err(a['dK sum'][0], sums[0])[1]:.4e} | "
        f"{rel_err(b['dK sum'][0], sums[1])[1]:.4e}")
    # the bf16 kappa backward, local: each path's own dK sum pulled back
    # in float64 through the bf16 forward's activations
    kappa = {name: kappa_bwd64(params["kernel"], g.edge_attr,
                               path["dK sum"][0])
             for name, path in (("a", a), ("b", b))}
    names = ["fc1.w", "fc1.b"] + [
        f"kernel{i}.{t}" for i in range(len(params["kernel"]))
        for t in ("w", "b")] + ["root", "bias", "fc2.w", "fc2.b"]
    for i, name in enumerate(names):
        ga, gb, gc = a["params"][i], b["params"][i], c["params"][i]
        loc = ("", "")
        if name.startswith("kernel"):
            k = i - 2
            loc = tuple(f"{rel_err(path['params'][i], kappa[p][k])[1]:.4e}"
                        for p, path in (("a", a), ("b", b)))
        log(f"grad locate: grad {i} {name} | final | "
            f"{rel_err(ga, gc)[1]:.4e} | {rel_err(gb, gc)[1]:.4e} | "
            f"{rel_err(ga, gb)[1]:.4e} | {loc[0]} | {loc[1]}")
    torch.use_deterministic_algorithms(False)


@contextlib.contextmanager
def counted_steps(steps: list, evals: list):
    """Within it, every train step and every evaluation batch that the
    trainer's fit and evaluate run zeroes the launch counters just
    before it and appends its launches and wall time (ending in a sync)
    to ``steps`` / ``evals``; a step also its loss and the parameter
    tree it updated."""
    import torch

    from graph_pde_tpu_torch.train import trainer

    made = trainer.make_train_step, trainer.make_eval_step

    def counting(make, out):
        def make_counted(*args, **kwargs):
            step = make(*args, **kwargs)

            def counted(params, batch):
                torch.cuda.synchronize()
                zero_counts()
                t0 = time.perf_counter()
                r = step(params, batch)
                torch.cuda.synchronize()
                rec = dict(ms=(time.perf_counter() - t0) * 1e3,
                           launches=read_counts())
                if isinstance(r, dict):
                    rec.update(loss=float(r["loss"]), params=params)
                out.append(rec)
                return r
            return counted
        return make_counted

    trainer.make_train_step = counting(made[0], steps)
    trainer.make_eval_step = counting(made[1], evals)
    try:
        yield
    finally:
        trainer.make_train_step, trainer.make_eval_step = made


def cli_call(args, phase=7) -> list:
    """``graph_pde_tpu_torch.cli.main(args)`` in this process: fails
    unless it returns 0; logs (under ``phase``) and returns its standard
    output lines."""
    import io

    from graph_pde_tpu_torch import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(list(args))
    lines = buf.getvalue().splitlines()
    for line in lines:
        log(f"phase {phase}:   {line[:300]}")
    log(f"phase {phase}: cli {' '.join(args)}: exit {rc}, "
        f"{time.perf_counter() - t0:.1f} s")
    require(rc == 0, f"cli {args[0]} exit {rc}")
    return lines


def phase_cli(warm_fused_uai1_ms: float) -> dict:
    """Phase 7: the port's command line, called in this process from a
    temporary directory (its data cache and outputs go there). Trains
    uai4_full_grid_241 for one epoch of two steps at full width with a
    bundle; serves the bundle on a fresh s=241 sample read from a .mat
    file; trains uai1_full_resolution (the fused kcached path the
    runner takes, ``cli_uai1``) with its multires evaluation; lists the
    registry and runs a one-point smoke sweep. Returns each path's
    launches."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from graph_pde_tpu_torch.data import darcy_dataset
    from graph_pde_tpu_torch.experiments import names
    from graph_pde_tpu_torch.inference import GKNPredictor
    from graph_pde_tpu_torch.train import load_bundle
    from graph_pde_tpu_torch.train.trainer import param_leaves
    from graph_pde_tpu_torch.utils.matio import MatReader, write_mat

    here, tmp = os.getcwd(), tempfile.mkdtemp(prefix="chip_smoke_cli_")
    os.chdir(tmp)
    launches = {}
    try:
        cfg4 = uai4_config()
        steps, evals = [], []
        with counted_steps(steps, evals):
            cli_call(["run", "uai4_full_grid_241", "--set", "ntrain=2",
                      "--set", "ntest=1", "--set", "epochs=1",
                      "--bundle", "uai4_bundle"])
        require(len(steps) == 2 and len(evals) == 1,
                f"uai4 run: {len(steps)} steps, {len(evals)} evaluations")
        for st in steps:
            want = expected(cfg4, cfg4.depth, cfg4.depth)
            require(st["launches"] == want,
                    f"cli uai4 step launches {st['launches']}")
            require(bool(np.isfinite(st["loss"])), "cli uai4 loss finite")
        require(evals[0]["launches"] == expected(cfg4, cfg4.depth, 0),
                f"cli uai4 evaluation launches {evals[0]['launches']}")
        log(f"phase 7: uai4 run: step times (ms) "
            f"{[round(st['ms'], 1) for st in steps]}, losses "
            f"{[st['loss'] for st in steps]}, evaluation "
            f"{evals[0]['ms']:.1f} ms; launches a step {steps[0]['launches']}")
        params, mcfg, norms, extra = load_bundle("uai4_bundle")
        trained = param_leaves(steps[-1]["params"])
        require(all(torch.equal(a.detach().cpu(), b) for a, b in
                    zip(trained, param_leaves(params))),
                "the bundle's params equal the trained params bit for bit")
        launches["cli run uai4"] = {
            k: sum(r["launches"][k] for r in steps + evals) for k in COUNTED}

        fields = darcy_dataset(1, S_UAI4, seed=SEED + 11)
        write_mat("request.mat", fields)
        zero_counts()
        t0 = time.perf_counter()
        lines = cli_call(["predict", "uai4_bundle", "--input", "request.mat",
                          "--truth-field", "sol", "--output", "pred.mat"])
        torch.cuda.synchronize()
        got = read_counts()
        require(got == expected(cfg4, cfg4.depth, 0),
                f"cli predict launches {got}")
        launches["cli predict uai4"] = got
        summary = json.loads(lines[-1])
        require("rel_l2" in summary and np.isfinite(summary["rel_l2"]),
                f"cli predict summary {summary}")
        pred = MatReader("pred.mat").read_field("pred")
        require(pred.shape == (1, S_UAI4, S_UAI4)
                and bool(np.isfinite(pred).all()), "pred.mat read back")
        req = MatReader("request.mat")
        plain = GKNPredictor(
            params, dataclasses.replace(mcfg, impl="scan"),
            input_normalizers={k: norms[k] for k in
                               ("a", "a_smooth", "a_gradx", "a_grady")},
            u_normalizer=norms["u"], radius=extra["radius"]).predict(
                *[req.read_field(k) for k in
                  ("coeff", "Kcoeff", "Kcoeff_x", "Kcoeff_y")])
        _, rel = rel_err(torch.from_numpy(pred.reshape(1, -1)),
                         torch.from_numpy(plain))
        require(rel <= BF16_TOL, f"cli predict vs plain predictor {rel:.3e}")
        log(f"phase 7: predict s={S_UAI4} from a .mat file: "
            f"{time.perf_counter() - t0:.1f} s, rel-L2 {summary['rel_l2']}, "
            f"against the plain predictor (impl='scan') {rel:.3e} relative "
            f"max-abs (tol {BF16_TOL:g}); launches {got}")

        warm = cli_uai1()
        log(f"phase 7: uai1 run: warm step {warm:.1f} ms against "
            f"{warm_fused_uai1_ms:.1f} ms for phase 5's uai1 step")

        lines = cli_call(["list"])
        require(lines == names(), "cli list prints every registry name")
        lines = cli_call(["sweep", "neurips1_gkn", "--smoke", "--axis",
                          "nystrom_m=[48]"])
        point = json.loads(lines[-1])
        require(len(lines) == 1 and point["swept"] == {"nystrom_m": 48}
                and np.isfinite(point["final_test_l2"]),
                f"cli sweep point {point}")
    finally:
        os.chdir(here)
        shutil.rmtree(tmp, ignore_errors=True)
    return dict(launches=launches, uai1_warm_step_ms=warm)


def cli_uai1() -> float:
    """`cli run uai1_full_resolution` (2 samples, 1 epoch, its multires
    evaluation) inside a recording of the port's counters, from the
    current directory: each step launches K2 and B2-bwd `depth` times
    and nothing else, the evaluations K2 (s=31, 61) and B3-fwd (s=16)
    only; K2 ran and no K was lowered. Then one counted step of the
    runner's configuration on the s=61 graph: K is float32, E_pad *
    4096 * 4 bytes. Returns the run's warm step in ms."""
    import numpy as np
    import torch

    from graph_pde_tpu_torch.data.datasets import map_arrays
    from graph_pde_tpu_torch.experiments import get
    from graph_pde_tpu_torch.experiments import runners as trun
    from graph_pde_tpu_torch.models import gkn_init
    from graph_pde_tpu_torch.train import GKNTask, make_loss_fn
    from graph_pde_tpu_torch.train.trainer import trainable
    from graph_pde_tpu_torch.utils import tracing

    steps, evals = [], []
    with tracing.recording() as rec, counted_steps(steps, evals):
        lines = cli_call(["run", "uai1_full_resolution", "--set",
                          "ntrain=2", "--set", "ntest=1", "--set",
                          "epochs=1"])
    mcfg = trun._gkn_config(get("uai1_full_resolution"))
    require(mcfg.kcached_fused == "auto", f"runner's uai1 config {mcfg}")
    for st in steps:
        require(st["launches"] == expected(mcfg, mcfg.depth, mcfg.depth),
                f"cli uai1 step launches {st['launches']}")
    for ev in evals:
        require(not any(v for k, v in ev["launches"].items()
                        if k not in ("K2", "B3-fwd")),
                f"cli uai1 evaluation launches {ev['launches']}")
    require(len(steps) == 2 and len(evals) == 4,
            f"uai1 run: {len(steps)} steps, {len(evals)} evaluations")
    c = rec.counters
    require(c.get("iterate_k2", 0) > 0 and not c.get("k_lowered"),
            f"cli uai1 run counters {c}")
    result = json.loads(lines[-1])
    require(all(np.isfinite(v) for v in result["multires"].values())
            and sorted(map(int, result["multires"])) == [16, 31, 61],
            f"uai1 multires {result.get('multires')}")
    log(f"phase 7: uai1 run (the runner's kcached_fused='auto'): step "
        f"times (ms) {[round(st['ms'], 1) for st in steps]}, launches a "
        f"step {steps[-1]['launches']}, evaluations "
        f"{[ev['launches'] for ev in evals]}; counters {c}; multires "
        f"{result['multires']}")

    dev = torch.device("cuda")
    arrays, graphs = training_data(1, S_UAI1, R_UAI1, "gaussian", 0, SEED)
    batch = map_arrays(lambda a: a[:1], graphs.to(dev))
    params = trainable(gkn_init(torch.Generator().manual_seed(SEED), mcfg,
                                device=dev))
    task = GKNTask(mcfg, u_normalizer=arrays.u_normalizer, loss_type="l1")
    e = graphs.senders.shape[1]
    zero_counts()
    with tracing.recording() as rec:
        lv, _ = make_loss_fn(task, "l1")(params, batch)
        lv.backward()
    torch.cuda.synchronize()
    c, got = rec.counters, read_counts()
    require(c.get("k_bytes") == e * 4096 * 4 and not c.get("k_lowered")
            and c.get("iterate_k2") == mcfg.depth
            and got == expected(mcfg, mcfg.depth, mcfg.depth),
            f"uai1 step counters {c}, launches {got}")
    log(f"phase 7: uai1 step at s={S_UAI1} (E_pad {e}): counters {c} "
        f"(float32 K, {e * 4096 * 4 / 2 ** 30:.3f} GiB)")
    return steps[-1]["ms"]


def uai1_turns() -> dict:
    """The runner's uai1 step (fused: K2, B2-bwd) and the unfused kcached
    step (kcached_fused='off': B3 on the same float32 K) on the full
    s=61 graph, in turns (fused, unfused, unfused, fused), each timed
    warm over 3 steps, with its peak device memory."""
    import torch

    from graph_pde_tpu_torch.data.datasets import map_arrays
    from graph_pde_tpu_torch.experiments import get
    from graph_pde_tpu_torch.experiments import runners as trun
    from graph_pde_tpu_torch.models import gkn_init
    from graph_pde_tpu_torch.train import (GKNTask, adam_steplr,
                                           make_train_step)
    from graph_pde_tpu_torch.train.trainer import param_leaves, trainable

    dev = torch.device("cuda")
    fused = trun._gkn_config(get("uai1_full_resolution"))
    paths = {"fused": fused,
             "unfused": dataclasses.replace(fused, kcached_fused="off")}
    arrays, graphs = training_data(N_TRAIN, S_UAI1, R_UAI1, "gaussian", 0,
                                   SEED + 1)
    batch = map_arrays(lambda a: a[:1], graphs.to(dev))
    init = gkn_init(torch.Generator().manual_seed(SEED), fused, device=dev)
    times, peaks, launches = {k: [] for k in paths}, {}, {}
    for which in ("fused", "unfused", "unfused", "fused"):
        cfg = paths[which]
        params = trainable(init)
        opt, _ = adam_steplr(param_leaves(params), 1e-4, weight_decay=5e-4)
        step = make_train_step(GKNTask(cfg, u_normalizer=arrays.u_normalizer,
                                       loss_type="l1"), opt)
        torch.cuda.reset_peak_memory_stats()
        step(params, batch)
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        for _ in range(3):
            step(params, batch)
        torch.cuda.synchronize()
        times[which].append((time.perf_counter() - t0) * 1e3 / 3)
        peaks[which] = torch.cuda.max_memory_allocated() / 2 ** 30
        launches[which] = {k: v // 3 for k, v in read_counts().items() if v}
        del params, opt, step
        torch.cuda.empty_cache()
    require(launches["fused"] == {k: v for k, v in expected(
        fused, fused.depth, fused.depth).items() if v},
        f"uai1 fused launches {launches['fused']}")
    require(launches["unfused"] == {"B3-fwd": fused.depth,
                                    "B3-bwd": fused.depth},
            f"uai1 unfused launches {launches['unfused']}")
    out = {f"warm_step_{k}_ms": sum(v) / len(v) for k, v in times.items()}
    out.update({f"peak_{k}_gib": v for k, v in peaks.items()},
               turns=times, launches=launches)
    log(f"uai1 turns (s={S_UAI1}, E_pad {graphs.senders.shape[1]}, float32 "
        f"K): " + json.dumps(out))
    return out


def profile_kernels(name, fn, phase=6, reps=1) -> list:
    """Device time of each CUDA kernel in ``reps`` calls of ``fn``, from
    a torch.profiler trace (written under results/), logged and returned
    as ``kernel_rows``. Calls of a few microseconds want several: late in
    a run, the profile of such a call loses launches."""
    import torch

    from graph_pde_tpu_torch.train import profile_trace

    with profile_trace(f"results/profile_{name}") as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = kernel_rows(prof)
    for ms, count, key in rows:
        log(f"phase {phase}: {name} profile: {key[:60]}: {ms:.3f} ms x "
            f"{count}")
    return rows


# B1-bwd's tensor-core kernels, by the names the benchmark's
# b1_bwd_roofline.train reads, and their launches a call (reduce: dWl's
# and dbl's)
B1_TC_KERNELS = (("dx_dh", re.compile(r"tc::dx_dh_kernel"), 1),
                 ("dw", re.compile(r"tc::dw_kernel"), 1),
                 ("reduce",
                  re.compile(r"^\(anonymous namespace\)::reduce_kernel"), 2))


def b1_bwd_tc_kernels_ms(rows) -> dict:
    """Device ms a call of each of B1-bwd's tensor-core kernels, from the
    rows ``profile_kernels`` returns: its mean launch times its launches
    a call, so that a profile that lost launches still reads true (None:
    no launch of it in the profile)."""
    out = {}
    for name, pat, per_call in B1_TC_KERNELS:
        hit = [(ms, count) for ms, count, key in rows if pat.search(key)]
        n = sum(count for _, count in hit)
        out[name] = per_call * sum(ms for ms, _ in hit) / n if n else None
    return out


def kernel_rows(prof) -> list:
    """(device ms, count, name) of every kernel in a profile, largest
    first. A kernel's row has device time and no CPU time of its own;
    the CPU ops that launched it, which carry its device time too, are
    left out so that nothing counts twice."""
    rows = []
    for evt in prof.key_averages():
        us = getattr(evt, "device_time_total", None)
        if us is None:
            us = getattr(evt, "cuda_time_total", 0.0)
        if us > 0 and evt.self_cpu_time_total == 0:
            rows.append((us / 1e3, evt.count, evt.key))
    return sorted(rows, reverse=True)


def b1_bwd_simt(x, s, h2, g, wl, w, dt):
    """B1-bwd's SIMT form on any shape and compute dtype, launched past
    the wrapper's choice of form: the design the bf16 tensor-core form
    replaced on the uai4 path, timed beside it."""
    import torch

    from graph_pde_tpu_torch.ops import fused_edge_conv as fe
    from graph_pde_tpu_torch.ops import kernels

    e, kw = h2.shape
    c = w * w
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    splits, dbl_splits = fe.bwd_splits(e, kw, c, sms)
    _, x_per, hs, depth = fe.b1_bwd_simt_grid(e, kw, w, w, sms)
    new = lambda *sh: torch.zeros(sh, dtype=torch.float32, device=x.device)
    outs = (new(e, w), new(e, kw), new(kw, c), new(c), new(splits, kw, c),
            new(dbl_splits, c), new(hs, e, kw) if hs > 1 else None)
    fn = kernels.fn("fused_edge_conv_bwd", "gpde_edge_messages_bwd",
                    fe._BWD_ARGS)
    stream = torch.cuda.current_stream().cuda_stream
    kernels.check(fn(*[t.data_ptr() for t in (h2, x, s, g, wl, *outs[:6])],
                     None if outs[6] is None else outs[6].data_ptr(), e, kw,
                     w, w, splits, dbl_splits, x_per, depth,
                     int(dt == "bfloat16"), stream), "B1-bwd SIMT form")
    return outs[:4]


def b2_bwd_general(K, setup, dtotal, w):
    """B2-bwd's block-per-edge form, launched past the wrapper's choice
    of form: the design the warp form replaced, timed beside it."""
    import torch

    from graph_pde_tpu_torch.ops import fused_iterate as fi
    from graph_pde_tpu_torch.ops import kernels

    e = K.shape[0]
    dxj = torch.empty((e, w), dtype=torch.float32, device=K.device)
    dmsg = torch.empty((e, w), dtype=torch.float32, device=K.device)
    fn = kernels.fn("fused_iterate_bwd", "gpde_iterate_bwd_general",
                    fi._ARGS)
    stream = torch.cuda.current_stream().cuda_stream
    kernels.check(fn(*[t.data_ptr() for t in (K, setup.mask,
                                              setup.receivers, dtotal, dxj,
                                              dmsg)],
                     e, w, w, fi._K_KIND[K.dtype], stream),
                  "B2-bwd block form")
    return dxj, dmsg


def backward_times(g4, kp4, g1, kp1) -> dict:
    """K1 in bf16 (its tensor-core form, beside its SIMT form on the same
    inputs) and B1-bwd (bf16, the uai4 training dtype, and float32) at
    the full uai4 s=241 graph, and B2-bwd (bf16 K) at the full uai1 s=61
    graph: kernel, plain and library times, operations, bytes."""
    import torch

    from graph_pde_tpu_torch.ops.kcached_loop import build_cached_k
    from graph_pde_tpu_torch.ops.dense import dense_apply
    from graph_pde_tpu_torch.ops.fused_edge_conv import (
        edge_messages_bwd_plain, edge_messages_plain, fused_edge_messages,
        fused_edge_messages_bwd, simt_edge_messages)
    from graph_pde_tpu_torch.ops.fused_iterate import (
        fused_iterate_bwd, fused_iterate_bwd_plain, sorted_iterate_setup)

    dev = g4.x.device
    gen = torch.Generator().manual_seed(SEED + 6)
    rec = {}
    with torch.inference_mode():
        e, n = g4.senders.shape[0], g4.x.shape[0]
        wl = kp4[-1]["w"]
        kw, c = wl.shape
        x = torch.randn(n, 64, generator=gen).to(dev)
        s, a = g4.senders, g4.edge_attr
        kw_args = dict(in_channels=64, out_channels=64,
                       compute_dtype="bfloat16")
        k1 = lambda: fused_edge_messages(x, s, a, kp4, **kw_args)
        old = lambda: simt_edge_messages(x, s, a, kp4, in_channels=64,
                                         compute_dtype="bfloat16")
        # in turns (new, old, old, new)
        turns = [time_ms(k1, 3), time_ms(old, 1), time_ms(old, 1),
                 time_ms(k1, 3)]
        rec["K1 bf16"] = dict(
            ms=(turns[0] + turns[3]) / 2, ms_turns=turns,
            previous_form_ms=(turns[1] + turns[2]) / 2,
            plain_ms=time_ms(lambda: edge_messages_plain(x, s, a, kp4,
                                                         **kw_args), 1),
            library_ms=None, shape=f"E={e}, kappa (6, 128, 256, 4096), bf16",
            **k1_cost(kp4, e, n, tc=True))
        h2 = dense_apply(kp4[:-1], g4.edge_attr, out_nonlinearity=torch.relu)
        gg = torch.randn(e, 64, generator=gen).to(dev)
        # three products of E*kw*C multiply-adds, plus dpre, the dx fold
        # and dbl (3 per element of [E, C]); every input read once and
        # every output written once
        prods, elems = 6.0 * e * kw * c, 3.0 * e * c
        nbytes = (4 * (e * kw + n * 64 + e * 64 + kw * c) + 8 * e
                  + 4 * (e * 64 + e * kw + kw * c + c))
        for dt in ("bfloat16", None):
            kw_args = dict(in_channels=64, out_channels=64, compute_dtype=dt)
            b1 = lambda: fused_edge_messages_bwd(x, g4.senders, h2, gg, wl,
                                                 **kw_args)
            b1p = lambda: edge_messages_bwd_plain(x, g4.senders, h2, gg,
                                                  wl, **kw_args)
            # bf16 mode: the products' operands are bf16, so their peak
            # is the bf16 tensor-core rate, whatever units the kernel uses
            ops = (dict(bf16_flops=prods, flops=elems) if dt
                   else dict(flops=prods + elems))
            key = "B1-bwd" if dt else "B1-bwd float32"
            rec[key] = dict(ms=time_ms(b1, 3), plain_ms=time_ms(b1p, 1),
                            library_ms=None, bytes=nbytes,
                            shape=f"E={e}, kw={kw}, C={c}, {dt or 'float32'}",
                            **ops)
            if dt:
                # the replaced design on the same inputs, in turns with
                # the new one (new, old, old, new)
                old = lambda: b1_bwd_simt(x, g4.senders, h2, gg, wl, 64, dt)
                t_old = [time_ms(old, 1), time_ms(old, 1)]
                turns = [rec[key]["ms"], *t_old, time_ms(b1, 3)]
                rows = profile_kernels("B1-bwd", b1)
                rec[key].update(ms=(turns[0] + turns[3]) / 2, ms_turns=turns,
                                previous_form_ms=sum(t_old) / 2,
                                kernels_ms=b1_bwd_tc_kernels_ms(rows))
        del h2
        e1, n1 = g1.senders.shape[0], g1.x.shape[0]
        mask = g1.edge_mask()
        valid = int(mask.sum())
        K = build_cached_k(kp1, g1.edge_attr, k_dtype=torch.bfloat16)
        setup = sorted_iterate_setup(g1.receivers, mask, n1)
        dt = torch.randn(n1, 64, generator=gen).to(dev)
        b2 = lambda: fused_iterate_bwd(K, setup, dt, in_channels=64,
                                       out_channels=64)
        b2p = lambda: fused_iterate_bwd_plain(K, setup, dt, in_channels=64,
                                              out_channels=64)
        kv = K.view(e1, 64, 64)
        dm = b2p()[1].to(torch.bfloat16)[:, :, None]
        lib = lambda: torch.bmm(kv, dm)
        # K read for the valid edges only (a masked edge reads none)
        old = lambda: b2_bwd_general(K, setup, dt, 64)
        turns = [time_ms(b2, 5), time_ms(lib, 5), time_ms(old, 5),
                 time_ms(old, 5), time_ms(lib, 5), time_ms(b2, 5)]
        rec["B2-bwd"] = dict(
            ms=(turns[0] + turns[5]) / 2, plain_ms=time_ms(b2p, 2),
            library_ms=(turns[1] + turns[4]) / 2,
            previous_form_ms=(turns[2] + turns[3]) / 2,
            ms_turns=turns, flops=2.0 * valid * 64 * 64,
            bytes=2 * valid * 64 * 64 + 9 * e1 + 4 * n1 * 64
            + 4 * e1 * 64 * 2,
            shape=f"E={e1} ({valid} valid), C=4096, bf16 K")
        del K, kv, dm
    for name, r in rec.items():
        set_bound(r)
        log(f"phase 6: {name} ({r['shape']}): {r['ms']:.3f} ms, plain "
            f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms "
            f"({r['bound_by']}), library {r['library_ms']}, previous form "
            f"{r.get('previous_form_ms')} ms, turns {r.get('ms_turns')}, "
            f"kernels {r.get('kernels_ms')}")
    return rec


FP8_KINDS = ("float8_e4m3", "float8_e5m2")


def b3_operands(g1, kp1, k_dtype, w=64):
    """B3's operands on the uai1 s=61 graph: at w=64 all E_pad edges, the
    uai1 kappa's cached K and x, g from a seed; at other widths a seeded
    (6, 32, w*w) kappa on the first GENERAL_SLICE edges."""
    import torch

    from graph_pde_tpu_torch.ops.kcached_loop import build_cached_k
    from graph_pde_tpu_torch.ops.dense import dense_apply, dense_init

    dev = g1.x.device
    gen = torch.Generator().manual_seed(SEED + 9 + w)
    if w == 64:
        K = build_cached_k(kp1, g1.edge_attr, k_dtype=k_dtype)
    else:
        kp = dense_init(gen, (6, 32, w * w), device=dev)
        K = dense_apply(kp, g1.edge_attr[:GENERAL_SLICE]).to(k_dtype)
    e = K.shape[0]
    x = torch.randn(e, w, generator=gen).to(dev)
    g = torch.randn(e, w, generator=gen).to(dev)
    return x, K, g


def phase_b3_vs_plain(g1, kp1) -> dict:
    """B3-fwd and B3-bwd against their plain versions, K in fp32 and
    bf16: at the uai1 full-graph shape (w 64) and at w 12 (the general
    form) and w 128 (two column chunks)."""
    import torch

    from graph_pde_tpu_torch.ops.cached_contraction import (
        cached_contraction, cached_contraction_bwd,
        cached_contraction_bwd_plain, cached_contraction_plain)

    errs = {}
    with torch.inference_mode():
        for w in (64, 12, 128):
            for k_dtype in (torch.float32, torch.bfloat16):
                x, K, g = b3_operands(g1, kp1, k_dtype, w)
                kw = dict(in_channels=w, out_channels=w)
                tag = f"w {w} E {K.shape[0]} K={str(k_dtype).split('.')[-1]}"
                got = cached_contraction(x, K, **kw)
                want = cached_contraction_plain(x, K, **kw)
                torch.cuda.synchronize()
                ab, rel = rel_err(got, want)
                log(f"phase 2: B3-fwd {tag}: max-abs err {ab:.3e}, "
                    f"relative {rel:.3e} (tol {F32_TOL:g})")
                require(rel <= F32_TOL and bool(torch.isfinite(got).all()),
                        f"B3-fwd {tag}")
                del got, want
                dx, dk = cached_contraction_bwd(x, K, g, **kw)
                wdx, wdk = cached_contraction_bwd_plain(x, K, g, **kw)
                torch.cuda.synchronize()
                worst = 0.0
                for out, a, b in (("dx", dx, wdx), ("dK", dk, wdk)):
                    ab_o, rel_o = rel_err(a, b)
                    log(f"phase 2: B3-bwd {tag} {out}: max-abs err "
                        f"{ab_o:.3e}, relative {rel_o:.3e} (tol {F32_TOL:g})"
                        + (f", bit-equal {bool(torch.equal(a, b))}"
                           if out == "dK" else ""))
                    require(rel_o <= F32_TOL
                            and bool(torch.isfinite(a.float()).all()),
                            f"B3-bwd {tag} {out}")
                    worst = max(worst, ab_o)
                if w == 64:
                    dt = str(k_dtype).split(".")[-1]
                    errs[f"B3-fwd {dt}"], errs[f"B3-bwd {dt}"] = ab, worst
                del x, K, g, dx, dk, wdx, wdk
                torch.cuda.empty_cache()
    return errs


def fp8_operands(g1, kp1, name):
    """The k8 stream of the uai1 s=61 graph (its kappa's bf16 cached K
    rounded to fp8), its iteration setup, x and dtotal from a seed."""
    import torch

    from graph_pde_tpu_torch.ops.kcached_loop import build_cached_k
    from graph_pde_tpu_torch.ops.cached_contraction import to_fp8
    from graph_pde_tpu_torch.ops.fused_iterate import sorted_iterate_setup

    dev = g1.x.device
    gen = torch.Generator().manual_seed(SEED + 10)
    n1 = g1.x.shape[0]
    K = build_cached_k(kp1, g1.edge_attr, k_dtype=torch.bfloat16)
    k8 = to_fp8(K, name)
    setup = sorted_iterate_setup(g1.receivers, g1.edge_mask(), n1)
    x = torch.randn(n1, 64, generator=gen).to(dev)
    dt = torch.randn(n1, 64, generator=gen).to(dev)
    return K, k8, setup, x, dt


def phase_fp8_vs_plain(g1, kp1) -> dict:
    """K2 and B2-bwd reading the e4m3 and the e5m2 k8 stream of the full
    uai1 s=61 graph, against their plain versions on the same k8."""
    import torch

    from graph_pde_tpu_torch.ops.fused_iterate import (
        fused_iterate_total, fused_iterate_total_plain)

    errs = {}
    with torch.inference_mode():
        for name in FP8_KINDS:
            K, k8, setup, x, dt = fp8_operands(g1, kp1, name)
            kind = name.split("_")[1]
            require(not bool(torch.isnan(k8.float()).any()),
                    f"{name} K has no overflow")
            got = fused_iterate_total(x, g1.senders, K, setup,
                                      in_channels=64, out_channels=64, k8=k8)
            want = fused_iterate_total_plain(x, g1.senders, k8, setup,
                                             in_channels=64, out_channels=64)
            torch.cuda.synchronize()
            ab, rel = rel_err(got, want)
            log(f"phase 2: K2 {kind} (uai1 s={S_UAI1}, E {K.shape[0]}): "
                f"max-abs err {ab:.3e}, relative {rel:.3e} "
                f"(tol {F32_TOL:g})")
            require(rel <= F32_TOL and bool(torch.isfinite(got).all()),
                    f"K2 {kind}")
            errs[f"K2 {kind}"] = ab
            errs[f"B2-bwd {kind}"] = check_b2_bwd(
                f"B2-bwd {kind} (uai1 s={S_UAI1})", k8, setup, dt, 64)
            del K, k8
    return errs


def phase_b3_op(g1, kp1) -> dict:
    """The B3 op's own path: cached_contraction forward and backward
    through autograd at the uai1 full-graph shape, once with K in fp32
    and once in bf16, every counter zeroed just before and read just
    after. Each must launch B3-fwd and B3-bwd once and nothing else, and
    give finite outputs and gradients of the right shapes and dtypes."""
    import torch

    from graph_pde_tpu_torch.ops.cached_contraction import cached_contraction

    launches = {}
    for k_dtype in (torch.float32, torch.bfloat16):
        x, K, g = b3_operands(g1, kp1, k_dtype)
        x.requires_grad_(True)
        K.requires_grad_(True)
        path = f"B3 op, K {str(k_dtype).split('.')[-1]}"
        zero_counts()
        t0 = time.perf_counter()
        msg = cached_contraction(x, K, in_channels=64, out_channels=64)
        (msg * g).sum().backward()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = read_counts()
        launches[path] = got
        want = {k: 1 if k in ("B3-fwd", "B3-bwd") else 0 for k in COUNTED}
        log(f"phase 3: {path}: forward + backward {dt * 1e3:.1f} ms, "
            f"launches {got}")
        require(got == want, f"{path}: launches {got}, expected {want}")
        require(msg.shape == (K.shape[0], 64) and x.grad.shape == x.shape
                and K.grad.dtype == k_dtype
                and bool(torch.isfinite(msg).all())
                and bool(torch.isfinite(x.grad).all())
                and bool(torch.isfinite(K.grad.float()).all()),
                f"{path} outputs")
        del x, K, g, msg
        torch.cuda.empty_cache()
    return launches


# The benchmark's MGKN cells that contract through B3 (kcached, float32
# K, 64 x 64): ortho1024_train at batch 20, depth 4; mgkn85_train at
# batch 1, depth 5.
B3_CELLS = (("ortho1024_train", 20, 4), ("mgkn85_train", 1, 5))


def b3_cell_edges() -> dict:
    """cell -> [(conv, edges)] of each kcached conv of the cells in
    B3_CELLS at their batch: the orthogonal model's ten edge lists of
    one s=1024 sample (multi_pole_grid1d, periodic) times 20, and the
    general MGKN's seven conv ranges of one s=85 sample (padding
    included, as the model runs them)."""
    import numpy as np

    from graph_pde_tpu_torch.graph.multipole import multi_pole_grid1d

    theta = np.random.default_rng(SEED).normal(size=(1, S_ORTHO, 1))
    _, _, edges = multi_pole_grid1d(theta.astype(np.float32), 1, S_ORTHO,
                                    1, is_periodic=True)
    (_, batch, _), _ = B3_CELLS
    out = {"ortho1024_train": [(f"list {idx}", batch * e.shape[1])
                               for idx, e in enumerate(edges)]}
    _, _, graphs = mgkn_graphs("mgkn_general_darcy2d", 1)
    cfg = mgkn_config(impl="kcached")
    out["mgkn85_train"] = [
        (f"{kind} l={l}", int(np.diff(getattr(graphs, f"{kind}_ranges")[l])))
        for kind, l, _ in mgkn_convs(cfg)]
    return out


def b3_cells() -> dict:
    """B3-fwd and B3-bwd (float32 K, 64 x 64) at every kcached conv of
    the cells in B3_CELLS (x, K, g from a seed), each beside its bytes'
    bound and the plain path it replaced on the card
    (apply_cached_kernel_plain's broadcast multiply-and-sum, forward
    alone and forward + autograd backward to dx and dK), and each
    cell's totals a step (every conv `depth` times). K of the coarse
    lists fits in the 50 MB L2, so their times are warm and their
    launches latency-bound."""
    import torch

    from graph_pde_tpu_torch.ops.cached_contraction import (
        apply_cached_kernel_plain, cached_contraction, cached_contraction_bwd)

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 19)
    kw = dict(in_channels=64, out_channels=64)
    depth = {cell: d for cell, _, d in B3_CELLS}
    out = {}
    for cell, convs in b3_cell_edges().items():
        rows, tot = [], dict.fromkeys(
            ("fwd_ms", "bwd_ms", "fwd_bound_ms", "bwd_bound_ms",
             "plain_fwd_ms", "plain_fwd_bwd_ms"), 0.0)
        for conv, e in convs:
            x = torch.randn(e, 64, generator=gen).to(dev)
            K = torch.randn(e, 64 * 64, generator=gen).to(dev)
            g = torch.randn(e, 64, generator=gen).to(dev)
            xr, kr = x.clone().requires_grad_(True), K.clone() \
                .requires_grad_(True)

            def plain_fwd_bwd():
                xr.grad = kr.grad = None
                apply_cached_kernel_plain(xr, kr, 64, 64).backward(g)

            with torch.no_grad():
                r = dict(conv=conv, edges=e,
                         fwd_ms=time_ms(lambda: cached_contraction(x, K,
                                                                   **kw), 10),
                         bwd_ms=time_ms(lambda: cached_contraction_bwd(
                             x, K, g, **kw), 10),
                         plain_fwd_ms=time_ms(lambda: apply_cached_kernel_plain(
                             x, K, 64, 64), 3))
            r["plain_fwd_bwd_ms"] = time_ms(plain_fwd_bwd, 3)
            c = 64 * 64
            r["fwd_bound_ms"] = (4 * e * c + 4 * e * 64 * 2) / PEAK_BYTES * 1e3
            r["bwd_bound_ms"] = (8 * e * c + 4 * e * 64 * 3) / PEAK_BYTES * 1e3
            for k in tot:
                tot[k] += depth[cell] * r[k]
            log(f"b3 {cell} {conv}: E {e}, B3-fwd {r['fwd_ms']:.4f} ms "
                f"(bound {r['fwd_bound_ms']:.4f}), B3-bwd {r['bwd_ms']:.4f} "
                f"ms (bound {r['bwd_bound_ms']:.4f}); plain forward "
                f"{r['plain_fwd_ms']:.4f} ms, forward + backward "
                f"{r['plain_fwd_bwd_ms']:.4f} ms")
            rows.append(r)
            del x, K, g, xr, kr
            torch.cuda.empty_cache()
        log(f"b3 {cell}: a step (each conv {depth[cell]} times) B3-fwd "
            f"{tot['fwd_ms']:.3f} ms + B3-bwd {tot['bwd_ms']:.3f} ms against "
            f"bounds {tot['fwd_bound_ms']:.3f} + {tot['bwd_bound_ms']:.3f}; "
            f"the plain path {tot['plain_fwd_bwd_ms']:.3f} ms (forward "
            f"{tot['plain_fwd_ms']:.3f})")
        out[cell] = dict(convs=rows, step=tot)
    return out


def b3_fp8_times(g1, kp1) -> dict:
    """B3-fwd and B3-bwd (fp32 and bf16 K) at the uai1 full-graph shape,
    and K2 and B2-bwd on the e4m3 and e5m2 k8 streams of the full uai1
    graph (beside K2 and B2-bwd on its bf16 K): kernel, plain and library
    times, operations and bytes."""
    import torch

    from graph_pde_tpu_torch.ops.cached_contraction import (
        cached_contraction, cached_contraction_bwd,
        cached_contraction_bwd_plain, cached_contraction_plain)
    from graph_pde_tpu_torch.ops.fused_iterate import (
        fused_iterate_bwd, fused_iterate_bwd_plain, fused_iterate_total,
        fused_iterate_total_plain)

    rec = {}
    kw = dict(in_channels=64, out_channels=64)
    with torch.inference_mode():
        for k_dtype in (torch.float32, torch.bfloat16):
            dt = str(k_dtype).split(".")[-1]
            x, K, g = b3_operands(g1, kp1, k_dtype)
            e, c = K.shape
            kb = K.element_size()
            lib, note = None, ("no single PyTorch call multiplies float32 "
                               "x with bf16 K without rounding x")
            if k_dtype == torch.float32:
                kv, xv = K.view(e, 64, 64), x.view(e, 1, 64)
                lib, note = time_ms(lambda: torch.bmm(xv, kv), 5), (
                    "torch.bmm of x [E,1,64] with K [E,64,64]")
            rec[f"B3-fwd {dt}"] = dict(
                ms=time_ms(lambda: cached_contraction(x, K, **kw), 5),
                plain_ms=time_ms(lambda: cached_contraction_plain(x, K, **kw),
                                 1),
                library_ms=lib, library_note=note, flops=2.0 * e * c,
                bytes=kb * e * c + 4 * e * 64 * 2,
                shape=f"E={e}, 64 x 64, {dt} K")
            rec[f"B3-bwd {dt}"] = dict(
                ms=time_ms(lambda: cached_contraction_bwd(x, K, g, **kw), 5),
                plain_ms=time_ms(
                    lambda: cached_contraction_bwd_plain(x, K, g, **kw), 1),
                library_ms=None, library_note=(
                    "no single PyTorch call gives both dx and dK"),
                flops=3.0 * e * c, bytes=2 * kb * e * c + 4 * e * 64 * 3,
                shape=f"E={e}, 64 x 64, {dt} K")
            del x, K, g
            torch.cuda.empty_cache()
        n1 = g1.x.shape[0]
        e1 = g1.senders.shape[0]
        valid = int(g1.edge_mask().sum())
        for name in FP8_KINDS:
            K, k8, setup, x, dt = fp8_operands(g1, kp1, name)
            kind = name.split("_")[1]
            streams = [(f"K2 {kind}", f"B2-bwd {kind}", k8)]
            if name == FP8_KINDS[0]:
                streams.append(("K2 uai1 bfloat16", "B2-bwd uai1 bfloat16",
                                K))
            for k2_key, b2_key, stream in streams:
                kb = stream.element_size()
                k8a = stream if stream.dtype != K.dtype else None
                rec[k2_key] = dict(
                    ms=time_ms(lambda: fused_iterate_total(
                        x, g1.senders, K, setup, k8=k8a, **kw), 5),
                    plain_ms=time_ms(lambda: fused_iterate_total_plain(
                        x, g1.senders, stream, setup, **kw), 1),
                    library_ms=None, library_note=(
                        "no PyTorch sparse or batched product reads fp8"
                        if k8a is not None else "not timed here"),
                    flops=2.0 * valid * 4096,
                    bytes=(kb * valid * 4096 + 9 * e1 + 4 * n1 * 64
                           + 8 * (n1 + 1) + 4 * n1 * 64),
                    shape=f"E={e1} ({valid} valid), C=4096, {stream.dtype} K")
                rec[b2_key] = dict(
                    previous_form_ms=time_ms(lambda: b2_bwd_general(
                        stream, setup, dt, 64), 5),
                    ms=time_ms(lambda: fused_iterate_bwd(stream, setup, dt,
                                                         **kw), 5),
                    plain_ms=time_ms(lambda: fused_iterate_bwd_plain(
                        stream, setup, dt, **kw), 1),
                    library_ms=None, library_note=(
                        "torch.bmm takes no fp8 operand"
                        if k8a is not None else "not timed here"),
                    flops=2.0 * valid * 4096,
                    bytes=(kb * valid * 4096 + 9 * e1 + 4 * n1 * 64
                           + 4 * e1 * 64 * 2),
                    shape=f"E={e1} ({valid} valid), C=4096, {stream.dtype} K")
            del K, k8
    for name, r in rec.items():
        set_bound(r)
        log(f"phase 6: {name} ({r['shape']}): {r['ms']:.3f} ms, plain "
            f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms "
            f"({r['bound_by']}), library {r['library_ms']} "
            f"({r['library_note']}), previous form "
            f"{r.get('previous_form_ms')} ms")
    return rec


def ortho_config(impl="auto"):
    from graph_pde_tpu_torch.models import MGKNOrthogonalConfig

    return MGKNOrthogonalConfig(width=64, ker_width=1024, depth=4, ker_in=4,
                                in_width=2, s=S_ORTHO, impl=impl)


def expected_ortho(cfg, n_fwd: int, n_bwd: int) -> dict:
    """The counts of n_fwd forwards and n_bwd backwards of the
    orthogonal model: under impl='auto' each of the 10 level convs
    launches K1 `depth` times a forward in the form its kappa takes, and
    B1-bwd `depth` times a backward; under impl='kcached' each conv
    contracts its float32 K through B3-fwd `depth` times a forward and
    B3-bwd `depth` times a backward (a bf16 K: no launch)."""
    from graph_pde_tpu_torch.models.mgkn_orthogonal import level_kernel_width
    from graph_pde_tpu_torch.ops.fused_edge_conv import b1_bwd_form, k1_form

    counts = dict.fromkeys(COUNTED, 0)
    if cfg.impl == "kcached":
        if cfg.compute_dtype is None:
            uses = (cfg.level + 1) * cfg.depth
            counts["B3-fwd"], counts["B3-bwd"] = n_fwd * uses, n_bwd * uses
        return counts
    w = cfg.width
    for idx in range(cfg.level + 1):
        kw = level_kernel_width(cfg, idx)
        dims = ((cfg.ker_in, kw), (kw, kw), (kw, w * w))
        form = k1_form(dims, w, w, cfg.compute_dtype)
        bwd = b1_bwd_form(kw, w, w, cfg.compute_dtype)
        for key, n in (("K1", n_fwd), (f"K1 {form}", n_fwd),
                       ("B1-bwd", n_bwd), (f"B1-bwd {bwd}", n_bwd)):
            counts[key] += n * cfg.depth
    return counts


def ortho_graphs(n):
    """The first n synthetic Burgers samples of the registry's data
    (8192 points, the seed of the runner's data), strided to S_ORTHO and
    built into the orthogonal model's stacked host graphs."""
    from graph_pde_tpu_torch.data import (burgers_multipole_data,
                                          load_or_generate_burgers,
                                          prepare_burgers)
    from graph_pde_tpu_torch.models import multipole_batch

    fields = load_or_generate_burgers(N_TRAIN + 1, S_ORTHO * 8, seed=0)
    arrays = prepare_burgers(fields, n=n, r=8)
    return arrays, multipole_batch(*burgers_multipole_data(arrays))


def phase_ortho_kernels(graphs, params) -> dict:
    """K1 and B1-bwd against their plain versions at each of the
    orthogonal model's 10 level shapes, on the card: kappa (4, kw, kw,
    4096) with kw from 1024 down to 16, the level's edge list of one
    s=1024 sample, its kappa weights, x and g from a seed. fp32 (K1
    general or SIMT, B1-bwd SIMT) within F32_TOL, bf16 within BF16_TOL;
    the forward and all four B1-bwd outputs, each form the one its
    shape takes. Returns the largest max-abs errors by form."""
    import torch

    from graph_pde_tpu_torch.ops.dense import dense_apply, layer_dims
    from graph_pde_tpu_torch.ops.fused_edge_conv import k1_form

    dev = params["fc1"]["w"].device
    gen = torch.Generator().manual_seed(SEED + 13)
    errs = {}
    with torch.inference_mode():
        for idx, kp in enumerate(c["kernel"] for c in params["conv"]):
            n = S_ORTHO // 2 ** max(idx - 1, 0)
            s = torch.as_tensor(graphs.senders[idx][0]).to(dev)
            a = torch.as_tensor(graphs.attrs[idx][0]).to(dev)
            kw = layer_dims(kp)[0][1]
            x = torch.randn(n, 64, generator=gen).to(dev)
            h2 = dense_apply(kp[:-1], a, out_nonlinearity=torch.relu)
            g = torch.randn(s.shape[0], 64, generator=gen).to(dev)
            for dt, tol in ((None, F32_TOL), ("bfloat16", BF16_TOL)):
                form = k1_form(layer_dims(kp), 64, 64, dt)
                name = f"ortho level {idx} kappa (4, {kw}, {kw}, 4096)"
                ab = check_k1(f"K1 {name} {dt or 'float32'}", x, s, a, kp,
                              64, dt, tol, form)
                key = f"K1 {form} ortho {dt or 'float32'}"
                errs[key] = max(errs.get(key, 0.0), ab)
                if form == "simt":
                    errs["K1 simt ortho bf16 rounding"] = (
                        check_k1_simt_bf16(f"K1 {name}", x, s, a, kp, 8))
                ab = check_b1_bwd(f"B1-bwd {name} {dt or 'float32'}", x, s,
                                  h2, g, kp[-1]["w"], 64, dt, tol)
                key = f"B1-bwd ortho {dt or 'float32'}"
                errs[key] = max(errs.get(key, 0.0), ab)
    return errs


def device_ms(fn, reps: int) -> float:
    """Device time of ``fn`` a call over ``reps`` calls after one
    warm-up, by CUDA events around calls that the host queued while the
    device slept (torch.cuda._sleep): the kernels back to back, without
    the gaps the host leaves between calls where a call's dispatch
    outlasts its kernels (time_ms then measures the host)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def simt_turns(k1, x, s, a, kp, ms, reps) -> dict:
    """K1's SIMT call ``k1`` (already timed at ``ms``) in turns with the
    single-block design it replaced (G = 1 forced) on the same fp32
    inputs, (new, old, old, new), and each one's kernel time alone
    (device_ms)."""
    from graph_pde_tpu_torch.ops.fused_edge_conv import simt_edge_messages

    old = lambda: simt_edge_messages(x, s, a, kp, in_channels=64, groups=1)
    t_old = [time_ms(old, reps), time_ms(old, reps)]
    turns = [ms, *t_old, time_ms(k1, reps)]
    return dict(ms=(turns[0] + turns[3]) / 2, ms_turns=turns,
                previous_form_ms=sum(t_old) / 2,
                device_ms=device_ms(k1, reps),
                previous_form_device_ms=device_ms(old, reps))


def ortho_times(graphs, params) -> dict:
    """K1 (general form, SIMT at kw 128) and B1-bwd (SIMT form) in fp32,
    the orthogonal path's, at each of the ten level shapes of one s=1024
    sample: kernel and plain times and bounds, and what the step's
    launches (depth of each a step) cost beyond their bounds. The two
    widest levels, kw 1024 (E 2,048) and kw 512 (E 3,066), go into the
    kernels line with their grids; at kw 1024 each kernel of the two
    calls is profiled."""
    import torch

    from graph_pde_tpu_torch.ops.dense import dense_apply, layer_dims
    from graph_pde_tpu_torch.ops.fused_edge_conv import (
        edge_messages_bwd_plain, edge_messages_plain, fused_edge_messages,
        fused_edge_messages_bwd, k1_form)

    dev = params["fc1"]["w"].device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator().manual_seed(SEED + 14)
    depth = ortho_config().depth
    rec, levels = {}, []
    kw_args = dict(in_channels=64, out_channels=64)
    with torch.inference_mode():
        for idx, kp in enumerate(c["kernel"] for c in params["conv"]):
            n = S_ORTHO // 2 ** max(idx - 1, 0)
            s = torch.as_tensor(graphs.senders[idx][0]).to(dev)
            a = torch.as_tensor(graphs.attrs[idx][0]).to(dev)
            e, kw = s.shape[0], layer_dims(kp)[0][1]
            form = k1_form(layer_dims(kp), 64, 64, None)
            x = torch.randn(n, 64, generator=gen).to(dev)
            k1 = lambda: fused_edge_messages(x, s, a, kp, **kw_args)
            k1p = lambda: edge_messages_plain(x, s, a, kp, **kw_args)
            shape = f"E={e}, kappa (4, {kw}, {kw}, 4096), float32"
            fwd = dict(ms=time_ms(k1, 10), plain_ms=time_ms(k1p, 10),
                       library_ms=None, shape=shape, **k1_cost(kp, e, n))
            wl = kp[-1]["w"]
            c = wl.shape[1]
            h2 = dense_apply(kp[:-1], a, out_nonlinearity=torch.relu)
            g = torch.randn(e, 64, generator=gen).to(dev)
            b1 = lambda: fused_edge_messages_bwd(x, s, h2, g, wl, **kw_args)
            b1p = lambda: edge_messages_bwd_plain(x, s, h2, g, wl, **kw_args)
            # as backward_times counts B1-bwd: three products, dpre, the
            # dx fold and dbl; each input read once, each output written
            bwd = dict(ms=time_ms(b1, 10), plain_ms=time_ms(b1p, 10),
                       library_ms=None, shape=shape,
                       flops=6.0 * e * kw * c + 3.0 * e * c,
                       bytes=(4 * (e * kw + n * 64 + e * 64 + kw * c)
                              + 8 * e + 4 * (e * 64 + e * kw + kw * c + c)))
            for r in (fwd, bwd):
                set_bound(r)
            levels.append((idx, form, fwd, bwd))
            if form == "simt":   # beside the single-block design, in turns
                fwd.update(simt_turns(k1, x, s, a, kp, fwd["ms"], 10))
                fwd["grid"] = k1_simt_grid(e, kp, 64, None, dev)
                rec[f"K1 simt ortho kw{kw}"] = fwd
            if kw == 1024:   # each kernel of the two calls, by device time
                profile_kernels("ortho_kw1024_K1", k1, phase=8)
                profile_kernels("ortho_kw1024_B1-bwd", b1, phase=8)
            if kw in (1024, 512):
                fwd["grid"] = k1_general_grid(e, 64, sms)
                bwd["grid"] = b1_simt_grid(e, kw, 64, sms)
                rec[f"K1 general ortho kw{kw}"] = fwd
                rec[f"B1-bwd simt ortho kw{kw}"] = bwd
    for key, r in rec.items():
        log(f"phase 8: {key}: grid {r['grid']}; previous form "
            f"{r.get('previous_form_ms')} ms, turns {r.get('ms_turns')}, "
            f"kernel alone {r.get('device_ms')} ms (previous form "
            f"{r.get('previous_form_device_ms')})")
    log("phase 8: level | kw | E | K1 form | K1 ms | plain | bound | "
        "B1-bwd ms | plain | bound")
    excess = {"K1 general": 0.0, "K1 simt": 0.0, "B1-bwd simt": 0.0}
    for idx, form, fwd, bwd in levels:
        log(f"phase 8: {idx} | {fwd['shape']} | {form} | {fwd['ms']:.3f} | "
            f"{fwd['plain_ms']:.3f} | {fwd['bound_ms']:.3f} | "
            f"{bwd['ms']:.3f} | {bwd['plain_ms']:.3f} | "
            f"{bwd['bound_ms']:.3f}")
        excess[f"K1 {form}"] += depth * (fwd["ms"] - fwd["bound_ms"])
        excess["B1-bwd simt"] += depth * (bwd["ms"] - bwd["bound_ms"])
    log(f"phase 8: a step's launches x (time - bound), ms: "
        f"{ {k: round(v, 3) for k, v in excess.items()} }; kernels "
        f"{sum(depth * (f['ms'] + b['ms']) for _, _, f, b in levels):.1f} "
        f"ms a step, their plain versions "
        f"{sum(depth * (f['plain_ms'] + b['plain_ms']) for _, _, f, b in levels):.1f} ms")
    for key in ("K1 general", "B1-bwd simt"):
        rec[f"{key} ortho kw1024"]["step_excess_ms"] = excess[key]
    rec["K1 simt ortho kw128"]["step_excess_ms"] = excess["K1 simt"]
    return rec


def ortho_run(name, args, cfg, n_eval_fwd) -> dict:
    """One `cli run` of the orthogonal model (ORTHO_RUN's size) with its
    steps and evaluation counted: each step launches expected_ortho(cfg,
    1, 1), the test evaluation expected_ortho(cfg, 1, 0) per test
    sample. Logs step times, the test rel-L2 and the peak device
    memory."""
    import numpy as np
    import torch

    steps, evals = [], []
    torch.cuda.reset_peak_memory_stats()
    with counted_steps(steps, evals):
        lines = cli_call(["run", "mgkn_orthogonal_burgers1d", *ORTHO_RUN,
                          *args], phase=8)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    require(len(steps) == N_TRAIN and len(evals) == 1,
            f"{name}: {len(steps)} steps, {len(evals)} evaluations")
    for st in steps:
        require(st["launches"] == expected_ortho(cfg, 1, 1),
                f"{name} step launches {st['launches']}")
        require(bool(np.isfinite(st["loss"])), f"{name} loss finite")
    require(evals[0]["launches"] == expected_ortho(cfg, n_eval_fwd, 0),
            f"{name} evaluation launches {evals[0]['launches']}")
    summary = json.loads(lines[-1])
    require(np.isfinite(summary["final_test_l2"]), f"{name} test rel-L2")
    warm = steps[-1]["ms"]
    log(f"phase 8: {name}: step times (ms) "
        f"{[round(st['ms'], 1) for st in steps]}, warm step {warm:.1f} ms, "
        f"evaluation {evals[0]['ms']:.1f} ms, test rel-L2 "
        f"{summary['final_test_l2']:.6g}, peak device memory {peak:.2f} GiB "
        f"(max_memory_allocated over the run); launches a step "
        f"{ {k: v for k, v in steps[0]['launches'].items() if v} }")
    return dict(steps=steps, evals=evals, warm_step_ms=warm, peak_gib=peak,
                test_l2=summary["final_test_l2"],
                launches={k: sum(r["launches"][k] for r in steps + evals)
                          for k in COUNTED})


def ortho_grads(params) -> dict:
    """The step-1 gradients (decoded rel-L2 loss) of the full-width
    orthogonal model on one s=1024 sample at impl='auto' (K1, B1-bwd)
    against impl='reference' (plain torch, no launch) from the same
    parameters, each leaf within F32_TOL of its max-abs."""
    import torch

    from graph_pde_tpu_torch.data.datasets import map_arrays
    from graph_pde_tpu_torch.train import MGKNOrthogonalTask, make_loss_fn
    from graph_pde_tpu_torch.train.trainer import param_leaves, trainable

    arrays, graphs = ortho_graphs(2)
    batch = map_arrays(lambda a: a[:1], graphs.to())

    def grads(cfg):
        task = MGKNOrthogonalTask(cfg, u_normalizer=arrays.u_normalizer)
        p = trainable(params)
        zero_counts()
        lv, _ = make_loss_fn(task, "rel2")(p, batch)
        lv.backward()
        torch.cuda.synchronize()
        return float(lv.detach()), [t.grad for t in param_leaves(p)], \
            read_counts()

    cfg = ortho_config()
    lk, gk, ck = grads(cfg)
    lp, gp, cp = grads(dataclasses.replace(cfg, impl="reference"))
    require(ck == expected_ortho(cfg, 1, 1), f"ortho gradient launches {ck}")
    require(not any(cp.values()), f"ortho reference launches {cp}")
    worst = 0.0
    for j, (a, b) in enumerate(zip(gk, gp)):
        rel = rel_err(a, b)[1]
        require(rel <= F32_TOL and bool(torch.isfinite(a).all()),
                f"ortho gradient {j}: relative {rel:.3e}")
        worst = max(worst, rel)
    log(f"phase 8: full-width step-1 gradients, impl='auto' vs "
        f"'reference': loss {lk:.6g} vs {lp:.6g}, worst parameter relative "
        f"max-abs err {worst:.3e} (tol {F32_TOL:g}) over {len(gk)} "
        f"parameters")
    return ck


def phase_ortho() -> dict:
    """Phase 8: the orthogonal MGKN and Burgers slice at full width,
    through the command line in this process from a temporary directory
    (its data cache and bundles go there). Holds K1 and B1-bwd at the
    ten level shapes; runs mgkn_orthogonal_burgers1d under the
    registry's impl='kcached' (B3 on every conv) with a bundle and under
    impl='auto' (K1 general at 9 levels and SIMT at kw 128, B1-bwd SIMT
    at all 10, in fp32), profiling one auto step; serves the kcached
    bundle with `cli predict` against the plain predictor; holds the
    full-width step-1 gradients of impl='auto' against 'reference'; runs
    neurips5_gkn with its split_random evaluation. Returns each path's
    launches, the kernel errors and times."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from graph_pde_tpu_torch.data import load_or_generate_burgers
    from graph_pde_tpu_torch.inference import MGKNOrthogonalPredictor
    from graph_pde_tpu_torch.models import mgkn_orthogonal_init
    from graph_pde_tpu_torch.train import MGKNOrthogonalTask, load_bundle
    from graph_pde_tpu_torch.utils.matio import MatReader

    here, tmp = os.getcwd(), tempfile.mkdtemp(prefix="chip_smoke_ortho_")
    os.chdir(tmp)
    out = dict(launches={})
    try:
        cfg = ortho_config()
        counts = expected_ortho(cfg, 1, 1)
        require(counts["K1 general"] == 36 and counts["K1 simt"] == 4
                and counts["B1-bwd simt"] == 40 == counts["K1"],
                f"orthogonal fp32 forms a step {counts}")
        arrays, graphs = ortho_graphs(N_TRAIN)
        params = mgkn_orthogonal_init(torch.Generator().manual_seed(SEED),
                                      cfg)
        out["errs"] = phase_ortho_kernels(graphs, params)
        out["times"] = ortho_times(graphs, params)

        kc = ortho_run("mgkn_orthogonal kcached", ["--bundle", "ortho_b"],
                       ortho_config("kcached"), 1)
        au = ortho_run("mgkn_orthogonal auto", ["--set", "impl=auto"], cfg,
                       1)
        out["launches"]["cli run mgkn_orthogonal kcached"] = kc["launches"]
        out["launches"]["cli run mgkn_orthogonal auto"] = au["launches"]
        out["steps"] = {k: {f: r[f] for f in ("warm_step_ms", "peak_gib",
                                              "test_l2")}
                        for k, r in (("kcached", kc), ("auto", au))}
        log(f"phase 8: warm step, kcached {kc['warm_step_ms']:.1f} ms "
            f"against auto {au['warm_step_ms']:.1f} ms")
        for run, c in ((au, cfg), (kc, ortho_config("kcached"))):
            profile_step(f"mgkn_orthogonal_{c.impl}",
                         MGKNOrthogonalTask(c, u_normalizer=arrays.u_normalizer),
                         run["steps"][-1]["params"], graphs)

        zero_counts()
        t0 = time.perf_counter()
        lines = cli_call(["predict", "ortho_b", "--synthetic", "2",
                          "--output", "ortho_pred.mat"], phase=8)
        torch.cuda.synchronize()
        got = read_counts()
        require(only_b3(got) and got["B3-fwd"] > 0 and not got["B3-bwd"],
                f"ortho predict launches {got}")
        summary = json.loads(lines[-1])
        require(summary["s"] == S_ORTHO and np.isfinite(summary["rel_l2"]),
                f"ortho predict summary {summary}")
        pred = MatReader("ortho_pred.mat").read_field("pred")
        bp, mcfg, norms, _ = load_bundle("ortho_b")
        plain = MGKNOrthogonalPredictor(
            bp, dataclasses.replace(mcfg, impl="reference"), norms["a"],
            norms["u"]).predict(load_or_generate_burgers(2, S_ORTHO)["a"])
        _, rel = rel_err(torch.from_numpy(pred), torch.from_numpy(plain))
        require(pred.shape == (2, S_ORTHO) and rel <= F32_TOL,
                f"ortho predict vs plain predictor {rel:.3e}")
        log(f"phase 8: predict s={S_ORTHO} on the kcached bundle: "
            f"{time.perf_counter() - t0:.1f} s, rel-L2 {summary['rel_l2']}, "
            f"against the plain predictor (impl='reference') {rel:.3e} "
            f"relative max-abs (tol {F32_TOL:g}); launches {got}")
        out["launches"]["cli predict mgkn_orthogonal"] = got
        out["launches"]["grad mgkn_orthogonal"] = ortho_grads(params)

        steps, evals = [], []
        zero_counts()
        with counted_steps(steps, evals):
            lines = cli_call(["run", "neurips5_gkn", "--set", "ntrain=2",
                              "--set", "ntest=1", "--set", "epochs=2"],
                             phase=8)
        got = read_counts()
        require(only_b3(got),
                f"neurips5 run (unfused kcached) launches {got}")
        result = json.loads(lines[-1])
        require(len(steps) == 2 and np.isfinite(result["full_field_l2"])
                and np.isfinite(result["final_test_l2"]),
                f"neurips5 run: {len(steps)} steps, {result}")
        out["neurips5"] = dict(warm_step_ms=steps[-1]["ms"],
                               test_l2=result["final_test_l2"],
                               full_field_l2=result["full_field_l2"])
        log(f"phase 8: neurips5_gkn run (kcached, fp32, batch 4 of m=128 "
            f"graphs): step times (ms) {[round(st['ms'], 1) for st in steps]}"
            f", warm step {steps[-1]['ms']:.1f} ms; test rel-L2 "
            f"{result['final_test_l2']:.6g}, split_random full-field rel-L2 "
            f"{result['full_field_l2']:.6g}; launches {got}")
    finally:
        os.chdir(here)
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# ------------------------------------------------------------- phase 9

def mgkn_config(name="mgkn_general_darcy2d", impl="auto"):
    """The registry entry's model at full width (the runner's config)."""
    from graph_pde_tpu_torch.experiments import get
    from graph_pde_tpu_torch.models import MGKNGeneralConfig

    c = get(name)
    return MGKNGeneralConfig(width=c.width, ker_width=c.ker_width,
                             depth=c.depth, points=tuple(c.points),
                             variant=c.mgkn_variant, impl=impl)


def mgkn_convs(cfg) -> list:
    """(kind, level, kappa dims) of the convs one V-cycle of ``cfg``
    runs: down, mid and up ('single': K_00 only)."""
    from graph_pde_tpu_torch.models.mgkn_general import level_kernel_width

    w2 = cfg.width ** 2

    def dims(*widths):
        return tuple(zip(widths[:-1], widths[1:]))

    if cfg.variant == "single":
        kw = level_kernel_width(cfg, 0)
        return [("mid", 0, dims(cfg.ker_in, kw, kw, w2))]
    out = []
    for kind in ("down", "mid", "up"):
        for l in range(cfg.level - (kind != "mid")):
            kw = level_kernel_width(cfg, l + (kind != "mid"))
            out.append((kind, l, dims(cfg.ker_in, kw, kw, w2) if kind == "mid"
                        else dims(cfg.ker_in, kw, w2)))
    return out


def expected_mgkn(cfg, n_fwd: int, n_bwd: int) -> dict:
    """The counts of n_fwd forwards and n_bwd backwards of the general
    MGKN: under impl='auto' every conv of a V-cycle launches K1 `depth`
    times a forward in the form its kappa takes, and B1-bwd `depth`
    times a backward; under impl='kcached' each conv contracts its
    float32 K through B3-fwd `depth` times a forward and B3-bwd `depth`
    times a backward (a bf16 K: no launch)."""
    from graph_pde_tpu_torch.ops.fused_edge_conv import b1_bwd_form, k1_form

    counts = dict.fromkeys(COUNTED, 0)
    if cfg.impl == "kcached":
        if cfg.compute_dtype is None:
            uses = len(mgkn_convs(cfg)) * cfg.depth
            counts["B3-fwd"], counts["B3-bwd"] = n_fwd * uses, n_bwd * uses
        return counts
    w = cfg.width
    for _, _, dims in mgkn_convs(cfg):
        form = k1_form(dims, w, w, cfg.compute_dtype)
        bwd = b1_bwd_form(dims[-1][0], w, w, cfg.compute_dtype)
        for key, n in (("K1", n_fwd), (f"K1 {form}", n_fwd),
                       ("B1-bwd", n_bwd), (f"B1-bwd {bwd}", n_bwd)):
            counts[key] += n * cfg.depth
    return counts


def mgkn_graphs(name, n):
    """The first n synthetic Darcy samples of ``name``'s registry data
    (the runner's source grid, stride and seeds), its normalizers, and
    their stacked host multilevel graphs."""
    from graph_pde_tpu_torch.data import (darcy_mgkn_graphs,
                                          load_or_generate_darcy,
                                          prepare_darcy)
    from graph_pde_tpu_torch.experiments import get

    c = get(name)
    fields = load_or_generate_darcy(n, c.source_res, seed=c.data_seed)
    arrays, norms = prepare_darcy(fields, n=n, r=c.downsample,
                                  u_norm=c.u_norm)
    graphs, _ = darcy_mgkn_graphs(arrays, points=c.points,
                                  radius_inner=c.radius_inner,
                                  radius_inter=c.radius_inter, seed=c.seed)
    return arrays, norms, graphs


def mgkn_conv_inputs(graphs, cfg, params, kind, l, gen):
    """One conv's operands on the card from sample 0 of ``graphs``: its
    senders and attrs (padded edges included, as the model runs them),
    its kappa, x [nodes, 64] and a cotangent g [E, 64] from ``gen``."""
    import torch

    dev = params["fc_in"]["w"].device
    r0, r1 = getattr(graphs, f"{kind}_ranges")[l]
    s = torch.as_tensor(getattr(graphs, f"{kind}_senders")[0, r0:r1]) \
        .long().to(dev)
    a = torch.as_tensor(getattr(graphs, f"{kind}_attr")[0, r0:r1]).to(dev)
    offs = cfg.offsets()
    n = offs[l + 1] - offs[l] if kind == "mid" else offs[-1]
    kp = params[f"conv_{kind}"][l]["kernel"]
    x = torch.randn(n, cfg.width, generator=gen).to(dev)
    g = torch.randn(s.shape[0], cfg.width, generator=gen).to(dev)
    return s, a, kp, x, g, n


def phase_mgkn_kernels(graphs, params, cfg) -> dict:
    """K1 and B1-bwd against their plain versions at each of the general
    MGKN's seven conv shapes (mid levels 0-2, down and up levels 0-1) on
    one s=85 training graph at full width: fp32 (K1 general or SIMT,
    B1-bwd SIMT) within F32_TOL, bf16 within BF16_TOL; the forward and
    all four B1-bwd outputs, each in the form its shape takes, a second
    launch bit-identical. Returns the largest max-abs errors by form."""
    import torch

    from graph_pde_tpu_torch.ops.dense import dense_apply, layer_dims
    from graph_pde_tpu_torch.ops.fused_edge_conv import k1_form

    gen = torch.Generator().manual_seed(SEED + 15)
    errs = {}
    with torch.inference_mode():
        for kind, l, dims in mgkn_convs(cfg):
            s, a, kp, x, g, _ = mgkn_conv_inputs(graphs, cfg, params, kind,
                                                 l, gen)
            require(layer_dims(kp) == dims, f"{kind} {l} kappa {dims}")
            h2 = dense_apply(kp[:-1], a, out_nonlinearity=torch.relu)
            layers = (dims[0][0],) + tuple(d[1] for d in dims)
            for dt, tol in ((None, F32_TOL), ("bfloat16", BF16_TOL)):
                form = k1_form(dims, 64, 64, dt)
                name = f"mgkn {kind} l={l} kappa {layers}"
                ab = check_k1(f"K1 {name} {dt or 'float32'}", x, s, a, kp,
                              64, dt, tol, form, phase=9)
                key = f"K1 {form} mgkn {dt or 'float32'}"
                errs[key] = max(errs.get(key, 0.0), ab)
                if form == "simt":
                    errs["K1 simt mgkn bf16 rounding"] = check_k1_simt_bf16(
                        f"K1 {name}", x, s, a, kp, 9)
                ab = check_b1_bwd(f"B1-bwd {name} {dt or 'float32'}", x, s,
                                  h2, g, kp[-1]["w"], 64, dt, tol, phase=9)
                key = f"B1-bwd mgkn {dt or 'float32'}"
                errs[key] = max(errs.get(key, 0.0), ab)
    return errs


def mgkn_times(graphs, params, cfg) -> dict:
    """K1 (general form, SIMT at mid level 1) and B1-bwd (SIMT form) in
    fp32, the auto path's, at each of the seven conv shapes of one s=85
    training graph: kernel and plain times (CUDA events) and bounds, and
    what a training step's launches (depth of each) cost beyond their
    bounds. Mid level 0 and 1 go into the kernels line with their grids;
    at mid level 0 each kernel of the two calls is profiled."""
    import torch

    from graph_pde_tpu_torch.ops.dense import dense_apply
    from graph_pde_tpu_torch.ops.fused_edge_conv import (
        edge_messages_bwd_plain, edge_messages_plain, fused_edge_messages,
        fused_edge_messages_bwd, k1_form)

    dev = params["fc_in"]["w"].device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator().manual_seed(SEED + 16)
    rec, rows = {}, []
    kw_args = dict(in_channels=64, out_channels=64)
    with torch.inference_mode():
        for kind, l, dims in mgkn_convs(cfg):
            s, a, kp, x, g, n = mgkn_conv_inputs(graphs, cfg, params, kind,
                                                 l, gen)
            e, kw = s.shape[0], dims[-1][0]
            form = k1_form(dims, 64, 64, None)
            k1 = lambda: fused_edge_messages(x, s, a, kp, **kw_args)
            k1p = lambda: edge_messages_plain(x, s, a, kp, **kw_args)
            layers = (dims[0][0],) + tuple(d[1] for d in dims)
            shape = f"{kind} l={l}: E={e}, kappa {layers}, float32"
            fwd = dict(ms=time_ms(k1, 10), plain_ms=time_ms(k1p, 10),
                       library_ms=None, shape=shape, **k1_cost(kp, e, n))
            wl = kp[-1]["w"]
            c = wl.shape[1]
            h2 = dense_apply(kp[:-1], a, out_nonlinearity=torch.relu)
            b1 = lambda: fused_edge_messages_bwd(x, s, h2, g, wl, **kw_args)
            b1p = lambda: edge_messages_bwd_plain(x, s, h2, g, wl, **kw_args)
            # as backward_times counts B1-bwd: three products, dpre, the
            # dx fold and dbl; each input read once, each output written
            bwd = dict(ms=time_ms(b1, 10), plain_ms=time_ms(b1p, 10),
                       library_ms=None, shape=shape,
                       flops=6.0 * e * kw * c + 3.0 * e * c,
                       bytes=(4 * (e * kw + n * 64 + e * 64 + kw * c)
                              + 8 * e + 4 * (e * 64 + e * kw + kw * c + c)))
            for r in (fwd, bwd):
                set_bound(r)
            rows.append((kind, l, form, fwd, bwd))
            if (kind, l) == ("mid", 0):
                profile_kernels("mgkn_mid0_K1", k1, phase=9)
                profile_kernels("mgkn_mid0_B1-bwd", b1, phase=9)
            if form == "simt":   # beside the single-block design, in turns
                fwd.update(simt_turns(k1, x, s, a, kp, fwd["ms"], 10))
            if kind == "mid" and l < 2:
                fwd["grid"] = (k1_general_grid(e, 64, sms)
                               if form == "general"
                               else k1_simt_grid(e, kp, 64, None, dev))
                bwd["grid"] = b1_simt_grid(e, kw, 64, sms)
                rec[f"K1 {form} mgkn mid{l}"] = fwd
                rec[f"B1-bwd simt mgkn mid{l}"] = bwd
    for key, r in rec.items():
        log(f"phase 9: {key}: grid {r['grid']}; previous form "
            f"{r.get('previous_form_ms')} ms, turns {r.get('ms_turns')}, "
            f"kernel alone {r.get('device_ms')} ms (previous form "
            f"{r.get('previous_form_device_ms')})")
    log("phase 9: conv | E | kappa | K1 form | K1 ms | plain | bound | "
        "B1-bwd ms | plain | bound")
    excess = {"K1 general": 0.0, "K1 simt": 0.0, "B1-bwd simt": 0.0}
    for kind, l, form, fwd, bwd in rows:
        log(f"phase 9: {fwd['shape']} | {form} | {fwd['ms']:.3f} | "
            f"{fwd['plain_ms']:.3f} | {fwd['bound_ms']:.3f} | "
            f"{bwd['ms']:.3f} | {bwd['plain_ms']:.3f} | "
            f"{bwd['bound_ms']:.3f}")
        excess[f"K1 {form}"] += cfg.depth * (fwd["ms"] - fwd["bound_ms"])
        excess["B1-bwd simt"] += cfg.depth * (bwd["ms"] - bwd["bound_ms"])
    kern = sum(cfg.depth * (f["ms"] + b["ms"]) for *_, f, b in rows)
    plain = sum(cfg.depth * (f["plain_ms"] + b["plain_ms"])
                for *_, f, b in rows)
    bound = sum(cfg.depth * (f["bound_ms"] + b["bound_ms"])
                for *_, f, b in rows)
    log(f"phase 9: a step's launches x (time - bound), ms: "
        f"{ {k: round(v, 3) for k, v in excess.items()} }; kernels "
        f"{kern:.1f} ms a step, their bounds {bound:.1f} ms, their plain "
        f"versions {plain:.1f} ms")
    rec["K1 general mgkn mid0"]["step_excess_ms"] = excess["K1 general"]
    rec["K1 simt mgkn mid1"]["step_excess_ms"] = excess["K1 simt"]
    rec["B1-bwd simt mgkn mid0"]["step_excess_ms"] = excess["B1-bwd simt"]
    rec["mgkn shapes"] = [dict(conv=f"{kind} l={l}", form=form,
                          **{f"{p}_{f}": r[f] for p, r in
                             (("K1", fw), ("B1-bwd", bw))
                             for f in ("ms", "plain_ms", "bound_ms")})
                     for kind, l, form, fw, bw in rows]
    return rec


def window_forwards(rec, n_windows: int, name: str) -> int:
    """The stacked window forwards a recording counted: at least one,
    and at most one a splitter window."""
    n = rec.counters.get("window_forwards", 0)
    require(1 <= n <= n_windows,
            f"{name}: {n} stacked forwards for {n_windows} windows")
    return n


def mgkn_run(name, args, cfg, n_windows) -> dict:
    """One `cli run mgkn_general_darcy2d` (MGKN_RUN's size) with its
    steps and evaluation counted: each step launches expected_mgkn(cfg,
    1, 1), the test evaluation expected_mgkn(cfg, 1, 0), and the
    split_random evaluation one forward a group of stacked splitter
    windows (`window_forwards`, at most n_windows). Logs step times, the
    rel-L2s and the peak device memory."""
    import numpy as np
    import torch

    from graph_pde_tpu_torch.utils import tracing

    steps, evals = [], []
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    with counted_steps(steps, evals), tracing.recording() as rec:
        lines = cli_call(["run", "mgkn_general_darcy2d", *MGKN_RUN, *args],
                         phase=9)
    torch.cuda.synchronize()
    forwards = window_forwards(rec, n_windows, name)
    # the counters still hold the last counted evaluation's launches,
    # then those of the runner's split_random evaluation
    rest = {k: v - evals[-1]["launches"][k] if evals else v
            for k, v in read_counts().items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    require(len(steps) == N_TRAIN and len(evals) == 1,
            f"{name}: {len(steps)} steps, {len(evals)} evaluations")
    for st in steps:
        require(st["launches"] == expected_mgkn(cfg, 1, 1),
                f"{name} step launches {st['launches']}")
        require(bool(np.isfinite(st["loss"])), f"{name} loss finite")
    require(evals[0]["launches"] == expected_mgkn(cfg, 1, 0),
            f"{name} evaluation launches {evals[0]['launches']}")
    require(rest == expected_mgkn(cfg, forwards, 0),
            f"{name} split_random evaluation launches {rest} "
            f"({n_windows} windows, {forwards} stacked forwards)")
    summary = json.loads(lines[-1])
    require(np.isfinite(summary["final_test_l2"])
            and np.isfinite(summary["full_field_l2"]),
            f"{name} rel-L2s {summary}")
    warm = steps[-1]["ms"]
    log(f"phase 9: {name}: step times (ms) "
        f"{[round(st['ms'], 1) for st in steps]}, warm step {warm:.1f} ms, "
        f"evaluation {evals[0]['ms']:.1f} ms, test rel-L2 "
        f"{summary['final_test_l2']:.6g}, split_random full-field rel-L2 "
        f"{summary['full_field_l2']:.6g}, peak device memory {peak:.2f} GiB "
        f"(max_memory_allocated over the run); launches a step "
        f"{ {k: v for k, v in steps[0]['launches'].items() if v} }")
    return dict(steps=steps, evals=evals, warm_step_ms=warm, peak_gib=peak,
                test_l2=summary["final_test_l2"],
                full_field_l2=summary["full_field_l2"],
                launches={k: sum(r["launches"][k] for r in steps + evals)
                          + rest[k] for k in COUNTED})


def mgkn_grads(name, params, cfg, arrays, graphs) -> dict:
    """One forward and the step-1 gradients (decoded rel-L2 loss) of a
    full-width general MGKN on one graph at impl='auto' (K1, B1-bwd)
    against impl='reference' (plain torch, no launch) from the same
    parameters: the outputs and each gradient leaf within F32_TOL of
    their max-abs, each path's launches counted. Returns the auto
    gradient's launches."""
    import torch

    from graph_pde_tpu_torch.data.datasets import map_arrays
    from graph_pde_tpu_torch.models import mgkn_general_apply_batched
    from graph_pde_tpu_torch.train import MGKNGeneralTask, make_loss_fn
    from graph_pde_tpu_torch.train.trainer import param_leaves, trainable

    batch = map_arrays(lambda a: a[:1], graphs.to())

    def forward(c):
        zero_counts()
        with torch.inference_mode():
            out = mgkn_general_apply_batched(params, c, batch)
        torch.cuda.synchronize()
        return out, read_counts()

    def grads(c):
        task = MGKNGeneralTask(c, u_normalizer=arrays.u_normalizer)
        p = trainable(params)
        zero_counts()
        lv, _ = make_loss_fn(task, "rel2")(p, batch)
        lv.backward()
        torch.cuda.synchronize()
        return float(lv.detach()), [t.grad for t in param_leaves(p)], \
            read_counts()

    ref = dataclasses.replace(cfg, impl="reference")
    (ok, ck), (op, cp) = forward(cfg), forward(ref)
    require(ck == expected_mgkn(cfg, 1, 0), f"{name} forward launches {ck}")
    require(not any(cp.values()), f"{name} reference launches {cp}")
    _, rel = rel_err(ok, op)
    require(rel <= F32_TOL and bool(torch.isfinite(ok).all()),
            f"{name} forward auto vs reference {rel:.3e}")
    lk, gk, ck = grads(cfg)
    lp, gp, cp = grads(ref)
    require(ck == expected_mgkn(cfg, 1, 1), f"{name} gradient launches {ck}")
    require(not any(cp.values()), f"{name} reference launches {cp}")
    worst, unused = 0.0, 0
    for j, (a, b) in enumerate(zip(gk, gp)):
        if a is None or b is None:
            # 'single' never runs the convs other than K_00
            require(a is None and b is None,
                    f"{name} gradient {j}: reached on one path only")
            unused += 1
            continue
        r = rel_err(a, b)[1]
        require(r <= F32_TOL and bool(torch.isfinite(a).all()),
                f"{name} gradient {j}: relative {r:.3e}")
        worst = max(worst, r)
    log(f"phase 9: {name} ({cfg.variant}, points {cfg.points}, depth "
        f"{cfg.depth}): forward auto vs reference relative max-abs "
        f"{rel:.3e}; step-1 gradients loss {lk:.6g} vs {lp:.6g}, worst "
        f"parameter relative max-abs err {worst:.3e} (tol {F32_TOL:g}) over "
        f"{len(gk) - unused} parameters ({unused} that the forward never "
        f"reaches); launches a step {({k: v for k, v in ck.items() if v})}")
    return ck


def phase_mgkn() -> dict:
    """Phase 9: the general MGKN slice at full width, through the command
    line in this process from a temporary directory (its data cache and
    bundles go there). Holds K1 and B1-bwd at the seven conv shapes and
    times them; runs mgkn_general_darcy2d under `--set impl=auto` (K1
    general 30, K1 simt 5, B1-bwd simt 35 a step) with a bundle and
    under the registry's impl='kcached' (B3 on every conv), profiling a
    step of each; serves the auto bundle with `cli predict` against the plain
    predictor; holds the full-width forward and step-1 gradients of
    impl='auto' against 'reference' for mgkn_general_darcy2d (mkgn),
    neurips1_mgkn (induced) and neurips2_mgkn (single). Returns each
    path's launches, the kernel errors and times."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from graph_pde_tpu_torch.data import load_or_generate_darcy
    from graph_pde_tpu_torch.inference import MGKNGeneralPredictor
    from graph_pde_tpu_torch.models import mgkn_general_init
    from graph_pde_tpu_torch.train import MGKNGeneralTask, load_bundle
    from graph_pde_tpu_torch.utils import tracing
    from graph_pde_tpu_torch.utils.matio import MatReader

    here, tmp = os.getcwd(), tempfile.mkdtemp(prefix="chip_smoke_mgkn_")
    os.chdir(tmp)
    out = dict(launches={})
    try:
        cfg = mgkn_config()
        counts = expected_mgkn(cfg, 1, 1)
        require(counts["K1 general"] == 30 and counts["K1 simt"] == 5
                and counts["B1-bwd simt"] == 35 == counts["K1"],
                f"general MGKN fp32 forms a step {counts}")
        arrays, _, graphs = mgkn_graphs("mgkn_general_darcy2d", N_TRAIN)
        log(f"phase 9: s={arrays.s} graphs: points {cfg.points}, mid "
            f"ranges {graphs.mid_ranges}, down {graphs.down_ranges}, up "
            f"{graphs.up_ranges}")
        params = mgkn_general_init(torch.Generator().manual_seed(SEED), cfg)
        out["errs"] = phase_mgkn_kernels(graphs, params, cfg)
        out["times"] = mgkn_times(graphs, params, cfg)

        n_windows = -(-S_MGKN ** 2 // cfg.points[0])
        au = mgkn_run("mgkn_general auto", ["--set", "impl=auto", "--bundle",
                                            "mgkn_b"], cfg, n_windows)
        kc_cfg = mgkn_config(impl="kcached")
        kc = mgkn_run("mgkn_general kcached", [], kc_cfg, n_windows)
        out["launches"]["cli run mgkn_general auto"] = au["launches"]
        out["launches"]["cli run mgkn_general kcached"] = kc["launches"]
        out["steps"] = {k: {f: r[f] for f in ("warm_step_ms", "peak_gib",
                                              "test_l2", "full_field_l2")}
                        for k, r in (("auto", au), ("kcached", kc))}
        log(f"phase 9: warm step, auto {au['warm_step_ms']:.1f} ms against "
            f"kcached {kc['warm_step_ms']:.1f} ms")
        for run, c in ((au, cfg), (kc, kc_cfg)):
            out["steps"][c.impl]["profile"] = profile_step(
                f"mgkn_general_{c.impl}",
                MGKNGeneralTask(c, u_normalizer=arrays.u_normalizer),
                run["steps"][-1]["params"], graphs, phase=9)

        zero_counts()
        with tracing.recording() as rec:
            lines = cli_call(["predict", "mgkn_b", "--synthetic", "1",
                              "--res", str(S_MGKN), "--output",
                              "mgkn_pred.mat"], phase=9)
        torch.cuda.synchronize()
        got = read_counts()
        forwards = window_forwards(rec, n_windows, "mgkn predict")
        require(got == expected_mgkn(cfg, forwards, 0),
                f"mgkn predict launches {got} ({n_windows} windows, "
                f"{forwards} stacked forwards)")
        summary = json.loads(lines[-1])
        require(summary["s"] == S_MGKN and np.isfinite(summary["rel_l2"]),
                f"mgkn predict summary {summary}")
        pred = MatReader("mgkn_pred.mat").read_field("pred")
        bp, mcfg, norms, extra = load_bundle("mgkn_b")
        require(mcfg == cfg, f"bundle config {mcfg}")
        f = load_or_generate_darcy(1, S_MGKN)
        t0 = time.perf_counter()
        plain = MGKNGeneralPredictor(
            bp, dataclasses.replace(mcfg, impl="reference"),
            input_normalizers={k: norms[k] for k in
                               ("a", "a_smooth", "a_gradx", "a_grady")},
            u_normalizer=norms["u"],
            radius_inner=tuple(extra["radius_inner"]),
            radius_inter=tuple(extra["radius_inter"])).predict(
                f["coeff"], f["Kcoeff"], f["Kcoeff_x"], f["Kcoeff_y"])
        plain_s = time.perf_counter() - t0
        _, rel = rel_err(torch.from_numpy(pred.reshape(1, -1)),
                         torch.from_numpy(plain))
        require(pred.shape == (1, S_MGKN, S_MGKN) and rel <= F32_TOL,
                f"mgkn predict vs plain predictor {rel:.3e}")
        log(f"phase 9: predict s={S_MGKN} ({n_windows} splitter windows in "
            f"{forwards} stacked forwards) on "
            f"the auto bundle: {summary['wall_time_s']} s a request "
            f"(predictor wall time), plain predictor (impl='reference') "
            f"{plain_s:.3f} s; rel-L2 {summary['rel_l2']}, against the plain "
            f"predictor {rel:.3e} relative max-abs (tol {F32_TOL:g}); "
            f"launches {({k: v for k, v in got.items() if v})}")
        out["predict"] = dict(latency_s=summary["wall_time_s"],
                              plain_latency_s=plain_s, windows=n_windows,
                              forwards=forwards)
        out["launches"]["cli predict mgkn_general"] = got

        out["launches"]["grad mgkn_general"] = mgkn_grads(
            "mgkn_general_darcy2d", params, cfg, arrays, graphs)
        for name in ("neurips1_mgkn", "neurips2_mgkn"):
            c = mgkn_config(name)
            # two samples: a unit u-normalizer needs a spread
            arr, _, gr = mgkn_graphs(name, 2)
            p = mgkn_general_init(torch.Generator().manual_seed(SEED), c)
            out["launches"][f"grad {name}"] = mgkn_grads(name, p, c, arr, gr)
    finally:
        os.chdir(here)
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def phase_gcn() -> dict:
    """Phase 10: the GCN baseline at full width on the s=421 lattice,
    through run_experiment on the card, from a temporary directory (its
    data cache and figures go there). Requires no hand-kernel launch in
    any step, evaluation or forward, finite losses and rel-L2s, and the
    card forward of the trained parameters on the test sample within
    F32_TOL of the same forward on the CPU; logs the warm step, the
    evaluation and the peak device memory; profiles a step; runs `cli
    run neurips4_gcn --smoke --figures DIR` and `cli run neurips1_gkn
    --smoke --figures DIR`. Returns the step figures."""
    import importlib.util
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from graph_pde_tpu_torch.data.datasets import map_arrays
    from graph_pde_tpu_torch.experiments import get, run_experiment
    from graph_pde_tpu_torch.experiments.runners import gcn_data
    from graph_pde_tpu_torch.models import GCNConfig
    from graph_pde_tpu_torch.train import GCNTask
    from graph_pde_tpu_torch.train.trainer import to_device

    here, tmp = os.getcwd(), tempfile.mkdtemp(prefix="chip_smoke_gcn_")
    os.chdir(tmp)
    try:
        base = get("neurips4_gcn")
        cfg = dataclasses.replace(base, ntrain=N_TRAIN, ntest=1,
                                  epochs=GCN_EPOCHS)
        t0 = time.perf_counter()
        tpl, train_b, test_b, _ = gcn_data(cfg)
        n, e = int(tpl.n_node), int(tpl.n_edge)
        require(n == S_GCN ** 2 and tpl.node_block == 512,
                f"gcn lattice {n} nodes, node_block {tpl.node_block}")
        log(f"phase 10: neurips4_gcn at full width (width {cfg.width}, "
            f"ker_width {cfg.ker_width}, depth {cfg.depth}: "
            f"{4 * cfg.depth} GCNConv) on the s={S_GCN} lattice: {n} nodes "
            f"({tpl.num_nodes_padded} padded, node_block 512), {e} edges "
            f"({tpl.num_edges_padded} padded); cuts: ntrain {base.ntrain} "
            f"-> {cfg.ntrain}, ntest {base.ntest} -> 1, epochs "
            f"{base.epochs} -> {cfg.epochs} (batch {cfg.batch_size}); "
            f"data {time.perf_counter() - t0:.1f} s on the host")

        steps, evals = [], []
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        with counted_steps(steps, evals):
            result = run_experiment(cfg, device="cuda")
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        require(len(steps) == N_TRAIN * GCN_EPOCHS
                and len(evals) == GCN_EPOCHS,
                f"gcn run: {len(steps)} steps, {len(evals)} evaluations")
        launched = [r["launches"] for r in steps + evals] + [read_counts()]
        require(not any(v for c in launched for v in c.values()),
                f"gcn run launched a hand kernel: {launched}")
        require(all(np.isfinite(st["loss"]) for st in steps)
                and all(np.isfinite(result[k]).all()
                        for k in ("train_l2", "test_l2")),
                f"gcn losses {[st['loss'] for st in steps]}, "
                f"{result['train_l2']}, {result['test_l2']}")
        require(result["extra"] == {"family": "gcn", "s": S_GCN,
                                    "node_block": 512},
                f"gcn extra {result['extra']}")
        warm, ev = steps[-1]["ms"], evals[-1]["ms"]
        log(f"phase 10: gcn run {run_s:.1f} s: step times (ms) "
            f"{[round(st['ms'], 1) for st in steps]}, warm step "
            f"{warm:.1f} ms, evaluation (1 sample) {ev:.1f} ms, train "
            f"rel-L2 {result['train_l2']}, test rel-L2 {result['test_l2']}, "
            f"peak device memory {peak:.2f} GiB (max_memory_allocated over "
            f"the run); no hand-kernel launch")

        mcfg = GCNConfig(width=cfg.width, ker_width=cfg.ker_width,
                         depth=cfg.depth, in_width=6)
        params = result["params"]
        zero_counts()
        with torch.inference_mode():
            t0 = time.perf_counter()
            got = GCNTask(mcfg, template=tpl.to("cuda")).forward(
                params, to_device(test_b, torch.device("cuda")))
            torch.cuda.synchronize()
            gpu_ms = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            want = GCNTask(mcfg, template=tpl.to("cpu")).forward(
                map_arrays(lambda t: t.detach().cpu(), params),
                to_device(test_b, torch.device("cpu")))
            cpu_ms = (time.perf_counter() - t0) * 1e3
        counts = read_counts()
        require(not any(counts.values()), f"gcn forward launches {counts}")
        err, rel = rel_err(got[:, :n].cpu(), want[:, :n])
        require(rel <= F32_TOL and bool(torch.isfinite(got).all()),
                f"gcn forward card vs CPU {rel:.3e}")
        log(f"phase 10: gcn forward of the trained parameters on the test "
            f"sample, card against CPU: max-abs err {err:.3e}, relative "
            f"{rel:.3e} (tol {F32_TOL:g}; index_add_ sums in another "
            f"order on the card); {gpu_ms:.1f} ms on the card (first "
            f"forward outside the run), {cpu_ms:.0f} ms on the host")

        prof = profile_step(
            "gcn", GCNTask(mcfg, loss_type=cfg.loss, use_sample_idx=False,
                           template=tpl.to("cuda")),
            params, train_b, phase=10)
        counts = read_counts()
        require(not any(counts.values()), f"gcn step launches {counts}")

        lines = cli_call(["run", "neurips4_gcn", "--smoke", "--figures",
                          "figs_gcn", "--out", "gcn.json"], phase=10)
        out = json.load(open("gcn.json"))
        require(np.isfinite(json.loads(lines[-1])["final_test_l2"])
                and out.get("figures") is None
                and not (os.path.isdir("figs_gcn")
                         and os.listdir("figs_gcn")),
                f"gcn --figures: {out.get('figures')}")
        cli_call(["run", "neurips1_gkn", "--smoke", "--figures", "figs_gkn",
                  "--out", "gkn.json"], phase=10)
        figs = json.load(open("gkn.json"))["figures"]
        names = [f"neurips1_gkn_{t}.png" for t in ("best", "median", "worst")]
        have_mpl = importlib.util.find_spec("matplotlib") is not None
        require(figs == ([os.path.join("figs_gkn", f) for f in names]
                         if have_mpl else [])
                and all(os.path.isfile(f) for f in figs),
                f"gkn --figures: {figs} (matplotlib "
                f"{'present' if have_mpl else 'absent'})")
        log(f"phase 10: cli run neurips4_gcn --smoke --figures: exit 0, no "
            f"figure (the GCN runner writes none); cli run neurips1_gkn "
            f"--smoke --figures: {figs} (matplotlib "
            f"{'present' if have_mpl else 'absent'})")
    finally:
        os.chdir(here)
        shutil.rmtree(tmp, ignore_errors=True)
    return dict(warm_step_ms=warm, eval_ms=ev, peak_gib=peak,
                forward_rel_err=rel, profile=prof)


@contextlib.contextmanager
def no_native():
    """Within it, the compiled graph builder reads as unavailable, so the
    graph builds take their cKDTree (radius) and dense numpy (torus)
    paths."""
    from graph_pde_tpu_torch.graph import native

    load = native._load
    native._load = lambda: None
    try:
        yield
    finally:
        native._load = load


def turns_s(a, b) -> tuple:
    """Host seconds of ``a`` and ``b`` in turns (a, b, b, a): each one's
    mean, and the four times."""
    times = []
    for fn in (a, b, b, a):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return (times[0] + times[3]) / 2, (times[1] + times[2]) / 2, times


def torus_native(dev) -> dict:
    """The compiled cell-list builder: its build, bit-equal edges against
    cKDTree and dense numpy (the s=61 GKN grid at r 0.2; the general
    MGKN's s=85 levels, inner and bipartite; a full-width torus shard,
    its geometry too), the host builds and one s=61 GKN and one s=85
    general-MGKN request with each builder, in turns, their outputs
    equal (bit for bit under deterministic algorithms). Returns the
    times."""
    import warnings

    import numpy as np
    import torch

    from graph_pde_tpu_torch.data import (load_or_generate_darcy,
                                          prepare_darcy)
    from graph_pde_tpu_torch.experiments import get
    from graph_pde_tpu_torch.experiments.runners import torus_splitter
    from graph_pde_tpu_torch.graph import (RandomMultiMeshGenerator, build,
                                           make_box_grid, native)
    from graph_pde_tpu_torch.inference import (GKNPredictor,
                                               MGKNGeneralPredictor)
    from graph_pde_tpu_torch.models import mgkn_general_init

    fresh = not native.library_path().exists()
    t0 = time.perf_counter()
    path = native.build()
    build_s = time.perf_counter() - t0 if fresh else None
    require(native.available(), "the native graph builder loads")
    log(f"phase 11: native graph builder {path.name} (g++ "
        f"{' '.join(native.CXX_FLAGS)}) "
        + (f"built in {build_s:.2f} s" if fresh else
           "already built by an earlier phase's first radius graph"))

    def three_ways(name, pts, r, pts_b=None) -> int:
        nat = build.radius_connectivity(pts, r, points_b=pts_b)
        with no_native():
            tree = build.radius_connectivity(pts, r, points_b=pts_b)
        dense = build.radius_connectivity(pts, r, points_b=pts_b,
                                          method="dense")
        require(np.array_equal(nat, tree) and np.array_equal(nat, dense),
                f"native edges on {name} equal cKDTree's and dense's")
        log(f"phase 11: {name}: {nat.shape[1]} edges, native = cKDTree = "
            f"dense bit for bit")
        return nat.shape[1]

    grid61 = make_box_grid([[0, 1], [0, 1]], [S_FULL, S_FULL])
    three_ways(f"s={S_FULL} GKN grid, r {RADIUS}", grid61, RADIUS)
    mc = get("mgkn_general_darcy2d")
    mg = RandomMultiMeshGenerator([[0, 1], [0, 1]], [S_MGKN, S_MGKN],
                                  len(mc.points), mc.points, seed=SEED)
    mg.sample()
    for l in range(len(mc.points)):
        three_ways(f"s={S_MGKN} MGKN level {l}, r {mc.radius_inner[l]}",
                   mg.grid_sample[l], mc.radius_inner[l])
    for l in range(len(mc.points) - 1):
        three_ways(f"s={S_MGKN} MGKN levels {l}->{l + 1} (bipartite), r "
                   f"{mc.radius_inter[l]}", mg.grid_sample[l],
                   mc.radius_inter[l], mg.grid_sample[l + 1])
    tc = get("grain_torus_timeseries")
    sp = torus_splitter(tc)
    theta = np.zeros((tc.source_res, tc.source_res, 1), np.float32)
    shard = sp._shard(theta, 1, 1)[0]
    nat = native.native_torus2d(shard, tc.radius_train)
    dense = build._dense_torus2d(shard, tc.radius_train)
    require(all(np.array_equal(a, b) for a, b in zip(nat, dense)),
            "native torus edges and geometry equal dense numpy's")
    log(f"phase 11: torus shard (1, 1), {shard.shape[0]} nodes, r "
        f"{tc.radius_train}: {nat[0].shape[1]} edges; edges, dist, dx, dy "
        f"native = dense bit for bit")

    def radius61():
        build.radius_connectivity(grid61, RADIUS)

    def tree61():
        with no_native():
            radius61()

    def dense_torus():
        build._dense_torus2d(shard, tc.radius_train)

    out = {"build_s": build_s}
    out["s61_radius_native_s"], out["s61_radius_ckdtree_s"], t61 = \
        turns_s(radius61, tree61)
    out["torus_native_s"], out["torus_dense_s"], tt = turns_s(
        lambda: native.native_torus2d(shard, tc.radius_train), dense_torus)
    log(f"phase 11: host builds in turns (native, other, other, native): "
        f"s={S_FULL} radius graph native {out['s61_radius_native_s']:.4f} "
        f"s, cKDTree {out['s61_radius_ckdtree_s']:.4f} s {t61}; torus shard "
        f"native {out['torus_native_s']:.5f} s, dense numpy "
        f"{out['torus_dense_s']:.5f} s {tt}")

    # one s=61 GKN request (impl='auto') and one s=85 general-MGKN request
    # (19 windows), each with either builder, in turns; a fresh MGKN
    # predictor each time so that every request draws the same windows
    cfg, params, norms, u_norm, full, _ = serving_setup(dev)
    gkn = GKNPredictor(params, cfg, norms, u_norm, radius=RADIUS,
                       split_threshold=SPLIT_THRESHOLD)
    mcfg = mgkn_config()
    # normalizers fitted at s=85 itself (the unit u-normalizer is per
    # node): their values do not matter here
    fields = load_or_generate_darcy(N_TRAIN, S_MGKN, seed=mc.data_seed)
    arrays, mnorms = prepare_darcy(fields, n=N_TRAIN, u_norm=mc.u_norm)
    mparams = mgkn_general_init(torch.Generator().manual_seed(SEED), mcfg)
    req = load_or_generate_darcy(1, S_MGKN, seed=SEED + 3)
    outs = []

    def request(kind, tree):
        def call():
            with no_native() if tree else contextlib.nullcontext():
                if kind == "gkn":
                    got = gkn.predict(full[:1])
                else:
                    got = MGKNGeneralPredictor(
                        mparams, mcfg, input_normalizers=mnorms,
                        u_normalizer=arrays.u_normalizer,
                        radius_inner=mc.radius_inner,
                        radius_inter=mc.radius_inter).predict(
                            req["coeff"], req["Kcoeff"], req["Kcoeff_x"],
                            req["Kcoeff_y"])
                torch.cuda.synchronize()
            outs.append(got)
            return got
        return call

    for kind, s in (("gkn", S_FULL), ("mgkn", S_MGKN)):
        request(kind, False)()   # warm-up
        # bit for bit where the scatter sums (index_add_'s atomics) are
        # deterministic; timed in the default mode, in turns
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")   # deterministic-mode notices
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                same = np.array_equal(request(kind, False)(),
                                      request(kind, True)())
            finally:
                torch.use_deterministic_algorithms(False)
        require(same, f"{kind} requests with either builder equal bit for "
                f"bit under deterministic algorithms")
        outs.clear()
        nat_s, tree_s, tr = turns_s(request(kind, False),
                                    request(kind, True))
        worst = max(rel_err(torch.from_numpy(o), torch.from_numpy(outs[0]))[1]
                    for o in outs)
        require(worst <= F32_TOL, f"{kind} timed requests agree ({worst})")
        out[f"{kind}_request_native_s"] = nat_s
        out[f"{kind}_request_ckdtree_s"] = tree_s
        log(f"phase 11: {kind} request (s={s}): native builder {nat_s:.4f} "
            f"s, cKDTree {tree_s:.4f} s, in turns {tr}; outputs of either "
            f"builder bit-equal under deterministic algorithms, the timed "
            f"ones (default mode) within {worst:.3e} of each other")
    return out


def torus_batch(cfg, dev, n=4):
    """n training shards of the torus runner (its data, splitter and
    seeds), at one edge capacity, stacked on the card."""
    import numpy as np

    from graph_pde_tpu_torch.experiments.runners import (torus_samples,
                                                         torus_splitter)
    from graph_pde_tpu_torch.graph import repad_edges, round_up, stack_graphs

    samples = torus_samples(cfg, np.random.default_rng(cfg.data_seed), n)
    sp = torus_splitter(cfg)
    shards = [sp.sampleT(theta, y)[0] for theta, y in samples]
    e_pad = round_up(max(g.senders.shape[0] for g in shards), 512)
    return stack_graphs([repad_edges(g, e_pad) for g in shards]).to(dev)


def expected_torus(mcfg, n_fwd: int, n_bwd: int) -> dict:
    """The counts of n_fwd forwards and n_bwd backwards of the torus GKN:
    under impl='auto' K1 and B1-bwd `depth` times each in the forms its
    conv takes (fp32: K1 general, B1-bwd SIMT); other impls none (kcached
    runs are held to ``only_b3`` instead)."""
    from graph_pde_tpu_torch.ops.dense import layer_dims
    from graph_pde_tpu_torch.ops.fused_edge_conv import b1_bwd_form, k1_form

    counts = dict.fromkeys(COUNTED, 0)
    if mcfg.impl != "auto":
        return counts
    dims, w = layer_dims_of(mcfg), mcfg.width
    form = k1_form(dims, w, w, mcfg.compute_dtype)
    bwd = b1_bwd_form(dims[-1][0], w, w, mcfg.compute_dtype)
    for key, n in (("K1", n_fwd), (f"K1 {form}", n_fwd), ("B1-bwd", n_bwd),
                   (f"B1-bwd {bwd}", n_bwd)):
        counts[key] += n * mcfg.depth
    return counts


def layer_dims_of(mcfg):
    layers = mcfg.resolved_kernel_layers()
    return tuple(zip(layers[:-1], layers[1:]))


def torus_kernels(batch, params, mcfg) -> tuple:
    """K1 and B1-bwd at the torus conv (kappa (5, 32, 64, 1024), in = out
    = 32) on one shard (E_pad 12,800) and on the flattened batch of 4
    (51,200): fp32 (K1 general, B1-bwd SIMT) within F32_TOL, bf16 (K1
    general, B1-bwd on the tensor cores) within BF16_TOL, every B1-bwd
    output, a second launch bit-identical; then their times beside the
    bounds and the plain versions. Returns (errors, times)."""
    import torch

    from graph_pde_tpu_torch.graph.graph import flatten_stacked
    from graph_pde_tpu_torch.models.gkn import _member
    from graph_pde_tpu_torch.ops.dense import dense_apply
    from graph_pde_tpu_torch.ops.fused_edge_conv import (
        edge_messages_bwd_plain, edge_messages_plain, fused_edge_messages,
        fused_edge_messages_bwd)

    w, kp = mcfg.width, params["kernel"]
    dims = layer_dims_of(mcfg)
    require(dims == ((5, 32), (32, 64), (64, 1024)) and w == 32,
            f"torus kappa {dims}, width {w}")
    dev = batch.x.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator().manual_seed(SEED + 21)
    errs, times = {}, {}
    graphs = ((TORUS_E[0], _member(batch, 0)), (TORUS_E[1],
                                                  flatten_stacked(batch)))
    with torch.inference_mode():
        for e, g in graphs:
            s, a = g.senders, g.edge_attr
            require(s.shape[0] == e, f"torus E_pad {s.shape[0]}")
            n = g.x.shape[0]
            x = torch.randn(n, w, generator=gen).to(dev)
            gg = torch.randn(e, w, generator=gen).to(dev)
            h2 = dense_apply(kp[:-1], a, out_nonlinearity=torch.relu)
            wl = kp[-1]["w"]
            for dt, tol in ((None, F32_TOL), ("bfloat16", BF16_TOL)):
                name = f"torus E {e} {dt or 'float32'}"
                ab = check_k1(f"K1 {name}", x, s, a, kp, w, dt, tol,
                              "general", phase=11, w_out=w)
                errs[f"K1 general torus {dt or 'float32'}"] = max(
                    ab, errs.get(f"K1 general torus {dt or 'float32'}", 0.0))
                ab = check_b1_bwd(f"B1-bwd {name}", x, s, h2, gg, wl, w, dt,
                                  tol, phase=11)
                errs[f"B1-bwd torus {dt or 'float32'}"] = max(
                    ab, errs.get(f"B1-bwd torus {dt or 'float32'}", 0.0))
            kw, c = wl.shape
            prods, elems = 6.0 * e * kw * c, 3.0 * e * c
            nbytes = (4 * (e * kw + n * w + e * w + kw * c) + 8 * e
                      + 4 * (e * w + e * kw + kw * c + c))
            for dt in (None, "bfloat16"):
                kw_args = dict(in_channels=w, out_channels=w,
                               compute_dtype=dt)
                k1 = lambda: fused_edge_messages(x, s, a, kp, **kw_args)
                k1p = lambda: edge_messages_plain(x, s, a, kp, **kw_args)
                b1 = lambda: fused_edge_messages_bwd(x, s, h2, gg, wl,
                                                     **kw_args)
                b1p = lambda: edge_messages_bwd_plain(x, s, h2, gg, wl,
                                                      **kw_args)
                tag = dt or "float32"
                shape = f"E={e}, kappa (5, 32, 64, 1024), in = out = 32"
                times[f"K1 general torus E{e} {tag}"] = dict(
                    ms=time_ms(k1, 20), plain_ms=time_ms(k1p, 20),
                    library_ms=None, shape=f"{shape}, {tag}",
                    grid=k1_general_grid(e, w, sms),
                    **k1_cost(kp, e, n, w=w))
                ops = (dict(bf16_flops=prods, flops=elems) if dt
                       else dict(flops=prods + elems))
                rec = dict(ms=time_ms(b1, 20), plain_ms=time_ms(b1p, 20),
                           library_ms=None, bytes=nbytes,
                           shape=f"{shape}, {tag}", **ops)
                if not dt:
                    rec["grid"] = b1_simt_grid(e, kw, w, sms)
                else:
                    rec["kernels_ms"] = b1_bwd_tc_kernels_ms(profile_kernels(
                        f"torus_E{e}_B1-bwd", b1, phase=11, reps=20))
                times[f"B1-bwd {'tc' if dt else 'simt'} torus E{e}"] = rec
    for key, r in times.items():
        set_bound(r)
        log(f"phase 11: {key} ({r['shape']}): {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), grid {r.get('grid')}, kernels "
            f"{r.get('kernels_ms')}")
    return errs, times


def torus_run(name, args, mcfg) -> dict:
    """One `cli run grain_torus_timeseries` at full width (TORUS_EPOCHS
    epochs of ntrain // batch steps) with every step's launches counted
    (each step: expected_torus(mcfg, 1, 1)) and the evaluation's after
    the last step (expected_torus(mcfg, shards x ntest, 0)). Logs the
    step times, the rel-L2s and the peak device memory."""
    import numpy as np
    import torch

    from graph_pde_tpu_torch.experiments import get
    from graph_pde_tpu_torch.experiments import runners as trun

    cfg = get("grain_torus_timeseries")
    steps, orig = [], trun._torus_step

    def counted(params, c, opt, batch):
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        loss = orig(params, c, opt, batch)
        torch.cuda.synchronize()
        steps.append(dict(ms=(time.perf_counter() - t0) * 1e3,
                          launches=read_counts(), loss=float(loss),
                          params=params, opt=opt, batch=batch))
        return loss

    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    trun._torus_step = counted
    try:
        cli_call(["run", "grain_torus_timeseries", "--set",
                  f"epochs={TORUS_EPOCHS}", "--out", f"{name}.json", *args],
                 phase=11)
    finally:
        trun._torus_step = orig
    torch.cuda.synchronize()
    # the counters still hold the last step's launches, then the
    # evaluation's
    evals = {k: v - steps[-1]["launches"][k] if steps else v
             for k, v in read_counts().items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    result = json.load(open(f"{name}.json"))
    n_steps = TORUS_EPOCHS * (cfg.ntrain // cfg.batch_size)
    shards = cfg.downsample ** 2 * cfg.ntest
    require(len(steps) == n_steps, f"{name}: {len(steps)} steps")

    def launched(got, want):
        return only_b3(got) if mcfg.impl == "kcached" else got == want

    for st in steps:
        require(launched(st["launches"], expected_torus(mcfg, 1, 1)),
                f"{name} step launches {st['launches']}")
        require(bool(np.isfinite(st["loss"])), f"{name} loss finite")
    require(launched(evals, expected_torus(mcfg, shards, 0)),
            f"{name} evaluation launches {evals} ({shards} shard forwards)")
    require(len(result["train_l2"]) == TORUS_EPOCHS
            and len(result["test_l2_per_step"]) == cfg.torus_T
            and np.isfinite(result["train_l2"]).all()
            and np.isfinite(result["test_l2_per_step"]).all(),
            f"{name} histories {result['train_l2']}, "
            f"{result['test_l2_per_step']}")
    warm = float(np.median([st["ms"] for st in steps[-n_steps // 2:]]))
    log(f"phase 11: {name}: step times (ms) "
        f"{[round(st['ms'], 2) for st in steps]}, warm step (median of the "
        f"last half) {warm:.2f} ms, train loss {result['train_l2']}, test "
        f"rel-L2 per step {result['test_l2_per_step']}, peak device memory "
        f"{peak:.3f} GiB; launches a step "
        f"{ {k: v for k, v in steps[0]['launches'].items() if v} }, the "
        f"evaluation's {shards} shard forwards "
        f"{ {k: v for k, v in evals.items() if v} }")
    return dict(steps=steps, warm_step_ms=warm, peak_gib=peak,
                test_l2_per_step=result["test_l2_per_step"],
                launches={k: sum(r["launches"][k] for r in steps) + evals[k]
                          for k in COUNTED})


def torus_grads(name, batch, params, cfg, ref_cfg, tol) -> dict:
    """The torus loss's step-1 gradients of ``cfg`` against ``ref_cfg``
    from the same parameters on one batch, each leaf within ``tol`` of
    its max-abs. Returns the first's launches."""
    import torch

    from graph_pde_tpu_torch.experiments.runners import torus_loss
    from graph_pde_tpu_torch.train.trainer import param_leaves, trainable

    def grads(c):
        p = trainable(params)
        zero_counts()
        lv = torus_loss(p, c, batch)
        lv.backward()
        torch.cuda.synchronize()
        return float(lv.detach()), [t.grad for t in param_leaves(p)], \
            read_counts()

    def launched(got, c):
        return (only_b3(got) if c.impl == "kcached"
                else got == expected_torus(c, 1, 1))

    lk, gk, ck = grads(cfg)
    lr, gr, cr = grads(ref_cfg)
    require(launched(ck, cfg), f"{name} launches {ck}")
    require(launched(cr, ref_cfg), f"{name} reference launches {cr}")
    worst = 0.0
    for j, (a, b) in enumerate(zip(gk, gr)):
        rel = rel_err(a, b)[1]
        require(rel <= tol and bool(torch.isfinite(a).all()),
                f"{name} gradient {j}: relative {rel:.3e}")
        worst = max(worst, rel)
    log(f"phase 11: {name}: step-1 loss {lk:.6g} vs {lr:.6g}, worst "
        f"parameter relative max-abs err {worst:.3e} (tol {tol:g}) over "
        f"{len(gk)} parameters; launches "
        f"{ {k: v for k, v in ck.items() if v} }")
    return ck


def uai1_loop_vjp(dev) -> dict:
    """loop_vjp on the uai1 model under the runner's unfused kcached path,
    step-1 gradients with loop_vjp on against off: on the gradient
    check's graph with fp32 K, within F32_TOL; there in bf16 compute,
    where the two round dK at different points (once after an fp32 sum
    over the depth steps, against once a step), each path judged by its
    distance from the fp32-compute gradient (on no farther than
    FP8_GRAD_FACTOR x off + FP8_GRAD_SLACK, leaf by leaf, as the e5m2
    check judges fp8); and on the full s=61 training graph, whose K is
    bf16 (the runner's uai1 path), within GRAD_BF16_TOL. Then the warm
    train steps of each there, in turns (off, on, on, off), with their
    peak device memory."""
    import torch

    from graph_pde_tpu_torch.data.datasets import map_arrays
    from graph_pde_tpu_torch.models import gkn as gkn_model
    from graph_pde_tpu_torch.models import gkn_init
    from graph_pde_tpu_torch.train import (GKNTask, adam_steplr,
                                           make_loss_fn, make_train_step)
    from graph_pde_tpu_torch.train.trainer import param_leaves, trainable

    off = dataclasses.replace(uai1_config(), kcached_fused="off")
    on = dataclasses.replace(off, loop_vjp=True)

    def grads(c, arrays, batch, params):
        task = GKNTask(c, u_normalizer=arrays.u_normalizer, loss_type="l1")
        p = trainable(params)
        zero_counts()
        lv, _ = make_loss_fn(task, "l1")(p, batch)
        lv.backward()
        torch.cuda.synchronize()
        require(only_b3(read_counts()), "uai1 unfused launches")
        require(bool(torch.isfinite(lv)), "uai1 loss finite")
        return [t.grad for t in param_leaves(p)]

    def dist(a, b):
        return [rel_err(x, y)[1] for x, y in zip(a, b)]

    small = grad_inputs(off, "gaussian", S_GRAD1, R_GRAD1, 0)
    worst = max(dist(grads(on, *small), grads(off, *small)))
    require(worst <= F32_TOL, f"uai1 loop_vjp fp32 gradients: {worst:.3e}")
    log(f"phase 11: uai1 loop_vjp step-1 gradients on vs off (fp32 K, s="
        f"{S_GRAD1}): worst parameter relative max-abs err {worst:.3e} "
        f"(tol {F32_TOL:g})")
    ref = grads(off, *small)
    g_on, g_off = (grads(dataclasses.replace(c, compute_dtype="bfloat16"),
                         *small) for c in (on, off))
    d_on, d_off = dist(g_on, ref), dist(g_off, ref)
    for j, (a, b) in enumerate(zip(d_on, d_off)):
        require(a <= FP8_GRAD_FACTOR * b + FP8_GRAD_SLACK,
                f"uai1 loop_vjp bf16 gradient {j}: {a:.3e} from fp32, "
                f"autograd {b:.3e}")
    log(f"phase 11: uai1 loop_vjp step-1 gradients in bf16 compute (s="
        f"{S_GRAD1}): on vs off worst {max(dist(g_on, g_off)):.3e}; "
        f"distance from the fp32-compute gradient, worst leaf: on "
        f"{max(d_on):.3e}, off {max(d_off):.3e} (each leaf: on <= "
        f"{FP8_GRAD_FACTOR} x off + {FP8_GRAD_SLACK:g})")

    arrays, graphs = training_data(N_TRAIN, S_UAI1, R_UAI1, "gaussian", 0,
                                   SEED + 1)
    batch = map_arrays(lambda a: a[:1], graphs.to(dev))
    init = gkn_init(torch.Generator().manual_seed(SEED), off, device=dev)
    e = graphs.senders.shape[1]
    k_dtype = ("bf16" if gkn_model.cached_k_dtype(off, e, dev)
               == torch.bfloat16 else "fp32")
    full = dist(grads(on, arrays, batch, init), grads(off, arrays, batch,
                                                      init))
    tol = GRAD_BF16_TOL if k_dtype == "bf16" else F32_TOL
    require(max(full) <= tol, f"uai1 loop_vjp s={S_UAI1} gradients: "
            f"{max(full):.3e}")
    log(f"phase 11: uai1 loop_vjp step-1 gradients on vs off (s={S_UAI1}, "
        f"E_pad {e}, {k_dtype} K): worst parameter relative max-abs err "
        f"{max(full):.3e} (tol {tol:g})")
    times, peaks = {"off": [], "on": []}, {}
    for which in ("off", "on", "on", "off"):
        cfg = on if which == "on" else off
        params = trainable(init)
        opt, _ = adam_steplr(param_leaves(params), 1e-4, weight_decay=5e-4)
        step = make_train_step(GKNTask(cfg, u_normalizer=arrays.u_normalizer,
                                       loss_type="l1"), opt)
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        step(params, batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(params, batch)
        torch.cuda.synchronize()
        times[which].append((time.perf_counter() - t0) * 1e3)
        peaks[which] = torch.cuda.max_memory_allocated() / 2 ** 30
        require(only_b3(read_counts()), "uai1 unfused launches")
        del params, opt, step
    out = {f"warm_step_{k}_ms": sum(v) / 2 for k, v in times.items()}
    out.update({f"peak_{k}_gib": v for k, v in peaks.items()})
    out.update(grad_on_off=max(full), bf16_compute_on_off=max(dist(g_on,
                                                                   g_off)))
    log(f"phase 11: uai1 (unfused kcached, E_pad {e}, {k_dtype} K) warm "
        f"step, in turns (off, on, on, off): loop_vjp off "
        f"{out['warm_step_off_ms']:.1f} ms {times['off']}, on "
        f"{out['warm_step_on_ms']:.1f} ms {times['on']}; peak device "
        f"memory off {peaks['off']:.2f} GiB, on {peaks['on']:.2f} GiB")
    return out


def phase_torus(dev) -> dict:
    """Phase 11: the torus family and the last single-device modules, from
    a temporary directory (its data cache and result files go there):
    the native graph builder (torus_native), K1 and B1-bwd at the torus
    conv (torus_kernels), `cli run grain_torus_timeseries` at full width
    under the registry's kcached (B3 only) and `--set impl=auto` (each
    step K1 general 3, B1-bwd simt 3; the evaluation K1 general 3 a shard
    forward), a step of each profiled, the step-1 gradients of auto
    against reference and of loop_vjp against autograd (torus, uai1),
    and uai1's warm steps with loop_vjp on and off. Returns the launches,
    errors, times and step figures."""
    import os
    import shutil
    import tempfile

    import torch

    from graph_pde_tpu_torch.experiments import get
    from graph_pde_tpu_torch.experiments import runners as trun
    from graph_pde_tpu_torch.models import gkn_init

    here, tmp = os.getcwd(), tempfile.mkdtemp(prefix="chip_smoke_torus_")
    os.chdir(tmp)
    out = dict(launches={})
    try:
        out["native"] = torus_native(dev)
        cfg = get("grain_torus_timeseries")
        auto = dataclasses.replace(trun.torus_model_config(cfg), impl="auto")
        counts = expected_torus(auto, 1, 1)
        require(counts["K1 general"] == 3 == counts["B1-bwd simt"]
                and counts["K1"] == 3 == counts["B1-bwd"],
                f"torus auto forms a step {counts}")
        batch = torus_batch(cfg, dev)
        params = gkn_init(torch.Generator().manual_seed(SEED), auto,
                          device=dev)
        out["errs"], out["times"] = torus_kernels(batch, params, auto)

        au = torus_run("torus_auto", ["--set", "impl=auto"], auto)
        kc_cfg = trun.torus_model_config(cfg)
        kc = torus_run("torus_kcached", [], kc_cfg)
        out["launches"]["cli run torus auto"] = au["launches"]
        out["launches"]["cli run torus kcached"] = kc["launches"]
        out["steps"] = {}
        for key, run, c in (("auto", au, auto), ("kcached", kc, kc_cfg)):
            last = run["steps"][-1]
            prof = profile_fn(
                f"torus_{key}", lambda: trun._torus_step(
                    last["params"], c, last["opt"], last["batch"]),
                phase=11)
            out["steps"][key] = dict(warm_step_ms=run["warm_step_ms"],
                                     peak_gib=run["peak_gib"],
                                     test_l2_per_step=run[
                                         "test_l2_per_step"], profile=prof)

        out["launches"]["grad torus auto"] = torus_grads(
            "torus auto vs reference", batch, params, auto,
            dataclasses.replace(auto, impl="reference"), F32_TOL)
        torus_grads("torus loop_vjp on vs off", batch, params,
                    dataclasses.replace(kc_cfg, loop_vjp=True), kc_cfg,
                    F32_TOL)
        out["loop_vjp_uai1"] = uai1_loop_vjp(dev)
    finally:
        os.chdir(here)
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# (name, kappa, E, nodes) of K1 SIMT's main-path shapes: the general
# MGKN's mid level 1 (one s=85 graph), the orthogonal kw-128 level (one
# s=1024 sample) and the s=61 serving graph (E_pad)
SIMT_SHAPES = (("mgkn mid l=1", (6, 128, 128, 4096), 4864, 100),
               ("ortho kw128", (4, 128, 128, 4096), 762, 128),
               ("s=61 serving", (6, 128, 256, 4096), 1378816, 3721))
SIMT_CHECK_E = (1, 127, 129, 762, 4864)


def k1_simt_probe() -> None:
    """--k1-simt: K1's SIMT form alone on seeded inputs. The resident
    clusters the card reports at each SIMT_SHAPES kappa; the form against
    its plain version at SIMT_CHECK_E edges of the mid l=1 kappa with
    the rule's G and with G forced to 1, 2, 4, 8 and 16 (fp32 within
    F32_TOL, bf16 rounding within BF16_TOL, a second launch
    bit-identical); at each SIMT_SHAPES shape the rule's grid in turns
    with the single-block design (G = 1 forced), the plain version, the
    bound, and at the two small ones every G that splits the pairs."""
    import torch

    from graph_pde_tpu_torch.ops.dense import dense_init
    from graph_pde_tpu_torch.ops.fused_edge_conv import (
        edge_messages_plain, fused_edge_messages, k1_simt_clusters,
        simt_edge_messages)

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 17)

    def inputs(layers, e, n):
        kp = dense_init(gen, layers, device=dev)
        x = torch.randn(n, 64, generator=gen).to(dev)
        s = torch.randint(0, n, (e,), generator=gen).to(dev)
        a = torch.rand(e, layers[0], generator=gen).to(dev)
        return kp, x, s, a

    with torch.inference_mode():
        for name, layers, e, n in SIMT_SHAPES:
            dims = list(zip(layers, layers[1:]))
            for rb in (0, 1):
                log(f"k1-simt: {name} kappa {layers} rb {rb}: resident "
                    f"clusters by G {k1_simt_clusters(dims, 64, rb, dev)}")
        for e in SIMT_CHECK_E:
            kp, x, s, a = inputs((6, 128, 128, 4096), e, 100)
            for dt, tol in ((None, F32_TOL), ("bfloat16", BF16_TOL)):
                want = edge_messages_plain(x, s, a, kp, in_channels=64,
                                           out_channels=64,
                                           compute_dtype=dt)
                for groups in (None, 1, 2, 4, 8, 16):
                    kw = dict(in_channels=64, compute_dtype=dt,
                              groups=groups)
                    got = simt_edge_messages(x, s, a, kp, **kw)
                    again = simt_edge_messages(x, s, a, kp, **kw)
                    torch.cuda.synchronize()
                    ab, rel = rel_err(got, want)
                    same = bool(torch.equal(got, again))
                    g = (k1_simt_grid(e, kp, 64, dt, dev)["G"]
                         if groups is None else groups)
                    log(f"k1-simt: E {e} {dt or 'float32'} G {g}"
                        f"{' (rule)' if groups is None else ''}: max-abs "
                        f"err {ab:.3e}, relative {rel:.3e} (tol {tol:g}); "
                        f"second launch bit-identical {same}")
                    require(rel <= tol and same
                            and bool(torch.isfinite(got).all()),
                            f"K1 SIMT E {e} {dt} G {g}")
        for name, layers, e, n in SIMT_SHAPES:
            kp, x, s, a = inputs(layers, e, n)
            reps = 3 if e > 100000 else 20
            k1 = lambda: fused_edge_messages(x, s, a, kp, in_channels=64,
                                             out_channels=64)
            r = dict(ms=time_ms(k1, reps), **k1_cost(kp, e, n))
            r.update(simt_turns(k1, x, s, a, kp, r["ms"], reps))
            r["plain_ms"] = time_ms(lambda: edge_messages_plain(
                x, s, a, kp, in_channels=64, out_channels=64), 2)
            set_bound(r)
            r["grid"] = k1_simt_grid(e, kp, 64, None, dev)
            if e < 100000:
                r["by_G"] = {g: round(time_ms(
                    lambda: simt_edge_messages(x, s, a, kp, in_channels=64,
                                               groups=g), reps), 4)
                    for g in range(1, 17) if -(-32 // -(-32 // g)) == g}
            log(f"k1-simt: {name} E {e} kappa {layers}: "
                + json.dumps({k: v for k, v in r.items()
                              if k not in ("flops", "bytes")}))


# ------------------------------------------------------------ phase 12

def par_gkn_config(impl):
    """neurips1_gkn at full width, the runner's model config."""
    from graph_pde_tpu_torch.experiments import get
    from graph_pde_tpu_torch.experiments.runners import _gkn_config

    return dataclasses.replace(_gkn_config(get("neurips1_gkn")), impl=impl)


def member0(g):
    """Sample 0 of a stacked host graph dataclass."""
    import numpy as np

    return dataclasses.replace(g, **{
        f.name: getattr(g, f.name)[0] for f in dataclasses.fields(g)
        if isinstance(getattr(g, f.name), np.ndarray)})


def par_inputs(dev) -> dict:
    """Phase 12's host inputs, built once: N_TRAIN Nystrom training
    graphs of neurips1_gkn (m=200, one a data rank) and its task, the
    s=61 serving graph, one s=85 mgkn_general_darcy2d multilevel graph
    and one s=1024 mgkn_orthogonal_burgers1d graph."""
    from graph_pde_tpu_torch.data import (burgers_dataset,
                                          burgers_multipole_data,
                                          darcy_dataset, darcy_gkn_graphs,
                                          darcy_mgkn_graphs, prepare_burgers,
                                          prepare_darcy)
    from graph_pde_tpu_torch.experiments import get
    from graph_pde_tpu_torch.experiments.runners import _task
    from graph_pde_tpu_torch.models import MultipoleGraph1D

    c = get("neurips1_gkn")
    fields = darcy_dataset(N_TRAIN, c.source_res, seed=c.data_seed)
    arrays, _ = prepare_darcy(fields, n=N_TRAIN, r=c.downsample,
                              u_norm=c.u_norm)
    train = darcy_gkn_graphs(arrays, m=c.nystrom_m, k=c.graphs_per_sample,
                             radius=c.radius_train, seed=c.seed)
    _, _, norms, _, full, _ = serving_setup(dev)
    m = get("mgkn_general_darcy2d")
    mfields = darcy_dataset(1, m.source_res, seed=m.data_seed)
    marrays, _ = prepare_darcy(mfields, n=1, r=m.downsample, u_norm=m.u_norm)
    mg, _ = darcy_mgkn_graphs(marrays, points=m.points,
                              radius_inner=m.radius_inner,
                              radius_inter=m.radius_inter, seed=m.seed)
    ba = prepare_burgers(burgers_dataset(1, S_ORTHO, seed=SEED), n=1)
    xs, _, se, re, at = burgers_multipole_data(ba)
    return {"train": train,
            "task": _task(c, par_gkn_config("auto"), arrays),
            "lr": c.learning_rate, "wd": c.weight_decay,
            "g61": full_graph_host(norms, full[0]), "mg85": member0(mg),
            "og": MultipoleGraph1D(x=xs[0], senders=list(se),
                                   receivers=list(re),
                                   attrs=[a[0] for a in at])}


def par_step(inp, dev, mesh=None):
    """The neurips1_gkn train step of phase 12 (impl='auto', the task's
    MSE loss, Adam with the registry's lr and weight decay) on the
    training batch, from the seeded parameters: single-process without
    ``mesh``; with a (data, model) mesh, DP + TP, each rank on its block
    of the batch and its shards of the kappa MLP. Returns the step
    function, the trainable tree, the rank's batch and a dict whose
    'grads' the first step fills, just before its Adam update, with the
    whole gradient tree (the TP shards gathered)."""
    import torch

    from graph_pde_tpu_torch import parallel as par
    from graph_pde_tpu_torch.models import gkn_init
    from graph_pde_tpu_torch.train import (adam_steplr, make_train_step,
                                           param_leaves, trainable)

    cfg = par_gkn_config("auto")
    params = trainable(gkn_init(torch.Generator().manual_seed(SEED), cfg,
                                device=dev), dev)
    batch = inp["train"].to(dev)
    group = None
    if mesh is not None:
        params = par.param_sharding(mesh, params)
        batch = par.batch_sharding(mesh, batch)
        group = mesh.get_group("data")
    opt, _ = adam_steplr(param_leaves(params), inp["lr"],
                         weight_decay=inp["wd"])
    seen = {}

    def snapshot(*_):
        if "grads" not in seen:
            seen["grads"] = par.gather_params(params, grad=True)

    opt.register_step_pre_hook(snapshot)
    return (make_train_step(inp["task"], opt, data_group=group), params,
            batch, seen)


def flat_tree(tree, prefix, out, grad=False) -> dict:
    """{path: numpy array} of a parameter tree's tensors (or their
    gradients)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            flat_tree(v, f"{prefix}/{k}", out, grad)
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            flat_tree(v, f"{prefix}/{i}", out, grad)
    else:
        t = tree.grad if grad else tree
        out[prefix] = t.detach().cpu().numpy().copy()
    return out


class RankRecorder:
    """A rank's results of phase 12: arrays, and each path's launches
    (counted from 0 just before it runs, read just after), host wall
    time and peak device memory."""

    def __init__(self):
        self.arrays, self.meta = {}, {"launches": {}, "ms": {},
                                      "peak_gib": {}}

    def run(self, name, fn, warm=False):
        import torch

        if warm:
            fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        self.meta["ms"][name] = (time.perf_counter() - t0) * 1e3
        self.meta["launches"][name] = read_counts()
        self.meta["peak_gib"][name] = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.empty_cache()
        return out

    def save(self, out_dir, rank) -> None:
        import os

        import numpy as np

        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **self.arrays)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(self.meta, f)


def parallel_rank(rank, port, inp_path, out_dir) -> None:
    """One of PAR_RANKS ranks of phase 12, all on cuda:0 over gloo: (a)
    the DP + TP train step on a (2, 2) mesh; on a 1-d mesh of every
    rank, (b) the node-sharded GKN on the s=61 serving graph (pallas,
    reference, ring) and its gradients on a training graph, (c) the
    node-sharded general MGKN (pallas, reference, gradients), (d) the
    node-sharded orthogonal MGKN (pallas, reference). Each path's
    launches must be its kernels' own, once a conv and depth step."""
    import pickle

    import torch
    import torch.distributed as dist

    from graph_pde_tpu_torch import parallel as par
    from graph_pde_tpu_torch.models import (gkn_init, mgkn_general_init,
                                            mgkn_orthogonal_init)
    from graph_pde_tpu_torch.train import trainable

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    with open(inp_path, "rb") as f:
        inp = pickle.load(f)
    par.initialize(f"localhost:{port}", PAR_RANKS, rank)
    require(dist.get_backend() == "gloo", "phase 12 ranks share the card "
            "over gloo")
    rec = RankRecorder()
    none = dict.fromkeys(COUNTED, 0)

    # (a) DP + TP on a (2, 2) mesh
    mesh2 = par.make_mesh((2, 2))
    step, p_tp, batch, seen = par_step(inp, dev, mesh2)
    rec.meta["tp_last_layer"] = list(p_tp["kernel"][-1]["w"].shape)
    m = rec.run("dp_tp step", lambda: step(p_tp, batch))
    rec.meta["dp_tp loss"] = float(m["loss"])
    flat_tree(par.gather_params(p_tp), "dp_tp", rec.arrays)
    flat_tree(seen["grads"], "dp_tp grads", rec.arrays)
    rec.run("dp_tp warm step", lambda: step(p_tp, batch))

    # (b)-(d) node sharding over every rank
    mesh1 = par.make_mesh((PAR_RANKS,), ("data",))
    group = mesh1.get_group("data")
    cfg = par_gkn_config("pallas")
    gen = torch.Generator()
    p0 = gkn_init(gen.manual_seed(SEED), cfg, device=dev)
    parts = par.partition_graph(inp["g61"], PAR_RANKS)
    ring = par.partition_graph_ring(inp["g61"], PAR_RANKS)
    mcfg = mgkn_config(impl="pallas")
    mp = mgkn_general_init(gen.manual_seed(SEED), mcfg, device=dev)
    mparts, mmeta = par.partition_multilevel_graph(inp["mg85"], PAR_RANKS)
    ocfg = ortho_config("pallas")
    op = mgkn_orthogonal_init(gen.manual_seed(SEED), ocfg, device=dev)
    oparts, ometa = par.partition_multipole1d(inp["og"], PAR_RANKS)
    fwd = {
        "gkn pallas": lambda i: par.gkn_apply_node_sharded(
            p0, cfg, parts, mesh1, impl=i),
        "gkn ring": lambda i: par.gkn_apply_node_sharded_ring(
            p0, cfg, ring, mesh1),
        "mgkn pallas": lambda i: par.mgkn_general_apply_node_sharded(
            mp, mcfg, mparts, mmeta, mesh1, impl=i),
        "ortho pallas": lambda i: par.mgkn_orthogonal_apply_node_sharded(
            op, ocfg, oparts, ometa, mesh1, impl=i),
    }
    auto = {"gkn": dataclasses.replace(cfg, impl="auto"),
            "mgkn": dataclasses.replace(mcfg, impl="auto"),
            "ortho": dataclasses.replace(ocfg, impl="auto")}
    step_want = expected(auto["gkn"], cfg.depth, cfg.depth)
    want = {"dp_tp step": step_want, "dp_tp warm step": step_want,
            "gkn pallas": expected(auto["gkn"], cfg.depth, 0),
            "mgkn pallas": expected_mgkn(auto["mgkn"], 1, 0),
            "ortho pallas": expected_ortho(auto["ortho"], 1, 0),
            "gkn grads": expected(auto["gkn"], cfg.depth, cfg.depth),
            "mgkn grads": expected_mgkn(auto["mgkn"], 1, 1)}
    with torch.no_grad():
        for name, fn in fwd.items():
            impls = ("ring",) if "ring" in name else ("pallas", "reference")
            for impl in impls:
                key = name.replace("pallas", impl)
                out = rec.run(key, lambda: fn(impl), warm=impl == "pallas")
                rec.arrays[key] = out.cpu().numpy()

    tg0 = member0(inp["train"])
    tparts = par.partition_graph(tg0, PAR_RANKS)
    n, n0 = int(tg0.n_node), mcfg.points[0]

    def grads(params, apply, rows):
        p = trainable(params, dev)
        (apply(p)[:rows] ** 2).sum().backward()
        par.allreduce_grads(p, group)
        return p

    p = rec.run("gkn grads", lambda: grads(p0, lambda q: (
        par.gkn_apply_node_sharded(q, cfg, tparts, mesh1, impl="pallas")), n))
    flat_tree(p, "gkn grads", rec.arrays, grad=True)
    p = rec.run("mgkn grads", lambda: grads(mp, lambda q: (
        par.mgkn_general_apply_node_sharded(q, mcfg, mparts, mmeta, mesh1,
                                            impl="pallas")), n0))
    flat_tree(p, "mgkn grads", rec.arrays, grad=True)
    for name, counts in rec.meta["launches"].items():
        require(counts == want.get(name, none),
                f"phase 12 rank {rank} {name}: launches "
                f"{({k: v for k, v in counts.items() if v})}")
    rec.save(out_dir, rank)
    dist.destroy_process_group()


@contextlib.contextmanager
def deterministic():
    """torch's deterministic algorithms (index_add_ without atomics), for
    runs compared bit for bit."""
    import warnings

    import torch

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # deterministic-mode notices
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            yield
        finally:
            torch.use_deterministic_algorithms(False)


def nccl_rank(rank, port, inp_path, out_dir) -> None:
    """A world of one rank on the card through ``initialize``'s backend
    rule (NCCL: every rank has a card of its own): phase 12's DP + TP
    step on a (1, 1) mesh over the whole batch, under deterministic
    algorithms as the single-process step it must equal bit for bit."""
    import pickle

    import torch
    import torch.distributed as dist

    from graph_pde_tpu_torch import parallel as par

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    with open(inp_path, "rb") as f:
        inp = pickle.load(f)
    par.initialize(f"localhost:{port}", 1, rank)
    require(dist.get_backend() == "nccl", "a world of one rank on one "
            "card takes NCCL")
    rec = RankRecorder()
    mesh = par.make_mesh((1, 1))
    step, p_tp, batch, seen = par_step(inp, dev, mesh)
    with deterministic():
        m = rec.run("dp_tp step", lambda: step(p_tp, batch))
    rec.meta["dp_tp loss"] = float(m["loss"])
    flat_tree(par.gather_params(p_tp), "dp_tp", rec.arrays)
    flat_tree(seen["grads"], "dp_tp grads", rec.arrays)
    rec.save(out_dir, "nccl")
    dist.destroy_process_group()


def load_rank(out_dir, rank) -> tuple:
    import os

    import numpy as np

    with np.load(os.path.join(out_dir, f"rank{rank}.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    with open(os.path.join(out_dir, f"rank{rank}.json")) as f:
        return arrays, json.load(f)


def close_leaves(name, got: dict, want: dict, tol=F32_TOL) -> float:
    """Each leaf of ``got`` within ``tol`` of ``want``'s max-abs (the same
    paths); returns the worst relative max-abs error."""
    import numpy as np

    require(got.keys() == want.keys() and len(got) > 0,
            f"{name}: the same leaves ({sorted(got)[:3]} ...)")
    worst = 0.0
    for k in want:
        a, b = np.asarray(got[k], np.float64), np.asarray(want[k], np.float64)
        require(a.shape == b.shape, f"{name} {k}: shape {a.shape} vs "
                f"{b.shape}")
        r = float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30)
        require(r <= tol and bool(np.isfinite(a).all()),
                f"{name} {k}: relative max-abs err {r:.3e} (tol {tol:g})")
        worst = max(worst, r)
    return worst


def prefixed(arrays, prefix) -> dict:
    return {k[len(prefix):]: v for k, v in arrays.items()
            if k.startswith(prefix + "/")}


def par_bucket_kernels(inp, dev) -> dict:
    """K1 and B1-bwd (fp32: the SIMT forms) against their plain versions
    at the shapes phase 12 gives them, timed beside plain and bound:
    rank 0's edge bucket of the s=61 graph (senders global ids into the
    all-gathered [S * n_loc, 64] features) and model rank 0's part of the
    DP + TP step on a training graph (32 input channels, the [256, 2048]
    last-layer shard)."""
    import torch

    from graph_pde_tpu_torch import parallel as par
    from graph_pde_tpu_torch.models import gkn_init
    from graph_pde_tpu_torch.ops.dense import dense_apply
    from graph_pde_tpu_torch.ops.fused_edge_conv import (
        edge_messages_bwd_plain, edge_messages_plain, fused_edge_messages,
        fused_edge_messages_bwd)

    cfg = par_gkn_config("pallas")
    kp = gkn_init(torch.Generator().manual_seed(SEED), cfg,
                  device=dev)["kernel"]
    parts = par.partition_graph(inp["g61"], PAR_RANKS)
    tg0 = member0(inp["train"])
    half = kp[:-1] + ({"w": kp[-1]["w"][:, :32 * 64].contiguous(),
                       "b": kp[-1]["b"][:32 * 64].contiguous()},)
    cases = {
        "s61_bucket": (torch.as_tensor(parts["senders"][0]),
                       torch.as_tensor(parts["edge_attr"][0]),
                       parts["x"].shape[0] * parts["x"].shape[1], 64, kp),
        "tp_shard": (torch.as_tensor(tg0.senders),
                     torch.as_tensor(tg0.edge_attr), tg0.x.shape[0], 32,
                     half),
    }
    gen = torch.Generator().manual_seed(SEED + 12)
    out = {}
    for case, (s, a, n, w_in, kpc) in cases.items():
        s, a, e = s.long().to(dev), a.to(dev), s.shape[0]
        x = torch.randn(n, w_in, generator=gen).to(dev)
        kw = dict(in_channels=w_in, out_channels=64)
        with torch.inference_mode():
            err = check_k1(f"{case} K1", x, s, a, kpc, w_in, None,
                           F32_TOL, "simt", phase=12)
            r = dict(ms=time_ms(lambda: fused_edge_messages(
                x, s, a, kpc, **kw), 3),
                     plain_ms=time_ms(lambda: edge_messages_plain(
                         x, s, a, kpc, **kw), 1),
                     max_abs_err=err, E=e, N=n,
                     **k1_cost(kpc, e, n, w_in=w_in))
            set_bound(r)
            out[("K1", case)] = r
            h2 = dense_apply(kpc[:-1], a, out_nonlinearity=torch.relu)
            g = torch.randn(e, 64, generator=gen).to(dev)
            wl = kpc[-1]["w"]
            err = check_b1_bwd(f"{case} B1-bwd", x, s, h2, g, wl,
                               64, None, F32_TOL, phase=12, w_in=w_in)
            kwd, c = wl.shape
            r = dict(ms=time_ms(lambda: fused_edge_messages_bwd(
                x, s, h2, g, wl, **kw), 3),
                     plain_ms=time_ms(lambda: edge_messages_bwd_plain(
                         x, s, h2, g, wl, **kw), 1),
                     max_abs_err=err, E=e, N=n,
                     flops=6.0 * e * kwd * c + 3.0 * e * c,
                     bytes=(4 * (e * kwd + n * w_in + e * 64 + kwd * c)
                            + 8 * e + 4 * (e * w_in + e * kwd + kwd * c
                                           + c)))
            set_bound(r)
            out[("B1-bwd", case)] = r
    for (k, case), r in out.items():
        log(f"phase 12: {k} at {case} (E {r['E']}, N {r['N']}): "
            f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, bound "
            f"{r['bound_ms']:.3f} ms ({r['bound_by']})")
    res = {}
    for (k, case), r in out.items():
        res.setdefault(k, {})[case] = {
            f: r[f] for f in ("ms", "plain_ms", "bound_ms", "bound_by",
                              "max_abs_err", "E", "N")}
    return res


def phase_parallel(dev) -> dict:
    """Phase 12: the parallel slice. PAR_RANKS ranks on the one card
    (gloo) run (a)-(d) of ``parallel_rank``; the parent holds every
    rank's results against single-process runs on the same card
    (F32_TOL of the reference's max-abs; every rank the same output),
    then a world of one rank (NCCL) takes the DP + TP step, which must
    equal the single-process step bit for bit."""
    import gc
    import os
    import pickle
    import tempfile

    import numpy as np
    import torch

    from graph_pde_tpu_torch.models import (gkn_apply, gkn_init,
                                            mgkn_general_apply,
                                            mgkn_general_init,
                                            mgkn_orthogonal_apply,
                                            mgkn_orthogonal_init)
    from graph_pde_tpu_torch.train import trainable

    # the ranks share the card: hand back what earlier phases cached (the
    # uai1 steps' float32 K alone took 22 GiB)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    inp = par_inputs(dev)
    log(f"phase 12: inputs built in {time.perf_counter() - t0:.1f} s: "
        f"{N_TRAIN} neurips1_gkn training graphs (E_pad "
        f"{inp['train'].senders.shape[1]}), s={S_FULL} graph (E_pad "
        f"{inp['g61'].senders.shape[0]}), general MGKN s={S_MGKN}, "
        f"orthogonal s={S_ORTHO}")
    with tempfile.TemporaryDirectory() as work:
        path = os.path.join(work, "inputs.pkl")
        with open(path, "wb") as f:
            pickle.dump(inp, f)
        t0 = time.perf_counter()
        codes = spawn_ranks(parallel_rank, PAR_RANKS,
                            (free_port(), path, work), PAR_TIMEOUT)
        log(f"phase 12: {PAR_RANKS} ranks (gloo, one card) exited {codes} "
            f"after {time.perf_counter() - t0:.1f} s")
        require(codes == [0] * PAR_RANKS, f"phase 12 rank exit codes {codes}")
        ranks = [load_rank(work, r) for r in range(PAR_RANKS)]
        codes = spawn_ranks(nccl_rank, 1, (free_port(), path, work),
                            PAR_TIMEOUT)
        require(codes == [0], f"phase 12 NCCL world exit code {codes}")
        nccl = load_rank(work, "nccl")
    res0 = ranks[0][0]
    for name in ("gkn pallas", "gkn reference", "gkn ring", "mgkn pallas",
                 "mgkn reference", "ortho pallas", "ortho reference"):
        for r in range(1, PAR_RANKS):
            require(np.array_equal(ranks[r][0][name], res0[name]),
                    f"phase 12 {name}: rank {r} holds rank 0's output")
    times = {"card": gpu_identity()}

    # (a) the single-process step, against DP + TP and the NCCL world
    step, params, batch, seen = par_step(inp, dev)
    with deterministic():
        m = step(params, batch)
    ref = flat_tree(params, "", {})
    ref_grads = flat_tree(seen["grads"], "", {})
    t1 = time.perf_counter()
    step(params, batch)
    torch.cuda.synchronize()
    times["single-process step ms"] = (time.perf_counter() - t1) * 1e3
    times["dp_tp warm step ms (rank 0)"] = \
        ranks[0][1]["ms"]["dp_tp warm step"]
    # every rank against one process: the ranks compute the replicated
    # layers each on its own, through index_add_'s atomics, so they
    # agree to rounding, not bit for bit
    loss_ref = float(m["loss"])
    losses = [ranks[r][1]["dp_tp loss"] for r in range(PAR_RANKS)]
    loss_err = max(abs(v - loss_ref) for v in losses) / abs(loss_ref)
    require(loss_err <= F32_TOL, f"phase 12 (a) DP + TP loss {losses} vs "
            f"single-process {loss_ref!r}")
    worst_g = max(close_leaves(f"phase 12 (a) rank {r} DP + TP gradients",
                               prefixed(ranks[r][0], "dp_tp grads"),
                               ref_grads) for r in range(PAR_RANKS))
    worst_a = max(close_leaves(f"phase 12 (a) rank {r} DP + TP step",
                               prefixed(ranks[r][0], "dp_tp"), ref)
                  for r in range(PAR_RANKS))
    log(f"phase 12: (a) DP + TP step (2, 2) losses {losses} vs "
        f"single-process {loss_ref!r} (worst relative err "
        f"{loss_err:.3e}); every rank's gradients before the update, "
        f"worst relative max-abs err {worst_g:.3e}; updated parameters "
        f"{worst_a:.3e} (tol {F32_TOL:g})")
    kw, c = 256, 64 * 64
    for r in range(PAR_RANKS):
        last = ranks[r][1]["tp_last_layer"]
        require(last != [kw, c] and last[0] * last[1] == kw * c // 2,
                f"phase 12 rank {r} holds {last} of the [kw, w^2] layer")
    same = (all(np.array_equal(nccl[0][f"dp_tp{k}"], v)
                for k, v in ref.items())
            and all(np.array_equal(nccl[0][f"dp_tp grads{k}"], v)
                    for k, v in ref_grads.items())
            and nccl[1]["dp_tp loss"] == loss_ref)
    log(f"phase 12: NCCL world of one rank, (1, 1) mesh: step bit-equal to "
        f"the single-process step {same} (loss {nccl[1]['dp_tp loss']!r} "
        f"vs {loss_ref!r}; gradients and updated parameters)")
    require(same, "phase 12 NCCL (1, 1) step equals the single-process "
            "step bit for bit")

    # (b)-(d) single-process forwards and gradients on the card
    gen = torch.Generator()
    cfg = par_gkn_config("pallas")
    p0 = gkn_init(gen.manual_seed(SEED), cfg, device=dev)
    mcfg = mgkn_config(impl="pallas")
    mp = mgkn_general_init(gen.manual_seed(SEED), mcfg, device=dev)
    ocfg = ortho_config("pallas")
    op = mgkn_orthogonal_init(gen.manual_seed(SEED), ocfg, device=dev)
    g61, mg, og = (inp["g61"].to(dev), inp["mg85"].to(dev),
                   inp["og"].to(dev))
    single = {"gkn": lambda: gkn_apply(p0, cfg, g61),
              "mgkn": lambda: mgkn_general_apply(mp, mcfg, mg),
              "ortho": lambda: mgkn_orthogonal_apply(op, ocfg, og)}
    errs = {}
    n61 = int(inp["g61"].n_node)
    with torch.inference_mode():
        for model, fn in single.items():
            want = fn().cpu().numpy()
            rows = n61 if model == "gkn" else want.shape[0]
            for impl in (("pallas", "reference", "ring") if model == "gkn"
                         else ("pallas", "reference")):
                key = f"{model} {impl}"
                errs[key] = close_leaves(f"phase 12 {key}",
                                         {0: res0[key][:rows]},
                                         {0: want[:rows]})
        times["gkn forward ms, single process"] = time_ms(single["gkn"], 3)
    times["gkn pallas forward ms, sharded (rank 0)"] = \
        ranks[0][1]["ms"]["gkn pallas"]
    tg0 = member0(inp["train"])
    n = int(tg0.n_node)
    for model, params, apply, rows in (
            ("gkn", p0, lambda q: gkn_apply(q, cfg, tg0.to(dev)), n),
            ("mgkn", mp, lambda q: mgkn_general_apply(q, mcfg, mg),
             mcfg.points[0])):
        p = trainable(params, dev)
        (apply(p)[:rows] ** 2).sum().backward()
        errs[f"{model} grads"] = close_leaves(
            f"phase 12 {model} gradients",
            prefixed(res0, f"{model} grads"), flat_tree(p, "", {},
                                                        grad=True))
    log(f"phase 12: (b)-(d) sharded against single-process on the card, "
        f"worst relative max-abs err per path {json.dumps(errs)} (tol "
        f"{F32_TOL:g})")

    launches = {name: [ranks[r][1]["launches"][name]
                       for r in range(PAR_RANKS)]
                for name in ranks[0][1]["launches"]}
    for name in ("dp_tp step", "gkn pallas", "mgkn pallas", "ortho pallas",
                 "gkn grads", "mgkn grads"):
        require(all(c["K1"] > 0 for c in launches[name]),
                f"phase 12 {name}: every rank launched K1")
    for name in ("dp_tp step", "gkn grads", "mgkn grads"):
        require(all(c["B1-bwd"] > 0 for c in launches[name]),
                f"phase 12 {name}: every rank launched B1-bwd")
    peak = {name: [round(ranks[r][1]["peak_gib"][name], 3)
                   for r in range(PAR_RANKS)]
            for name in ranks[0][1]["peak_gib"]}
    log("phase 12: each rank's peak device memory (GiB) "
        + json.dumps(peak))
    log("phase 12: rank wall times (ms) " + json.dumps(
        {name: [round(ranks[r][1]["ms"][name], 1) for r in range(PAR_RANKS)]
         for name in ranks[0][1]["ms"]}))
    bucket = par_bucket_kernels(inp, dev)
    return {"launches": launches, "errs": errs, "times": times,
            "bucket": bucket}


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_ranks(target, world: int, args: tuple, timeout: float) -> list:
    """Runs ``target(rank, *args)`` in ``world`` processes (start method
    spawn) and returns their exit codes; a process still running at the
    deadline is killed (exit code None)."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r,) + args)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    codes = []
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
        if p.is_alive():
            p.kill()
            p.join()
            codes.append(None)
        else:
            codes.append(p.exitcode)
    return codes


GLOO_OPS = ("broadcast", "all_reduce", "all_gather_into_tensor",
            "reduce_scatter_tensor", "batch_isend_irecv", "device_mesh")


def gloo_probe_rank(rank, op, port, out_dir) -> None:
    """One rank of a 2-rank gloo group on cuda:0: runs ``op`` on CUDA
    tensors and writes what happened (ok, wrong values, or the error
    gloo raised) to out_dir/op-rank.json."""
    import os

    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=rank)
    dev = torch.device("cuda", 0)
    x = torch.arange(4.0, device=dev) + 10 * rank
    try:
        if op == "broadcast":
            dist.broadcast(x, src=0)
            got, want = x, torch.arange(4.0)
        elif op == "all_reduce":
            dist.all_reduce(x)
            got, want = x, 2 * torch.arange(4.0) + 10
        elif op == "all_gather_into_tensor":
            got = torch.empty(8, device=dev)
            dist.all_gather_into_tensor(got, x)
            want = torch.cat([torch.arange(4.0), torch.arange(4.0) + 10])
        elif op == "reduce_scatter_tensor":
            got = torch.empty(2, device=dev)
            dist.reduce_scatter_tensor(got, x)
            want = (2 * torch.arange(4.0) + 10)[2 * rank:2 * rank + 2]
        elif op == "batch_isend_irecv":
            got = torch.empty(4, device=dev)
            ops = [dist.P2POp(dist.isend, x, 1 - rank),
                   dist.P2POp(dist.irecv, got, 1 - rank)]
            for w in dist.batch_isend_irecv(ops):
                w.wait()
            want = torch.arange(4.0) + 10 * (1 - rank)
        else:
            from torch.distributed.device_mesh import init_device_mesh

            mesh = init_device_mesh("cuda", (2, 1),
                                    mesh_dim_names=("data", "model"))
            got = x.clone()
            dist.all_reduce(got, group=mesh.get_group("data"))
            want = 2 * torch.arange(4.0) + 10
        torch.cuda.synchronize()
        res = ("ok" if torch.equal(got.cpu(), want)
               else f"wrong values {got.cpu().tolist()}")
    except Exception as e:  # the probe records what gloo says
        res = f"{type(e).__name__}: {str(e)[:300]}"
    with open(os.path.join(out_dir, f"{op}-{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


def gloo_probe() -> None:
    """--gloo-probe: which torch.distributed ops gloo takes on CUDA
    tensors, each op in its own 2-rank group on cuda:0 (all groups at
    once), logged per op and rank."""
    import os
    import tempfile

    import torch

    log(f"gloo-probe: torch {torch.__version__}, CUDA {torch.version.cuda}")
    with tempfile.TemporaryDirectory() as out:
        import threading

        results = {}

        def run(op):
            results[op] = spawn_ranks(gloo_probe_rank, 2,
                                      (op, free_port(), out), 180)

        threads = [threading.Thread(target=run, args=(op,))
                   for op in GLOO_OPS]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for op in GLOO_OPS:
            said = []
            for r in range(2):
                p = os.path.join(out, f"{op}-{r}.json")
                said.append(json.load(open(p)) if os.path.exists(p)
                            else "no result")
            log(f"gloo-probe: {op}: exit codes {results[op]}, {said}")


def log_ptxas(logs, phase=1) -> None:
    """Each built kernel's registers, spills and wgmma serialization
    notes from its compiler log (``-Xptxas -v``)."""
    for name, text in logs.items():
        entry = "?"
        for line in text.splitlines():
            if "Compiling entry function" in line:
                # the kernel's (mangled) name, as ptxas names it, without
                # its file's anonymous namespace
                entry = line.split("'")[1] if "'" in line else line
                entry = re.sub(r"\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "",
                               entry)
            elif "registers" in line or "spill" in line or "C75" in line:
                log(f"phase {phase}: {name}: {entry[:90]}: "
                    f"{line.strip()[:200]}")


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from graph_pde_tpu_torch.ops import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    ident = gpu_identity()
    log(ident)
    if argv[:1] == ["--grad-spread"]:
        grad_spread(int(argv[1]) if len(argv) > 1 else 8)
        log(ident)
        return 0
    if argv[:1] == ["--grad-locate"]:
        grad_locate()
        log(ident)
        return 0
    if argv[:1] == ["--k1-simt"]:
        from graph_pde_tpu_torch.ops import kernels

        log_ptxas(kernels.build(["fused_edge_conv"]), "k1-simt")
        k1_simt_probe()
        log(ident)
        return 0
    if argv[:1] == ["--gloo-probe"]:
        gloo_probe()
        log(ident)
        return 0
    if argv[:1] == ["--gcn"]:
        log("phase 10: gcn " + json.dumps(phase_gcn()))
        log(ident)
        return 0
    if argv[:1] == ["--torus"]:
        t0 = time.perf_counter()
        kernels.build(["fused_edge_conv", "fused_edge_conv_bwd"])
        log(f"phase 1: built K1 and B1-bwd in {time.perf_counter() - t0:.1f} "
            f"s")
        torus = phase_torus(dev)
        log("phase 11: torus slice " + json.dumps(dict(
            torus["steps"], native=torus["native"],
            loop_vjp_uai1=torus["loop_vjp_uai1"])))
        log(ident)
        return 0
    if argv[:1] == ["--parallel"]:
        t0 = time.perf_counter()
        kernels.build(["fused_edge_conv", "fused_edge_conv_bwd"])
        log(f"phase 1: built K1 and B1-bwd in {time.perf_counter() - t0:.1f} "
            f"s")
        par = phase_parallel(dev)
        log("phase 12: parallel slice " + json.dumps(
            dict(times=par["times"], bucket=par["bucket"])))
        log(ident)
        return 0
    if argv[:1] == ["--b3"]:
        kernels.build(["cached_contraction"])
        log("b3 cells " + json.dumps(b3_cells()))
        log(ident)
        return 0
    if argv[:1] == ["--uai1"]:
        import os
        import shutil
        import tempfile

        kernels.build(["fused_iterate", "fused_iterate_bwd",
                       "cached_contraction"])
        here, tmp = os.getcwd(), tempfile.mkdtemp(prefix="chip_smoke_cli_")
        os.chdir(tmp)
        try:
            cli_uai1()
        finally:
            os.chdir(here)
            shutil.rmtree(tmp, ignore_errors=True)
        uai1_turns()
        log(ident)
        return 0
    if argv[:1] == ["--mgkn"]:
        from graph_pde_tpu_torch.ops import kernels

        kernels.build()
        mgkn = phase_mgkn()
        log("phase 9: general MGKN slice " + json.dumps(
            dict(mgkn["steps"], predict=mgkn["predict"])))
        log(ident)
        return 0
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    logs = kernels.build()
    log(f"phase 1: built {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    log_ptxas(logs)
    from graph_pde_tpu_torch.ops.fused_edge_conv import k1_tc_occupancy

    smem, blocks = k1_tc_occupancy(256, 64)
    log(f"phase 1: K1 tc form at kw2 256, in 64: {smem} bytes of dynamic "
        f"shared memory a block, {blocks} blocks an SM")

    from graph_pde_tpu_torch.models import gkn_init
    from graph_pde_tpu_torch.models.gkn import _member

    cfg, params, norms, u_norm, full, split = serving_setup(dev)
    g, h = full_graph(dev, params, norms, full[0])
    arr4, train4 = training_data(N_TRAIN, S_UAI4, R_UAI4, "unit", 512, SEED)
    arr1, train1 = training_data(N_TRAIN, S_UAI1, R_UAI1, "gaussian", 0,
                                 SEED + 1)
    g4 = _member(train4.to(dev), 0)
    g1 = _member(train1.to(dev), 0)
    kp4 = gkn_init(torch.Generator().manual_seed(SEED), uai4_config(),
                   device=dev)["kernel"]
    kp1 = gkn_init(torch.Generator().manual_seed(SEED), uai1_config(),
                   device=dev)["kernel"]

    clock = [time.perf_counter()]

    def lap(what):
        now = time.perf_counter()
        log(f"{what}: {now - clock[0]:.1f} s")
        clock[0] = now

    errs = phase_kernels_vs_plain(g, h, params)
    errs.update(phase_backward_vs_plain(g4, kp4, g1, kp1))
    errs.update(phase_k1_tc_vs_plain(g4, kp4))
    phase_general_forms(g, dev)
    errs.update(phase_b3_vs_plain(g1, kp1))
    errs.update(phase_fp8_vs_plain(g1, kp1))
    lap("phase 2 wall time")
    launches = phase_serving(cfg, params, norms, u_norm, full, split)
    b3_launches = phase_b3_op(g1, kp1)
    lap("phase 3 wall time")
    times = phase_times(g, h, params)
    forward_times(g, cfg, params)
    lap("phase 4 wall time")

    uai1_fp8 = dataclasses.replace(uai1_config(), compute_dtype="bfloat16",
                                   k_storage="float8_e4m3")
    trained = {
        "uai4 train": phase_training("uai4", uai4_config(), arr4, train4,
                                     "mse", "unit", 0.5),
        "uai1 train": phase_training("uai1", uai1_config(), arr1, train1,
                                     "l1", "gaussian", 0.8),
        "uai1 fp8 train": phase_training("uai1 fp8", uai1_fp8, arr1, train1,
                                         "l1", "gaussian", 0.8)}
    for k in ("uai1 train", "uai1 fp8 train"):
        log(f"phase 5: {k}: warm step {trained[k]['warm_step_ms']:.1f} ms, "
            f"peak device memory {trained[k]['peak_gib']:.2f} GiB")
    grads = {
        "grad uai4 (fp32)": phase_train_grads(
            "uai4 (fp32)", uai4_config(None),
            dataclasses.replace(uai4_config(None), impl="scan"), "mse",
            "unit", S_GRAD4, R_GRAD4, 512),
        "grad uai4 (bf16)": phase_train_grads(
            "uai4 (bf16)", uai4_config(), uai4_config(), "mse", "unit",
            S_GRAD4, R_GRAD4, 512, tol=GRAD_BF16_TOL,
            plain_ctx=plain_on_card),
        "grad uai1": phase_train_grads(
            "uai1", uai1_config(),
            dataclasses.replace(uai1_config(), kcached_fused="off"), "l1",
            "gaussian", S_GRAD1, R_GRAD1, 0)}
    # fp8 K: e4m3 against the Functions' plain versions on the card (the
    # unfused path rounds x to bf16 in its products); e5m2, whose two
    # correct bf16 roundings part by up to 1.2e-2, against float64
    e4m3 = dataclasses.replace(uai1_fp8, k_storage="float8_e4m3")
    grads["grad uai1 float8_e4m3"] = phase_train_grads(
        "uai1 float8_e4m3", e4m3, e4m3, "l1", "gaussian", S_GRAD1, R_GRAD1,
        0, tol=GRAD_BF16_TOL, plain_ctx=plain_on_card)
    grads["grad uai1 float8_e5m2"] = phase_fp8_grads("float8_e5m2")
    lap("phase 5 wall time")
    times.update(backward_times(g4, kp4, g1, kp1))
    times.update(b3_fp8_times(g1, kp1))
    lap("phase 6 wall time")
    log("phase 6: training step times " + json.dumps(
        {k: dict(warm_step_ms=v["warm_step_ms"], step_ms=v["step_ms"],
                 peak_gib=v["peak_gib"]) for k, v in trained.items()}))
    cli_paths = phase_cli(trained["uai1 train"]["warm_step_ms"])
    lap("phase 7 wall time")
    ortho = phase_ortho()
    errs.update(ortho["errs"])
    times.update(ortho["times"])
    lap("phase 8 wall time")
    log("phase 8: orthogonal slice " + json.dumps(
        dict(ortho["steps"], neurips5=ortho["neurips5"])))
    mgkn = phase_mgkn()
    errs.update(mgkn["errs"])
    times.update(mgkn["times"])
    lap("phase 9 wall time")
    log("phase 9: general MGKN slice " + json.dumps(
        dict(mgkn["steps"], predict=mgkn["predict"])))
    gcn = phase_gcn()
    lap("phase 10 wall time")
    log("phase 10: gcn " + json.dumps(gcn))
    torus = phase_torus(dev)
    errs.update(torus["errs"])
    times.update(torus["times"])
    lap("phase 11 wall time")
    log("phase 11: torus slice " + json.dumps(dict(
        torus["steps"], native=torus["native"],
        loop_vjp_uai1=torus["loop_vjp_uai1"])))
    par = phase_parallel(dev)
    lap("phase 12 wall time")
    log("phase 12: parallel slice " + json.dumps(
        dict(times=par["times"], bucket=par["bucket"])))

    by_path = {f"serving {k}": v for k, v in launches.items()}
    by_path.update({k: v["launches"] for k, v in trained.items()})
    by_path.update(grads)
    by_path.update(b3_launches)
    by_path.update(cli_paths["launches"])
    by_path.update(ortho["launches"])
    by_path.update(mgkn["launches"])
    by_path.update(torus["launches"])

    def count(key, counts):
        """A form's launches in one path's counts: K2 and B2-bwd count
        every launch, so their fp32/bf16 form is the rest after the fp8
        forms; the B3 forms are the B3 op paths of their K dtype."""
        if key in ("K2", "B2-bwd"):
            return counts[key] - counts[f"{key} e4m3"] - counts[f"{key} e5m2"]
        return counts.get(key, 0)

    def record(name, key, source, replaces, err_key, counter=None,
               paths=None, form=None, **extra):
        t = times[key]
        counter = counter or key
        chosen = {k: v for k, v in by_path.items()
                  if paths is None or k in paths}
        by = {k: count(counter, v) for k, v in chosen.items()}
        rec = dict(name=name, route="cuda",
                   source=f"graph_pde_tpu_torch/csrc/{source}",
                   replaces=f"graph_pde_tpu/ops/{replaces}",
                   launches=sum(by.values()), launches_by_path=by,
                   max_abs_err=errs[err_key], ms=t["ms"],
                   plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                   bound_by=t["bound_by"], library_ms=t["library_ms"])
        if "library_note" in t:
            rec["library_note"] = t["library_note"]
        if form:   # the kernel form, and where it was redesigned, the
            # replaced design's time on the same inputs in this run
            rec["form"] = form
            for f in ("previous_form_ms", "device_ms",
                      "previous_form_device_ms", "kernels_ms"):
                if f in t:
                    rec[f] = t[f]
        rec.update(extra)
        return rec

    b3_paths = {dt: [f"B3 op, K {dt}"]
                for dt in ("float32", "bfloat16")}
    # K2's fp8 forms beside its bf16 form on the same graph in this run
    k2_bf16 = dict(bf16_k_same_graph_ms=times["K2 uai1 bfloat16"]["ms"])
    records = [
        record("K1 fused_edge_messages", "K1", "fused_edge_conv.cu",
               "pallas_edge_conv.py:279", "K1 float32", counter="K1 simt",
               form="simt", grid=times["K1"]["grid"]),
        record("K1 fused_edge_messages, bf16", "K1 bf16",
               "fused_edge_conv.cu", "pallas_edge_conv.py:279", "K1 tc",
               counter="K1 tc", form="tc"),
        record("K2 fused_iterate_total", "K2", "fused_iterate.cu",
               "fused_iterate.py:61", "K2 K=bfloat16"),
        record("B1-bwd fused_edge_messages_bwd", "B1-bwd",
               "fused_edge_conv_bwd.cu", "pallas_edge_conv.py:347",
               "B1-bwd bfloat16", counter="B1-bwd tc", form="tc"),
        record("B2-bwd fused_iterate_bwd", "B2-bwd", "fused_iterate_bwd.cu",
               "fused_iterate.py:85", "B2-bwd K=bfloat16", form="warp"),
        record("K2 fused_iterate_total, fp8 e4m3 K", "K2 e4m3",
               "fused_iterate.cu", "fused_iterate.py:61", "K2 e4m3",
               form="fp8", **k2_bf16),
        record("K2 fused_iterate_total, fp8 e5m2 K", "K2 e5m2",
               "fused_iterate.cu", "fused_iterate.py:61", "K2 e5m2",
               form="fp8", **k2_bf16),
        record("B2-bwd fused_iterate_bwd, fp8 e4m3 K", "B2-bwd e4m3",
               "fused_iterate_bwd.cu", "fused_iterate.py:85", "B2-bwd e4m3",
               form="warp"),
        record("B2-bwd fused_iterate_bwd, fp8 e5m2 K", "B2-bwd e5m2",
               "fused_iterate_bwd.cu", "fused_iterate.py:85", "B2-bwd e5m2",
               form="warp"),
    ] + [
        record(f"{k} cached_contraction{'_bwd' if k == 'B3-bwd' else ''}, "
               f"{dt} K", f"{k} {dt}", "cached_contraction.cu",
               "cached_contraction.py:" + ("62" if k == "B3-fwd" else "78"),
               f"{k} {dt}", counter=k, paths=b3_paths[dt])
        for k in ("B3-fwd", "B3-bwd") for dt in ("float32", "bfloat16")]
    # the orthogonal path's fp32 forms, at its widest level (kw 1024),
    # with the kw 512 level beside it, each with its call's grid
    records += [
        record(name, f"{key} ortho kw1024", source, replaces,
               f"{err} ortho float32", counter=key, form=key.split()[-1],
               grid=times[f"{key} ortho kw1024"]["grid"],
               at_kw512={f: times[f"{key} ortho kw512"][f]
                         for f in ("ms", "plain_ms", "bound_ms", "grid")},
               orthogonal_step_excess_ms=times[f"{key} ortho kw1024"][
                   "step_excess_ms"])
        for name, key, source, replaces, err in (
            ("K1 fused_edge_messages, general form", "K1 general",
             "fused_edge_conv.cu", "pallas_edge_conv.py:279", "K1 general"),
            ("B1-bwd fused_edge_messages_bwd, fp32 SIMT form",
             "B1-bwd simt", "fused_edge_conv_bwd.cu",
             "pallas_edge_conv.py:347", "B1-bwd"))]
    # the general MGKN path's fp32 forms at its dominant conv (mid level
    # 0, the general form) and its SIMT conv (mid level 1), with every
    # conv shape's times beside them; launches are that path's
    mgkn_paths = [k for k in mgkn["launches"] if "kcached" not in k]
    shapes = times["mgkn shapes"]
    records += [
        record(name, key, source, replaces, err, counter=counter,
               paths=mgkn_paths, form=counter.split()[-1],
               grid=times[key]["grid"],
               mgkn_step_excess_ms=times[key]["step_excess_ms"],
               mgkn_shapes=shapes)
        for name, key, counter, source, replaces, err in (
            ("K1 fused_edge_messages, general form, general MGKN",
             "K1 general mgkn mid0", "K1 general", "fused_edge_conv.cu",
             "pallas_edge_conv.py:279", "K1 general mgkn float32"),
            ("K1 fused_edge_messages, fp32 SIMT form, general MGKN",
             "K1 simt mgkn mid1", "K1 simt", "fused_edge_conv.cu",
             "pallas_edge_conv.py:279", "K1 simt mgkn float32"),
            ("B1-bwd fused_edge_messages_bwd, fp32 SIMT form, general MGKN",
             "B1-bwd simt mgkn mid0", "B1-bwd simt",
             "fused_edge_conv_bwd.cu", "pallas_edge_conv.py:347",
             "B1-bwd mgkn float32"))]
    # K1 SIMT's other small-E shape, the orthogonal kw-128 level, beside
    # its general-MGKN record
    for r in records:
        if r["name"] == ("K1 fused_edge_messages, fp32 SIMT form, "
                         "general MGKN"):
            r["at_ortho_kw128"] = {
                f: times["K1 simt ortho kw128"][f]
                for f in ("ms", "plain_ms", "bound_ms", "previous_form_ms",
                          "device_ms", "previous_form_device_ms", "grid",
                          "step_excess_ms")}
    # the torus conv's shapes beside the forms' records: K1 general and
    # B1-bwd SIMT in fp32 (the torus auto path's), B1-bwd's tensor-core
    # form in bf16, each with that path's launches
    torus_paths = [k for k in torus["launches"]]
    for r in records:
        at = {"K1 fused_edge_messages, general form": "K1 general",
              "B1-bwd fused_edge_messages_bwd, fp32 SIMT form":
                  "B1-bwd simt",
              "B1-bwd fused_edge_messages_bwd": "B1-bwd tc"}.get(r["name"])
        if at is None:
            continue
        r["at_torus"] = {
            "launches": sum(count(at, by_path[k]) for k in torus_paths),
            "max_abs_err": torus["errs"][
                ("K1 general" if at == "K1 general" else "B1-bwd")
                + (" torus bfloat16" if at.endswith("tc")
                   else " torus float32")]}
        for e in TORUS_E:
            key = (f"{at} torus E{e} float32" if at == "K1 general"
                   else f"{at} torus E{e}")
            r["at_torus"][f"E{e}"] = {f: times[key][f] for f in (
                "ms", "plain_ms", "bound_ms", "bound_by", "grid",
                "kernels_ms") if f in times[key]}
            if at == "K1 general":
                bf = times[f"K1 general torus E{e} bfloat16"]
                r["at_torus"][f"E{e} bf16"] = {
                    f: bf[f] for f in ("ms", "plain_ms", "bound_ms")}
    # the parallel slice's launches, per path and per rank, beside the
    # records of the forms it runs (fp32: K1 SIMT and general, B1-bwd
    # SIMT), with K1's and B1-bwd's SIMT forms at rank 0's s=61 bucket
    # and at the DP + TP step's shard
    for r in records:
        at = {"K1 fused_edge_messages": "K1 simt",
              "K1 fused_edge_messages, general form": "K1 general",
              "B1-bwd fused_edge_messages_bwd, fp32 SIMT form":
                  "B1-bwd simt"}.get(r["name"])
        if at is None:
            continue
        r["at_parallel"] = {"launches": {
            path: [c[at] for c in per_rank]
            for path, per_rank in par["launches"].items()
            if any(c[at] for c in per_rank)}}
        if at != "K1 general":
            r["at_parallel"].update(par["bucket"][at.split()[0]])
        require(all(all(v > 0 for v in per_rank) for per_rank in
                    r["at_parallel"]["launches"].values())
                and r["at_parallel"]["launches"],
                f"{at}: launched by every rank of the parallel slice")
    require(all(r["launches"] > 0 for r in records),
            "every kernel form launched on its main path")
    log(json.dumps({"kernels": records}))
    log(ident)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
