#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (graph_pde_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root

Phases, each fatal on failure:
  1. card identity (nvidia-smi) and the build of every CUDA kernel;
  2. each kernel against its plain PyTorch version on the card, at the
     serving shapes (a real s=61, r=0.2 Darcy graph; an edge slice where
     the plain version materialises [E, 64, 64]); then the kernels'
     general forms at registry shapes the serving path does not reach;
  3. serving: the full-width neurips1 GKN (random weights from a seed,
     Gaussian normalizers fitted on synthetic Darcy samples) answers
     requests through GKNPredictor.predict at s=61 (full graph) and
     s=241 (split path), under impl='auto' (kernel K1) and
     impl='kcached', kcached_fused='on' (kernel K2). Both launch
     counters are zeroed just before each (impl, request) and read just
     after: the path's own kernel must launch once per depth step, the
     other never. Outputs must be finite, and the impls must agree with
     each other and with plain-path (impl='scan') requests at s=61 and
     s=241;
  4. per-kernel times at the s=61 shapes (CUDA events), bounds, plain
     and library times, and the latency of each request.

Prints one JSON line of kernel records before the last line, and as the
last line {"ok": true, "device": {...}}. Exits non-zero, with no result
line, when there is no CUDA device or a phase fails.
"""
from __future__ import annotations

import dataclasses
import json
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
F32_TOL = 1e-4       # max-abs error / max-abs output, fp32
BF16_TOL = 5e-3      # the same, where bf16 rounding enters

# H100 SXM peaks (NVIDIA data sheet): fp32 SIMT rate and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


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
    import numpy as np
    import torch

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
    g = build_graph(x, ei[0], ei[1], attr,
                    sample_idx=np.arange(S_FULL * S_FULL),
                    n_edge_pad=round_up(ei.shape[1], 512)).to(dev)
    with torch.inference_mode():
        h = g.x @ params["fc1"]["w"] + params["fc1"]["b"]
    return g, h


def phase_kernels_vs_plain(g, h, params) -> dict:
    """Each kernel against its plain version on the first SLICE edges."""
    import torch

    from graph_pde_tpu_torch.ops.dense import dense_apply
    from graph_pde_tpu_torch.ops.fused_edge_conv import (
        edge_messages_plain, fused_edge_messages)
    from graph_pde_tpu_torch.ops.fused_iterate import (
        fused_iterate_total, fused_iterate_total_plain, sorted_iterate_setup)

    kp = params["kernel"]
    s, a = g.senders[:SLICE], g.edge_attr[:SLICE]
    errs = {}
    with torch.inference_mode():
        for dt, tol in ((None, F32_TOL), ("bfloat16", BF16_TOL)):
            got = fused_edge_messages(h, s, a, kp, in_channels=64,
                                      out_channels=64, compute_dtype=dt)
            want = edge_messages_plain(h, s, a, kp, in_channels=64,
                                       out_channels=64, compute_dtype=dt)
            torch.cuda.synchronize()
            ab, rel = rel_err(got, want)
            name = f"K1 {dt or 'float32'}"
            log(f"phase 2: {name}: max-abs err {ab:.3e}, "
                f"relative {rel:.3e} (tol {tol:g})")
            require(rel <= tol and bool(torch.isfinite(got).all()), name)
            errs[name] = ab
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


def phase_general_forms(g, dev) -> dict:
    """K1's general form and K2's column passes against the plain
    versions, at shapes of registry configs that the serving path does
    not reach: the ker_width=1024 'nn' kappa (6, 1024, 1024, 4096), a
    width-16 kappa (6, 16, 32, 256), K2 at width 128 (K rows of 16384)
    and at width 12 (the element-wise path). On the first GENERAL_SLICE
    edges of the s=61 graph, weights and features from a seed."""
    import torch

    from graph_pde_tpu_torch.ops.dense import (dense_apply, dense_init,
                                               layer_dims)
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
    with torch.inference_mode():
        for layers, w in (((6, 1024, 1024, 4096), 64), ((6, 16, 32, 256), 16)):
            kp = dense_init(gen, layers, device=dev)
            require(not kernel_shape_supported(layer_dims(kp), w, w),
                    f"{layers} takes the general form")
            x = torch.randn(n, w, generator=gen).to(dev)
            for dt, tol in ((None, F32_TOL), ("bfloat16", BF16_TOL)):
                got = fused_edge_messages(x, s, a, kp, in_channels=w,
                                          out_channels=w, compute_dtype=dt)
                want = edge_messages_plain(x, s, a, kp, in_channels=w,
                                           out_channels=w, compute_dtype=dt)
                torch.cuda.synchronize()
                ab, rel = rel_err(got, want)
                name = f"K1 general {layers} {dt or 'float32'}"
                log(f"phase 2: {name}: max-abs err {ab:.3e}, relative "
                    f"{rel:.3e} (tol {tol:g})")
                require(rel <= tol and bool(torch.isfinite(got).all()), name)
                errs[name] = ab
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
    return errs


def phase_serving(cfg, params, norms, u_norm, full, split) -> dict:
    """Requests through GKNPredictor.predict on the default device. Both
    launch counters are zeroed just before each (impl, request) path and
    read just after it: the path's own kernel must launch once per depth
    step and batch, the other kernel never. Returns the launches of each
    path."""
    import numpy as np
    import torch

    from graph_pde_tpu_torch.inference import GKNPredictor
    from graph_pde_tpu_torch.ops.fused_edge_conv import fused_edge_messages
    from graph_pde_tpu_torch.ops.fused_iterate import fused_iterate_total

    cfgs = {"auto": cfg,
            "kcached": dataclasses.replace(cfg, impl="kcached",
                                           kcached_fused="on")}
    own = {"auto": "K1", "kcached": "K2"}
    preds = {k: GKNPredictor(params, c, norms, u_norm, radius=RADIUS,
                             split_threshold=SPLIT_THRESHOLD)
             for k, c in cfgs.items()}
    requests = [(f"s={S_FULL} #{j}", full[j:j + 1])
                for j in range(len(full))]
    requests.append((f"s={S_SPLIT} split", split))
    outs, lat, launches = {}, {}, {}

    for impl, pred in preds.items():
        for name, coeff in requests:
            fused_edge_messages.launches = 0
            fused_iterate_total.launches = 0
            t0 = time.perf_counter()
            out = pred.predict(coeff)
            torch.cuda.synchronize()
            lat[(impl, name)] = time.perf_counter() - t0
            got = {"K1": fused_edge_messages.launches,
                   "K2": fused_iterate_total.launches}
            outs[(impl, name)] = out
            launches[f"{impl} {name}"] = got
            # one batch per request: the s=61 samples of a call form one
            # batch, the s=241 shards of one sample form one batch
            want = {k: cfg.depth if k == own[impl] else 0 for k in got}
            log(f"phase 3: {impl:8s} {name:12s} latency "
                f"{lat[(impl, name)] * 1e3:.1f} ms, launches {got}")
            require(got == want, f"{impl} {name}: launches {got}, "
                    f"expected {want}")

    for (impl, name), out in outs.items():
        s = S_SPLIT if "split" in name else S_FULL
        log(f"phase 3: {impl:8s} {name:12s} out {out.shape}, "
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
        fused_edge_messages.launches = 0
        fused_iterate_total.launches = 0
        t0 = time.perf_counter()
        ref = plain.predict(coeff)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        log(f"phase 3: plain (impl='scan') {name} latency {dt * 1e3:.1f} ms")
        require(fused_edge_messages.launches == 0
                and fused_iterate_total.launches == 0,
                f"plain {name} launched no kernel")
        f32 = "split" in name
        agree(outs[("auto", name)], ref, F32_TOL, f"auto vs plain, {name}")
        agree(outs[("kcached", name)], ref, F32_TOL if f32 else BF16_TOL,
              f"kcached vs plain, {name}")
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

    from graph_pde_tpu_torch.models.gkn import _cached_kernel
    from graph_pde_tpu_torch.ops.dense import dense_init, layer_dims
    from graph_pde_tpu_torch.ops.fused_edge_conv import (
        edge_messages_plain, fused_edge_messages)
    from graph_pde_tpu_torch.ops.fused_iterate import (
        fused_iterate_total, fused_iterate_total_plain, sorted_iterate_setup)

    kp = params["kernel"]
    e = g.senders.shape[0]
    n = g.x.shape[0]
    mask = g.edge_mask()
    e_valid = int(mask.sum())
    c = layer_dims(kp)[-1][1]

    def k1_cost(kp, e):
        # the MLP's products and the contraction, per edge; every input
        # read once (x, senders, attr, weights), the messages written once
        dims = layer_dims(kp)
        flops = 2.0 * e * (sum(a * b for a, b in dims) + dims[-1][1])
        wbytes = 4 * sum(p["w"].numel() + p["b"].numel() for p in kp)
        nbytes = 4 * n * 64 + 8 * e + 4 * e * dims[0][0] + wbytes + 4 * e * 64
        return flops, nbytes

    def k1_record(kp, s, a, reps):
        k1 = lambda: fused_edge_messages(h, s, a, kp, in_channels=64,
                                         out_channels=64)
        k1p = lambda: edge_messages_plain(h, s, a, kp, in_channels=64,
                                          out_channels=64)
        flops, nbytes = k1_cost(kp, s.shape[0])
        return dict(ms=time_ms(k1, reps), plain_ms=time_ms(k1p, 2),
                    flops=flops, bytes=nbytes, library_ms=None)

    rec = {}
    with torch.inference_mode():
        rec["K1"] = k1_record(kp, g.senders, g.edge_attr, 3)
        # K1's general form, off the serving path: the ker_width=1024
        # 'nn' kappa on the first GENERAL_TIME_SLICE edges
        wide = dense_init(torch.Generator().manual_seed(SEED + 4),
                          (6, 1024, 1024, 4096), device=h.device)
        rec["K1 general form, kappa (6, 1024, 1024, 4096), "
            f"{GENERAL_TIME_SLICE} edges"] = k1_record(
                wide, g.senders[:GENERAL_TIME_SLICE],
                g.edge_attr[:GENERAL_TIME_SLICE], 2)

        k_dtype = torch.bfloat16   # the s=61 serving dtype of the cached K
        K = _cached_kernel(kp, g.edge_attr, k_dtype)
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
        t_ops = r["flops"] / PEAK_F32_FLOPS * 1e3
        t_bytes = r["bytes"] / PEAK_BYTES * 1e3
        r["bound_ms"] = max(t_ops, t_bytes)
        r["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    log(f"phase 4: s={S_FULL} shapes: E={e} ({e_valid} valid), N={n}")
    for name, r in rec.items():
        log(f"phase 4: {name}: {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} "
            f"ms, bound {r['bound_ms']:.3f} ms ({r['bound_by']}), "
            f"library {r['library_ms']}")
    return rec


def main() -> int:
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
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    logs = kernels.build()
    log(f"phase 1: built {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"phase 1: {name}: {line.strip()}")

    cfg, params, norms, u_norm, full, split = serving_setup(dev)
    g, h = full_graph(dev, params, norms, full[0])
    errs = phase_kernels_vs_plain(g, h, params)
    phase_general_forms(g, dev)
    launches = phase_serving(cfg, params, norms, u_norm, full, split)
    times = phase_times(g, h, params)
    forward_times(g, cfg, params)

    records = [
        dict(name="K1 fused_edge_messages", route="cuda",
             source="graph_pde_tpu_torch/csrc/fused_edge_conv.cu",
             replaces="graph_pde_tpu/ops/pallas_edge_conv.py:279",
             launches=sum(v["K1"] for v in launches.values()),
             launches_by_path={k: v["K1"] for k, v in launches.items()},
             max_abs_err=errs["K1 float32"], ms=times["K1"]["ms"],
             plain_ms=times["K1"]["plain_ms"],
             bound_ms=times["K1"]["bound_ms"],
             bound_by=times["K1"]["bound_by"],
             library_ms=times["K1"]["library_ms"]),
        dict(name="K2 fused_iterate_total", route="cuda",
             source="graph_pde_tpu_torch/csrc/fused_iterate.cu",
             replaces="graph_pde_tpu/ops/fused_iterate.py:61",
             launches=sum(v["K2"] for v in launches.values()),
             launches_by_path={k: v["K2"] for k, v in launches.items()},
             max_abs_err=errs["K2 K=bfloat16"], ms=times["K2"]["ms"],
             plain_ms=times["K2"]["plain_ms"],
             bound_ms=times["K2"]["bound_ms"],
             bound_by=times["K2"]["bound_by"],
             library_ms=times["K2"]["library_ms"]),
    ]
    log(json.dumps({"kernels": records}))
    log(ident)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
