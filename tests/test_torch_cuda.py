"""The CUDA kernels of graph_pde_tpu_torch against their plain PyTorch
versions, on an NVIDIA GPU (sm_90a; nvcc builds them at first use), and
the gradients of the model paths through them.

Skips without a GPU. On the card (tests/conftest.py imports jax, which the
GPU machine need not have): python -m pytest --noconftest tests/test_torch_cuda.py

Tolerance: 1e-4 of the output's max-abs in float32 (sums in another
order); bf16 K1 (its tensor-core form too) and B1-bwd at 5e-3 (one bf16
ulp can flip where the fp32 sums before a rounding differ in order); the
bf16 model gradients as stated at GRAD_BF16_TOL. TF32 is off for every comparison.
"""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

from graph_pde_tpu_torch.graph import build_graph
from graph_pde_tpu_torch.models import GKNConfig, gkn_apply, gkn_init
from graph_pde_tpu_torch.models.gkn import params_to
from graph_pde_tpu_torch.ops.cached_contraction import (
    cached_contraction, cached_contraction_bwd, cached_contraction_bwd_plain,
    cached_contraction_plain, to_fp8)
from graph_pde_tpu_torch.ops.dense import dense_apply, dense_init, layer_dims
from graph_pde_tpu_torch.ops.edge_conv import cast_params
from graph_pde_tpu_torch.ops.fused_edge_conv import (b1_bwd_form,
                                                     b1_bwd_simt_grid,
                                                     edge_messages_bwd_plain,
                                                     edge_messages_plain,
                                                     fused_edge_messages,
                                                     fused_edge_messages_bwd,
                                                     k1_form,
                                                     k1_general_groups,
                                                     k1_simt_clusters,
                                                     k1_simt_groups,
                                                     simt_edge_messages)
from graph_pde_tpu_torch.ops.fused_iterate import (b2_bwd_form,
                                                   fused_iterate_bwd,
                                                   fused_iterate_bwd_plain,
                                                   fused_iterate_total,
                                                   fused_iterate_total_plain,
                                                   sorted_iterate_setup)
from graph_pde_tpu_torch.train.trainer import param_leaves, trainable

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


# (kappa layers, in, out): the single-launch form, then the general form
# (wide small layers as in the ker_width=1024 configs, out < 64, no small
# layer, out not a power of two, out > 128)
K1_SHAPES = [((6, 32, 128, 4 * 64), 4, 64),
             ((6, 1024, 1024, 64 * 64), 64, 64),
             ((6, 16, 32, 16 * 16), 16, 16),
             ((6, 3 * 100), 3, 100),
             ((6, 40, 2 * 200), 2, 200)]


@pytest.mark.parametrize("dtype,tol", [(None, 1e-4), ("bfloat16", 5e-3)])
@pytest.mark.parametrize("e", [1000, 4096])
@pytest.mark.parametrize("layers,w_in,w_out", K1_SHAPES)
def test_k1_matches_plain(dev, dtype, tol, e, layers, w_in, w_out):
    g = torch.Generator().manual_seed(e)
    kp = dense_init(g, list(layers), device=dev)
    x = torch.randn(50, w_in, generator=g).to(dev)
    s = torch.randint(0, 50, (e,), generator=g).to(dev)
    a = torch.randn(e, 6, generator=g).to(dev)
    before = fused_edge_messages.launches
    got = fused_edge_messages(x, s, a, kp, in_channels=w_in,
                              out_channels=w_out, compute_dtype=dtype)
    torch.cuda.synchronize()
    assert fused_edge_messages.launches == before + 1
    want = edge_messages_plain(x, s, a, kp, in_channels=w_in,
                               out_channels=w_out, compute_dtype=dtype)
    assert _rel(got, want) <= tol


# (kappa layers, in) of K1's tensor-core form (out 64): the GKN kappa, a
# narrow one (kw2 one 128-column tile), and kw1 = 16 (half a 32-deep slab)
K1_TC_SHAPES = [((6, 128, 256, 64 * 64), 64), ((6, 32, 128, 4 * 64), 4),
                ((6, 16, 128, 8 * 64), 8)]


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
@pytest.mark.parametrize("e", [1, 127, 129, 70001])
@pytest.mark.parametrize("layers,w_in", K1_TC_SHAPES)
def test_k1_forms_ragged(dev, dtype, e, layers, w_in):
    """On the single-launch shapes bf16 takes the tensor-core form and
    float32 the SIMT form, as k1_form says and the per-form counters
    show; within the tolerance of the plain version on fewer edges than
    one 128-edge tile and on ragged last tiles, and a second launch
    bit-identical (no atomics)."""
    g = torch.Generator().manual_seed(e + w_in)
    kp = dense_init(g, list(layers), device=dev)
    x = torch.randn(300, w_in, generator=g).to(dev)
    s = torch.randint(0, 300, (e,), generator=g).to(dev)
    a = torch.randn(e, 6, generator=g).to(dev)
    kw_args = dict(in_channels=w_in, out_channels=64, compute_dtype=dtype)
    form = k1_form(layer_dims(kp), w_in, 64, dtype)
    assert form == ("tc" if dtype else "simt")
    counter = f"{form}_launches"
    before = (fused_edge_messages.launches,
              getattr(fused_edge_messages, counter))
    got = fused_edge_messages(x, s, a, kp, **kw_args)
    again = fused_edge_messages(x, s, a, kp, **kw_args)
    torch.cuda.synchronize()
    assert (fused_edge_messages.launches - before[0],
            getattr(fused_edge_messages, counter) - before[1]) == (2, 2)
    assert torch.equal(got, again)
    want = edge_messages_plain(x, s, a, kp, **kw_args)
    assert _rel(got, want) <= (5e-3 if dtype else 1e-4)


def test_k1_general_form_counted(dev):
    """A shape outside the single-launch tiles takes the general form in
    both dtypes, counted as such."""
    g = torch.Generator().manual_seed(3)
    kp = dense_init(g, [6, 16, 32, 16 * 16], device=dev)
    x = torch.randn(40, 16, generator=g).to(dev)
    s = torch.randint(0, 40, (300,), generator=g).to(dev)
    a = torch.randn(300, 6, generator=g).to(dev)
    for dtype in (None, "bfloat16"):
        assert k1_form(layer_dims(kp), 16, 16, dtype) == "general"
        before = fused_edge_messages.general_launches
        fused_edge_messages(x, s, a, kp, in_channels=16, out_channels=16,
                            compute_dtype=dtype)
        torch.cuda.synchronize()
        assert fused_edge_messages.general_launches == before + 1


@pytest.mark.parametrize("name", ["float8_e4m3", "float8_e5m2"])
@pytest.mark.parametrize("w", [16, 64, 128])
def test_k2_fp8_nodes_with_zero_and_one_edge(dev, name, w):
    """K2's fp8 kernel on a graph where node 0 has no edge, node 1 one
    edge, node 2 one masked edge and the rest many (ragged against the
    eight edges in flight): within 1e-4 of the plain version, empty rows
    exactly zero, counted as the fp8 form."""
    g = torch.Generator().manual_seed(w + 19)
    n, e = 30, 1500
    recv = torch.sort(torch.randint(3, n, (e,), generator=g)).values
    recv[0], recv[1] = 1, 2
    recv = torch.sort(recv).values
    mask = torch.ones(e, dtype=torch.bool)
    mask[1] = False                     # node 2's only edge
    mask[-7:] = False
    s = torch.randint(0, n, (e,), generator=g).to(dev)
    x = torch.randn(n, w, generator=g).to(dev)
    K = (torch.randn(e, w * w, generator=g) * 30).to(torch.bfloat16).to(dev)
    k8 = to_fp8(K, name)
    setup = sorted_iterate_setup(recv.to(dev), mask.to(dev), n)
    attr = "e4m3_launches" if name == "float8_e4m3" else "e5m2_launches"
    before = getattr(fused_iterate_total, attr)
    got = fused_iterate_total(x, s, K, setup, in_channels=w, out_channels=w,
                              k8=k8)
    torch.cuda.synchronize()
    assert getattr(fused_iterate_total, attr) == before + 1
    want = fused_iterate_total_plain(x, s, k8, setup, in_channels=w,
                                     out_channels=w)
    assert _rel(got, want) <= 1e-4
    assert bool((got[0] == 0).all()) and bool((got[2] == 0).all())
    assert bool((got[1] != 0).any())


@pytest.mark.parametrize("k_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w", [16, 64, 128, 12, 6])
def test_k2_matches_plain(dev, k_dtype, w):
    g = torch.Generator().manual_seed(w)
    n, e = 40, 2048
    recv = torch.sort(torch.randint(0, n, (e,), generator=g)).values
    recv[-200:] = n - 1            # padding parked on a real node
    mask = torch.arange(e) < e - 200
    s = torch.randint(0, n, (e,), generator=g)
    x = torch.randn(n, w, generator=g)
    K = torch.randn(e, w * w, generator=g).to(k_dtype)
    setup = sorted_iterate_setup(recv.to(dev), mask.to(dev), n)
    before = fused_iterate_total.launches
    got = fused_iterate_total(x.to(dev), s.to(dev), K.to(dev), setup,
                              in_channels=w, out_channels=w)
    torch.cuda.synchronize()
    assert fused_iterate_total.launches == before + 1
    want = fused_iterate_total_plain(x.to(dev), s.to(dev), K.to(dev), setup,
                                     in_channels=w, out_channels=w)
    assert _rel(got, want) <= 1e-4


@pytest.mark.parametrize("impl,fused,width,layers", [
    ("auto", "off", 64, (6, 64, 128, 4096)),
    ("kcached", "on", 64, (6, 64, 128, 4096)),
    ("auto", "off", 64, (6, 1024, 1024, 4096)),
    ("kcached", "on", 128, (6, 32, 64, 128 * 128))])
def test_gkn_on_card_matches_cpu(dev, impl, fused, width, layers):
    """The model path through each kernel (the general forms too: the
    ker_width=1024 kappa, width 128) against the same forward on the CPU
    (plain versions)."""
    rng = np.random.default_rng(0)
    n, e = 200, 3000
    host = build_graph(rng.normal(size=(n, 6)), rng.integers(0, n, e),
                       rng.integers(0, n, e), rng.normal(size=(e, 6)))
    cfg = GKNConfig(width=width, ker_width=layers[2], depth=3, ker_in=6,
                    in_width=6, kernel_layers=layers, impl=impl,
                    kcached_fused=fused)
    p = gkn_init(torch.Generator().manual_seed(1), cfg, device="cpu")
    k1, k2 = fused_edge_messages.launches, fused_iterate_total.launches
    got = gkn_apply(params_to(p, dev), cfg, host.to())
    torch.cuda.synchronize()
    want = gkn_apply(p, cfg, host.to("cpu"))
    assert _rel(got.cpu(), want) <= 1e-4
    launched = (fused_edge_messages.launches - k1,
                fused_iterate_total.launches - k2)
    assert launched == ((3, 0) if impl == "auto" else (0, 3))


def test_wrappers_raise_on_unsupported_cuda_shapes(dev):
    """Shapes outside the JAX gates, and a K dtype the kernel does not
    read, raise on CUDA; nothing falls back to the plain version."""
    kp = dense_init(torch.Generator().manual_seed(0), [6, 16, 32, 250],
                    device=dev)
    x = torch.randn(10, 16, device=dev)
    s = torch.zeros(8, dtype=torch.int64, device=dev)
    before = fused_edge_messages.launches
    with pytest.raises(ValueError):
        fused_edge_messages(x, s, torch.randn(8, 6, device=dev), kp,
                            in_channels=16, out_channels=16)
    assert fused_edge_messages.launches == before
    setup = sorted_iterate_setup(s, torch.ones(8, dtype=torch.bool,
                                               device=dev), 10)
    K = torch.randn(8, 256, device=dev).to(torch.float16)
    with pytest.raises(ValueError):
        fused_iterate_total(x, s, K, setup, in_channels=16, out_channels=16)


# (edge list, kappa layers) of the orthogonal MGKN at s=1024: the
# nearest-neighbor list with the widest kappa, and two coarse levels
ORTHO_SHAPES = [(0, (4, 1024, 1024, 64 * 64)), (4, (4, 64, 64, 64 * 64)),
                (6, (4, 16, 16, 64 * 64))]


@pytest.mark.parametrize("dtype,tol", [(None, 1e-4), ("bfloat16", 5e-3)])
@pytest.mark.parametrize("idx,layers", ORTHO_SHAPES)
def test_k1_b1_bwd_orthogonal_kappas(dev, dtype, tol, idx, layers):
    """K1 and B1-bwd at the orthogonal model's level shapes (attr width
    4, kw1 = kw2 from 1024 down to 16, general form) on the level's own
    periodic edge list: the forward and every B1-bwd output against the
    plain versions, in the forms k1_form and b1_bwd_form pick."""
    from graph_pde_tpu_torch.graph.multipole import (_interactive_edges,
                                                     _nearest_neighbor_edges)

    n = 1024 // 2 ** max(idx - 1, 0)
    ei = (_nearest_neighbor_edges(n, True) if idx == 0
          else _interactive_edges(n, True))
    g = torch.Generator().manual_seed(idx)
    kp = dense_init(g, list(layers), device=dev)
    e = ei.shape[1]
    x = torch.randn(n, 64, generator=g).to(dev)
    s = torch.as_tensor(ei[0]).to(dev)
    a = torch.rand(e, 4, generator=g).to(dev)
    kw_args = dict(in_channels=64, out_channels=64, compute_dtype=dtype)
    form = k1_form(layer_dims(kp), 64, 64, dtype)
    assert form == "general"
    before = fused_edge_messages.general_launches
    got = fused_edge_messages(x, s, a, kp, **kw_args)
    torch.cuda.synchronize()
    assert fused_edge_messages.general_launches == before + 1
    assert _rel(got, edge_messages_plain(x, s, a, kp, **kw_args)) <= tol
    h2 = dense_apply(kp[:-1], a, out_nonlinearity=torch.relu)
    gg = torch.randn(e, 64, generator=g).to(dev)
    kw = layers[1]
    attr = f"{b1_bwd_form(kw, 64, 64, dtype)}_launches"
    assert attr == ("tc_launches" if dtype else "simt_launches")
    before = getattr(fused_edge_messages_bwd, attr)
    got = fused_edge_messages_bwd(x, s, h2, gg, kp[-1]["w"], **kw_args)
    torch.cuda.synchronize()
    assert getattr(fused_edge_messages_bwd, attr) == before + 1
    want = edge_messages_bwd_plain(x, s, h2, gg, kp[-1]["w"], **kw_args)
    for name, a_, b_ in zip(("dx_src", "dh2", "dWl", "dbl"), got, want):
        assert _rel(a_, b_) <= tol, name

# (E, kappa layers, nodes, fp32 K1 form) of the general MGKN's convs at
# the full width of mgkn_general_darcy2d (points (400, 100, 25), edge
# counts padded from one seed-0 draw at s=85): the mid convs of levels
# 0-2 (two hidden layers; level 0's tile does not fit the SIMT form's
# shared memory, level 2's kw 64 is no multiple of 128) and the down/up
# convs of levels 0-1 (one hidden layer) on the whole node array
MGKN_GENERAL_SHAPES = [(25856, (6, 256, 256, 64 * 64), 400, "general"),
                       (4864, (6, 128, 128, 64 * 64), 100, "simt"),
                       (768, (6, 64, 64, 64 * 64), 25, "general"),
                       (1792, (6, 128, 64 * 64), 525, "general"),
                       (512, (6, 64, 64 * 64), 525, "general")]


@pytest.mark.parametrize("dtype,tol", [(None, 1e-4), ("bfloat16", 5e-3)])
@pytest.mark.parametrize("e,layers,n,form32", MGKN_GENERAL_SHAPES)
def test_k1_b1_bwd_mgkn_general_kappas(dev, dtype, tol, e, layers, n,
                                       form32):
    """K1 and B1-bwd at the general MGKN's conv shapes, the one-hidden-
    layer down/up kappas among them: the forward and all four B1-bwd
    outputs against the plain versions, in the forms k1_form and
    b1_bwd_form pick (fp32: the table's K1 form, B1-bwd SIMT)."""
    g = torch.Generator().manual_seed(e)
    kp = dense_init(g, list(layers), device=dev)
    x = torch.randn(n, 64, generator=g).to(dev)
    s = torch.randint(0, n, (e,), generator=g).to(dev)
    a = torch.rand(e, 6, generator=g).to(dev)
    kw_args = dict(in_channels=64, out_channels=64, compute_dtype=dtype)
    form = k1_form(layer_dims(kp), 64, 64, dtype)
    if dtype is None:
        assert form == form32
    before = getattr(fused_edge_messages, f"{form}_launches")
    got = fused_edge_messages(x, s, a, kp, **kw_args)
    torch.cuda.synchronize()
    assert getattr(fused_edge_messages, f"{form}_launches") == before + 1
    assert _rel(got, edge_messages_plain(x, s, a, kp, **kw_args)) <= tol
    h2 = dense_apply(kp[:-1], a, out_nonlinearity=torch.relu)
    gg = torch.randn(e, 64, generator=g).to(dev)
    bform = b1_bwd_form(layers[-2], 64, 64, dtype)
    assert bform == ("tc" if dtype else "simt")
    before = getattr(fused_edge_messages_bwd, f"{bform}_launches")
    got = fused_edge_messages_bwd(x, s, h2, gg, kp[-1]["w"], **kw_args)
    torch.cuda.synchronize()
    assert getattr(fused_edge_messages_bwd, f"{bform}_launches") == \
        before + 1
    want = edge_messages_bwd_plain(x, s, h2, gg, kp[-1]["w"], **kw_args)
    for name, a_, b_ in zip(("dx_src", "dh2", "dWl", "dbl"), got, want):
        assert _rel(a_, b_) <= tol, name


# (E, nodes) of the torus model's conv at the full width of
# grain_torus_timeseries (kappa (5, 32, 64, 32 * 32), in = out = 32): one
# 256-node shard's E_pad and the flattened batch of 4
TORUS_SHAPES = [(12800, 256), (51200, 1024)]


@pytest.mark.parametrize("dtype,tol", [(None, 1e-4), ("bfloat16", 5e-3)])
@pytest.mark.parametrize("e,n", TORUS_SHAPES)
def test_k1_b1_bwd_torus_kappa(dev, dtype, tol, e, n):
    """K1 (general form: out is not 64) and B1-bwd (SIMT in fp32, tensor
    cores in bf16: out 32 divides 128) at the torus model's conv: the
    forward and all four B1-bwd outputs against the plain versions, a
    second launch bit-identical."""
    layers, w = (5, 32, 64, 32 * 32), 32
    g = torch.Generator().manual_seed(e + 5)
    kp = dense_init(g, list(layers), device=dev)
    x = torch.randn(n, w, generator=g).to(dev)
    s = torch.randint(0, n, (e,), generator=g).to(dev)
    a = torch.randn(e, 5, generator=g).to(dev)
    kw_args = dict(in_channels=w, out_channels=w, compute_dtype=dtype)
    assert k1_form(layer_dims(kp), w, w, dtype) == "general"
    before = fused_edge_messages.general_launches
    got = fused_edge_messages(x, s, a, kp, **kw_args)
    again = fused_edge_messages(x, s, a, kp, **kw_args)
    torch.cuda.synchronize()
    assert fused_edge_messages.general_launches == before + 2
    assert torch.equal(got, again)
    assert _rel(got, edge_messages_plain(x, s, a, kp, **kw_args)) <= tol
    bform = b1_bwd_form(64, w, w, dtype)
    assert bform == ("tc" if dtype else "simt")
    h2 = dense_apply(kp[:-1], a, out_nonlinearity=torch.relu)
    gg = torch.randn(e, w, generator=g).to(dev)
    wl = kp[-1]["w"]
    before = getattr(fused_edge_messages_bwd, f"{bform}_launches")
    got = fused_edge_messages_bwd(x, s, h2, gg, wl, **kw_args)
    again = fused_edge_messages_bwd(x, s, h2, gg, wl, **kw_args)
    torch.cuda.synchronize()
    assert getattr(fused_edge_messages_bwd, f"{bform}_launches") == \
        before + 2
    want = edge_messages_bwd_plain(x, s, h2, gg, wl, **kw_args)
    for name, a_, b_, c_ in zip(("dx_src", "dh2", "dWl", "dbl"), got, again,
                                want):
        assert torch.equal(a_, b_), name
        assert _rel(a_, c_) <= tol, name


# (E, kappa layers, in, out) of K1's general form and B1-bwd's SIMT form
# on both kinds of grid: the orthogonal kw-1024 level's edge count, where
# K1 takes channel groups (G > 1) and B1-bwd channel groups and depth
# splits (Gx, S > 1), and 131,072 edges, where the edge tiles fill the
# card (G = Gx = S = 1); and the ragged shapes: out 16, kw 40 with out
# 200 (> 128), an odd in (3) with out 100 and no small layer
GRID_SHAPES = [(2048, (4, 1024, 1024, 64 * 64), 64, 64),
               (131072, (4, 1024, 1024, 64 * 64), 64, 64),
               (3000, (6, 16, 32, 16 * 16), 16, 16),
               (131072, (6, 16, 32, 16 * 16), 16, 16),
               (1000, (6, 40, 2 * 200), 2, 200),
               (131072, (6, 40, 2 * 200), 2, 200),
               (1000, (6, 3 * 100), 3, 100)]


@pytest.mark.parametrize("dtype,tol", [(None, 1e-4), ("bfloat16", 5e-3)])
@pytest.mark.parametrize("e,layers,w_in,w_out", GRID_SHAPES)
def test_k1_general_b1_simt_grids(dev, dtype, tol, e, layers, w_in, w_out):
    """K1's general form, with its channel groups summed by a second
    pass or written directly, and B1-bwd's SIMT form (where its shape
    and dtype take it), with its dx channel groups and dh depth splits,
    against their plain versions; a second launch bit-identical."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    kw = layers[-2]
    groups, _ = k1_general_groups(e, w_in, w_out, sms)
    gx, _, hs, _ = b1_bwd_simt_grid(e, kw, w_in, w_out, sms)
    if e >= 131072:
        assert groups == gx == hs == 1
    else:
        assert groups > 1 and gx > 1 and hs > 1
    g = torch.Generator().manual_seed(e + kw + w_out)
    kp = dense_init(g, list(layers), device=dev)
    x = torch.randn(300, w_in, generator=g).to(dev)
    s = torch.randint(0, 300, (e,), generator=g).to(dev)
    a = torch.rand(e, layers[0], generator=g).to(dev)
    kw_args = dict(in_channels=w_in, out_channels=w_out, compute_dtype=dtype)
    assert k1_form(layer_dims(kp), w_in, w_out, dtype) == "general"
    before = fused_edge_messages.general_launches
    got = fused_edge_messages(x, s, a, kp, **kw_args)
    again = fused_edge_messages(x, s, a, kp, **kw_args)
    torch.cuda.synchronize()
    assert fused_edge_messages.general_launches == before + 2
    assert torch.equal(got, again)
    assert _rel(got, edge_messages_plain(x, s, a, kp, **kw_args)) <= tol
    if b1_bwd_form(kw, w_in, w_out, dtype) != "simt":
        return   # bf16 on the tensor-core tiles: not this form's shape
    h2 = torch.relu(torch.randn(e, kw, generator=g)).to(dev)
    gg = torch.randn(e, w_out, generator=g).to(dev)
    wl = kp[-1]["w"]
    before = fused_edge_messages_bwd.simt_launches
    got = fused_edge_messages_bwd(x, s, h2, gg, wl, **kw_args)
    again = fused_edge_messages_bwd(x, s, h2, gg, wl, **kw_args)
    torch.cuda.synchronize()
    assert fused_edge_messages_bwd.simt_launches == before + 2
    want = edge_messages_bwd_plain(x, s, h2, gg, wl, **kw_args)
    for name, a_, b_, c_ in zip(("dx_src", "dh2", "dWl", "dbl"), got, again,
                                want):
        assert torch.equal(a_, b_), name
        assert _rel(a_, c_) <= tol, name


@pytest.mark.parametrize("dtype,tol", [(None, 1e-4), ("bfloat16", 5e-3)])
@pytest.mark.parametrize("e", [1, 127, 129, 762, 4864])
def test_k1_simt_cluster_grids(dev, dtype, tol, e):
    """K1's SIMT form at the general MGKN's mid l=1 kappa (6, 128, 128,
    4096), in 64, on fewer edges than a tile, a ragged last tile, the
    orthogonal kw-128 level's and mid l=1's edge counts: on the grid
    k1_simt_groups picks (G > 1 at each, ranks summed through
    distributed shared memory) and with G forced to 1, 2, 4 and 8,
    within the tolerance of the plain version (fp32, and bf16 rounding)
    and a second launch bit-identical; in fp32 the wrapper takes the
    SIMT form on the rule's grid, counted once. A grid that leaves a
    rank no pair, or a cluster above 16 blocks, raises."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator().manual_seed(e + 7)
    layers = (6, 128, 128, 64 * 64)
    kp = dense_init(g, list(layers), device=dev)
    x = torch.randn(100, 64, generator=g).to(dev)
    s = torch.randint(0, 100, (e,), generator=g).to(dev)
    a = torch.rand(e, 6, generator=g).to(dev)
    clusters = k1_simt_clusters(layer_dims(kp), 64, int(dtype is not None),
                                dev)
    groups, _ = k1_simt_groups(e, 64, sms, clusters)
    assert groups > 1
    kw_args = dict(in_channels=64, compute_dtype=dtype)
    want = edge_messages_plain(x, s, a, kp, out_channels=64, **kw_args)
    outs = {}
    for forced in (None, 1, 2, 4, 8):
        outs[forced] = simt_edge_messages(x, s, a, kp, groups=forced,
                                          **kw_args)
        again = simt_edge_messages(x, s, a, kp, groups=forced, **kw_args)
        torch.cuda.synchronize()
        assert torch.equal(outs[forced], again), forced
        assert _rel(outs[forced], want) <= tol, forced
    if dtype is None:
        assert k1_form(layer_dims(kp), 64, 64, None) == "simt"
        before = fused_edge_messages.simt_launches
        got = fused_edge_messages(x, s, a, kp, out_channels=64, **kw_args)
        torch.cuda.synchronize()
        assert fused_edge_messages.simt_launches == before + 1
        assert torch.equal(got, outs[None])
    small = dense_init(g, [6, 16, 128, 8 * 64], device=dev)
    for bad in (3, 17):   # 4 pairs in 3 ranks of 2 leave one none
        with pytest.raises(RuntimeError):
            simt_edge_messages(x[:, :8].contiguous(), s, a, small,
                               in_channels=8, groups=bad)


# (kw, in, out): the GKN shape, the ker_width 1024 'nn' kappa, a narrow
# kappa, no small layer (kw = attr width), out not a power of two, out > 128
B1_SHAPES = [(256, 64, 64), (1024, 64, 64), (32, 16, 16), (6, 3, 100),
             (40, 2, 200)]


@pytest.mark.parametrize("dtype,tol", [(None, 1e-4), ("bfloat16", 5e-3)])
@pytest.mark.parametrize("e", [1000, 5000])
@pytest.mark.parametrize("kw,w_in,w_out", B1_SHAPES)
def test_b1_bwd_matches_plain(dev, dtype, tol, e, kw, w_in, w_out):
    g = torch.Generator().manual_seed(e + kw)
    x = torch.randn(50, w_in, generator=g).to(dev)
    s = torch.randint(0, 50, (e,), generator=g).to(dev)
    h2 = torch.relu(torch.randn(e, kw, generator=g)).to(dev)
    gg = torch.randn(e, w_out, generator=g).to(dev)
    wl = (torch.randn(kw, w_in * w_out, generator=g) / kw ** 0.5).to(dev)
    kw_args = dict(in_channels=w_in, out_channels=w_out, compute_dtype=dtype)
    attr = f"{b1_bwd_form(kw, w_in, w_out, dtype)}_launches"
    assert attr == ("tc_launches" if dtype and (kw, w_out) != (6, 100)
                    and (kw, w_out) != (40, 200) else "simt_launches")
    before = (fused_edge_messages_bwd.launches,
              getattr(fused_edge_messages_bwd, attr))
    got = fused_edge_messages_bwd(x, s, h2, gg, wl, **kw_args)
    torch.cuda.synchronize()
    assert (fused_edge_messages_bwd.launches,
            getattr(fused_edge_messages_bwd, attr)) == (before[0] + 1,
                                                        before[1] + 1)
    want = edge_messages_bwd_plain(x, s, h2, gg, wl, **kw_args)
    for name, a, b in zip(("dx_src", "dh2", "dWl", "dbl"), got, want):
        assert _rel(a, b) <= tol, name
    # fixed-order reductions: a second launch is bit-identical
    again = fused_edge_messages_bwd(x, s, h2, gg, wl, **kw_args)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


# (kw, in, out) of the tensor-core form: the GKN kappa, kw not a multiple
# of the 32-deep slab nor of the 128-wide tile, a narrow kappa, out 128
# (one channel per tile), out 8 (sixteen channels per tile), the widest g
# and x (the tile's h2 streamed through the ring, not resident)
B1_TC_SHAPES = [(256, 64, 64), (1000, 64, 64), (32, 16, 16), (96, 4, 128),
                (128, 16, 8), (256, 256, 128)]


@pytest.mark.parametrize("e", [1, 50, 300])
@pytest.mark.parametrize("kw,w_in,w_out", B1_TC_SHAPES)
def test_b1_bwd_tc_ragged(dev, e, kw, w_in, w_out):
    """The bf16 tensor-core form on fewer edges than one 128-edge tile and
    on a ragged last tile: within 5e-3 of the plain version, counted as
    its form, and a second launch bit-identical (no atomics)."""
    g = torch.Generator().manual_seed(e * kw + w_out)
    x = torch.randn(50, w_in, generator=g).to(dev)
    s = torch.randint(0, 50, (e,), generator=g).to(dev)
    h2 = torch.relu(torch.randn(e, kw, generator=g)).to(dev)
    gg = torch.randn(e, w_out, generator=g).to(dev)
    wl = (torch.randn(kw, w_in * w_out, generator=g) / kw ** 0.5).to(dev)
    kw_args = dict(in_channels=w_in, out_channels=w_out,
                   compute_dtype="bfloat16")
    assert b1_bwd_form(kw, w_in, w_out, "bfloat16") == "tc"
    before = fused_edge_messages_bwd.tc_launches
    got = fused_edge_messages_bwd(x, s, h2, gg, wl, **kw_args)
    torch.cuda.synchronize()
    assert fused_edge_messages_bwd.tc_launches == before + 1
    want = edge_messages_bwd_plain(x, s, h2, gg, wl, **kw_args)
    for name, a, b in zip(("dx_src", "dh2", "dWl", "dbl"), got, want):
        assert _rel(a, b) <= 5e-3, name
    again = fused_edge_messages_bwd(x, s, h2, gg, wl, **kw_args)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("e,shifted", [(37, False), (20011, False),
                                       (20011, True)])
def test_b1_bwd_tc_uai4_shape(dev, e, shifted):
    """The bf16 tensor-core form at the uai4 kappa (kw 256, in = out = 64)
    on fewer edges than one 128-edge tile and on a ragged last tile, once
    with the senders an 8-byte-aligned view (TMA reads them 16-byte
    aligned, so the wrapper copies them): all four outputs within 5e-3 of
    the plain version, counted as a tc launch, a second launch
    bit-identical (fixed-order sums, no atomics)."""
    g = torch.Generator().manual_seed(e + 7)
    x = torch.randn(2000, 64, generator=g).to(dev)
    s = torch.randint(0, 2000, (e + 1,), generator=g).to(dev)
    s = s[1:] if shifted else s[:e].clone()
    assert (s.data_ptr() % 16 != 0) == shifted
    h2 = torch.relu(torch.randn(e, 256, generator=g)).to(dev)
    gg = torch.randn(e, 64, generator=g).to(dev)
    wl = (torch.randn(256, 64 * 64, generator=g) / 16.0).to(dev)
    kw_args = dict(in_channels=64, out_channels=64, compute_dtype="bfloat16")
    assert b1_bwd_form(256, 64, 64, "bfloat16") == "tc"
    before = fused_edge_messages_bwd.tc_launches
    got = fused_edge_messages_bwd(x, s, h2, gg, wl, **kw_args)
    torch.cuda.synchronize()
    assert fused_edge_messages_bwd.tc_launches == before + 1
    want = edge_messages_bwd_plain(x, s, h2, gg, wl, **kw_args)
    for name, a, b in zip(("dx_src", "dh2", "dWl", "dbl"), got, want):
        assert _rel(a, b) <= 5e-3, name
    again = fused_edge_messages_bwd(x, s, h2, gg, wl, **kw_args)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


def _b2_operands(g, e, w_in, w_out, k_name, dev):
    """Sorted receivers with a masked tail and an all-masked run of 520
    edges (more than one block of warps), K of the named stream type."""
    n = 40
    recv = torch.sort(torch.randint(0, n, (e,), generator=g)).values
    mask = torch.ones(e, dtype=torch.bool)
    mask[-(e // 7 + 1):] = False
    mask[e // 3:e // 3 + 520] = False
    K = torch.randn(e, w_in * w_out, generator=g) * 3
    if k_name in ("float8_e4m3", "float8_e5m2"):
        K = to_fp8(K.to(torch.bfloat16), k_name)
    else:
        K = K.to(getattr(torch, k_name))
    dt = torch.randn(n, w_out, generator=g).to(dev)
    setup = sorted_iterate_setup(recv.to(dev), mask.to(dev), n)
    return K.to(dev), setup, dt, mask.to(dev)


# (in, out): the warp form at every out it takes, in below one warp's 32
# runs, then the general form (out not a multiple of 8, out 512)
B2_FORM_SHAPES = [(5, 8), (16, 16), (3, 32), (64, 64), (128, 128),
                  (4, 256), (12, 12), (2, 512)]


@pytest.mark.parametrize("k_name", ["float32", "bfloat16", "float8_e4m3",
                                    "float8_e5m2"])
@pytest.mark.parametrize("e", [5, 1003, 4096])
@pytest.mark.parametrize("w_in,w_out", B2_FORM_SHAPES)
def test_b2_bwd_forms(dev, k_name, e, w_in, w_out):
    """Each B2-bwd form, every K stream type, against the plain version:
    dxj within 1e-4, dmsg bit-equal, zeros on masked edges (tails and
    whole masked blocks), counted as its form."""
    g = torch.Generator().manual_seed(e + w_out)
    K, setup, dt, mask = _b2_operands(g, e, w_in, w_out, k_name, dev)
    form = b2_bwd_form(w_out)
    assert form == ("warp" if w_out % 8 == 0 and w_out <= 256 else "general")
    attr = f"{form}_launches"
    before = getattr(fused_iterate_bwd, attr)
    dxj, dmsg = fused_iterate_bwd(K, setup, dt, in_channels=w_in,
                                  out_channels=w_out)
    torch.cuda.synchronize()
    assert getattr(fused_iterate_bwd, attr) == before + 1
    wdx, wdm = fused_iterate_bwd_plain(K, setup, dt, in_channels=w_in,
                                       out_channels=w_out)
    assert _rel(dxj, wdx) <= 1e-4
    assert torch.equal(dmsg, wdm)
    if not bool(mask.all()):
        assert float(dxj[~mask].abs().max()) == 0.0


@pytest.mark.parametrize("k_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w", [16, 64, 128, 12, 6])
def test_b2_bwd_matches_plain(dev, k_dtype, w):
    g = torch.Generator().manual_seed(w)
    n, e = 40, 2048
    recv = torch.sort(torch.randint(0, n, (e,), generator=g)).values
    recv[-200:] = n - 1            # padding parked on a real node
    mask = torch.arange(e) < e - 200
    K = torch.randn(e, w * w, generator=g).to(k_dtype).to(dev)
    dt = torch.randn(n, w, generator=g).to(dev)
    setup = sorted_iterate_setup(recv.to(dev), mask.to(dev), n)
    before = fused_iterate_bwd.launches
    dxj, dmsg = fused_iterate_bwd(K, setup, dt, in_channels=w,
                                  out_channels=w)
    torch.cuda.synchronize()
    assert fused_iterate_bwd.launches == before + 1
    want = fused_iterate_bwd_plain(K, setup, dt, in_channels=w,
                                   out_channels=w)
    assert _rel(dxj, want[0]) <= 1e-4
    assert torch.equal(dmsg, want[1])
    assert float(dxj[~mask.to(dev)].abs().max()) == 0.0


def _grads(params, cfg, graph):
    p = trainable(params, graph.device)
    out = gkn_apply(p, cfg, graph)
    (out ** 2).sum().backward()
    return out.detach().cpu(), [t.grad.cpu() for t in param_leaves(p)]


# bf16 tolerance of the model gradients: moving every parameter by one
# float32 ulp moves the CPU's own bf16 gradients of the width-64 model by
# 4.5e-3 of a leaf's max-abs (a flipped bf16 ulp, carried through three
# depth steps; tests/test_torch_gkn.py test_gkn_bf16_grads_match_jax),
# and the card's float32 sums differ from the CPU's by more than one ulp.
# Rounding at other points (the reference path's) moves them further, a
# dropped gradient by 1.
GRAD_BF16_TOL = 1e-2


@pytest.mark.parametrize("dtype,tol", [(None, 1e-4),
                                       ("bfloat16", GRAD_BF16_TOL)])
@pytest.mark.parametrize("impl,fused,layers", [
    ("auto", "off", (6, 64, 128, 4096)),
    ("kcached", "on", (6, 64, 128, 4096)),
    ("auto", "off", (6, 32, 64, 16 * 16)),
    ("kcached", "on", (6, 32, 64, 16 * 16))])
def test_gkn_grads_on_card_match_cpu(dev, impl, fused, layers, dtype, tol):
    """The repair: gradients through impl='auto' (K1 + B1-bwd) and
    kcached_fused='on' (K2 + B2-bwd) on the card equal the gradients of
    the same autograd Functions on the CPU (plain versions; on the CPU
    'auto' would pick the reference path, which rounds bf16 elsewhere,
    so the CPU run names impl='pallas'), for every parameter, with one
    forward and one backward launch per depth step."""
    rng = np.random.default_rng(0)
    n, e = 200, 3000
    w = int(round(layers[-1] ** 0.5))
    host = build_graph(rng.normal(size=(n, 6)), rng.integers(0, n, e),
                       rng.integers(0, n, e), rng.normal(size=(e, 6)))
    cfg = GKNConfig(width=w, ker_width=layers[2], depth=3, ker_in=6,
                    in_width=6, kernel_layers=layers, impl=impl,
                    kcached_fused=fused, compute_dtype=dtype)
    p = gkn_init(torch.Generator().manual_seed(1), cfg, device="cpu")
    counts = [fused_edge_messages.launches, fused_edge_messages_bwd.launches,
              fused_iterate_total.launches, fused_iterate_bwd.launches]
    out, grads = _grads(p, cfg, host.to())
    torch.cuda.synchronize()
    launched = [fused_edge_messages.launches, fused_edge_messages_bwd.launches,
                fused_iterate_total.launches, fused_iterate_bwd.launches]
    launched = [a - b for a, b in zip(launched, counts)]
    assert launched == ([3, 3, 0, 0] if impl == "auto" else [0, 0, 3, 3])
    cpu_cfg = dataclasses.replace(cfg, impl="pallas") if impl == "auto" \
        else cfg
    want_out, want = _grads(p, cpu_cfg, host.to("cpu"))
    assert _rel(out, want_out) <= (1e-4 if dtype is None else 5e-3)
    errs = [_rel(a, b) for a, b in zip(grads, want)]
    print(f"{impl} {layers} {dtype}: gradient errors "
          + " ".join(f"{v:.2e}" for v in errs))
    for j, err in enumerate(errs):
        assert err <= tol, j


# (in, out): the fast form at every out it takes (8 .. 256, two column
# chunks at 128), and the general form (out not a multiple of 8, out 512)
B3_SHAPES = [(64, 64), (16, 16), (128, 128), (32, 8), (4, 256), (12, 12),
             (3, 5), (2, 512)]


@pytest.mark.parametrize("k_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w_in,w_out", B3_SHAPES)
def test_b3_matches_plain(dev, k_dtype, w_in, w_out):
    """B3-fwd and B3-bwd against their plain versions; dK (the same
    float32 products, rounded once) bit for bit; through autograd, one
    launch of each."""
    g = torch.Generator().manual_seed(w_in * w_out)
    e = 1001
    x = torch.randn(e, w_in, generator=g).to(dev).requires_grad_(True)
    K = torch.randn(e, w_in * w_out, generator=g).to(k_dtype).to(dev)
    K.requires_grad_(True)
    gg = torch.randn(e, w_out, generator=g).to(dev)
    kw = dict(in_channels=w_in, out_channels=w_out)
    before = (cached_contraction.launches, cached_contraction_bwd.launches)
    msg = cached_contraction(x, K, **kw)
    (msg * gg).sum().backward()
    torch.cuda.synchronize()
    assert (cached_contraction.launches - before[0],
            cached_contraction_bwd.launches - before[1]) == (1, 1)
    want = cached_contraction_plain(x.detach(), K.detach(), **kw)
    assert _rel(msg.detach(), want) <= 1e-4
    dx, dk = cached_contraction_bwd_plain(x.detach(), K.detach(), gg, **kw)
    assert _rel(x.grad, dx) <= 1e-4
    assert K.grad.dtype == k_dtype and torch.equal(K.grad, dk)


@pytest.mark.parametrize("name", ["float8_e4m3", "float8_e5m2"])
@pytest.mark.parametrize("w", [16, 64, 128, 12])
def test_k2_b2_bwd_fp8_match_plain(dev, name, w):
    """K2 and B2-bwd reading an fp8 K stream, against their plain
    versions on the same k8, each counted as its fp8 form."""
    g = torch.Generator().manual_seed(w + 7)
    n, e = 40, 2048
    recv = torch.sort(torch.randint(0, n, (e,), generator=g)).values
    recv[-200:] = n - 1
    mask = torch.arange(e) < e - 200
    s = torch.randint(0, n, (e,), generator=g).to(dev)
    x = torch.randn(n, w, generator=g).to(dev)
    K = (torch.randn(e, w * w, generator=g) * 30).to(torch.bfloat16).to(dev)
    k8 = to_fp8(K, name)
    dt = torch.randn(n, w, generator=g).to(dev)
    setup = sorted_iterate_setup(recv.to(dev), mask.to(dev), n)
    attr = "e4m3_launches" if name == "float8_e4m3" else "e5m2_launches"
    before = (fused_iterate_total.launches, getattr(fused_iterate_total, attr),
              fused_iterate_bwd.launches, getattr(fused_iterate_bwd, attr))
    got = fused_iterate_total(x, s, K, setup, in_channels=w, out_channels=w,
                              k8=k8)
    dxj, dmsg = fused_iterate_bwd(k8, setup, dt, in_channels=w,
                                  out_channels=w)
    torch.cuda.synchronize()
    after = (fused_iterate_total.launches, getattr(fused_iterate_total, attr),
             fused_iterate_bwd.launches, getattr(fused_iterate_bwd, attr))
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1, 1]
    want = fused_iterate_total_plain(x, s, k8, setup, in_channels=w,
                                     out_channels=w)
    assert _rel(got, want) <= 1e-4
    wdx, wdm = fused_iterate_bwd_plain(k8, setup, dt, in_channels=w,
                                       out_channels=w)
    assert _rel(dxj, wdx) <= 1e-4 and torch.equal(dmsg, wdm)


def _same_specials(got, want):
    """NaN and inf where the plain version has them, the finite rest
    within 1e-4 of its max-abs."""
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    assert torch.equal(got[torch.isinf(got)], want[torch.isinf(want)])
    ok = torch.isfinite(want)
    assert _rel(got[ok], want[ok]) <= 1e-4


@pytest.mark.parametrize("name", ["float8_e4m3", "float8_e5m2"])
@pytest.mark.parametrize("w", [64, 12])
def test_fp8_special_values_match_plain(dev, name, w):
    """A k8 stream holding e4m3 NaN or e5m2 inf (K above the fp8 range)
    gives K2 and both B2-bwd forms the plain versions' NaN and inf, and
    the same finite values elsewhere."""
    g = torch.Generator().manual_seed(w + 11)
    n, e = 40, 2048
    recv = torch.sort(torch.randint(0, n, (e,), generator=g)).values
    mask = torch.arange(e) < e - 100
    s = torch.randint(0, n, (e,), generator=g).to(dev)
    K = torch.randn(e, w * w, generator=g) * 30
    # on live edges only (the plain backward multiplies a masked
    # edge's K by zero, which keeps its NaN)
    K.view(-1)[torch.randint(0, (e - 100) * w * w, (40,), generator=g)] = 1e6
    k8 = to_fp8(K.to(torch.bfloat16).to(dev), name)
    special = torch.isnan(k8.float()) | torch.isinf(k8.float())
    assert int(special.sum()) > 0
    x = torch.randn(n, w, generator=g).to(dev)
    dt = torch.randn(n, w, generator=g).to(dev)
    setup = sorted_iterate_setup(recv.to(dev), mask.to(dev), n)
    kw = dict(in_channels=w, out_channels=w)
    _same_specials(fused_iterate_total(x, s, k8.float(), setup, k8=k8, **kw),
                   fused_iterate_total_plain(x, s, k8, setup, **kw))
    dxj, dmsg = fused_iterate_bwd(k8, setup, dt, **kw)
    wdx, wdm = fused_iterate_bwd_plain(k8, setup, dt, **kw)
    _same_specials(dxj, wdx)
    assert torch.equal(dmsg, wdm)


def test_to_fp8_on_card_matches_cpu(dev):
    """The card's fp8 rounding is the CPU's, the e4m3 overflow to NaN
    included."""
    v = torch.cat([torch.randn(100_000) * 100,
                   torch.tensor([448.0, 464.0, 464.01, 1e6, float("inf"),
                                 -float("inf"), -500.0])])
    for name in ("float8_e4m3", "float8_e5m2"):
        for dt in (torch.float32, torch.bfloat16):
            a = to_fp8(v.to(dt).to(dev), name).view(torch.uint8).cpu()
            b = to_fp8(v.to(dt), name).view(torch.uint8)
            assert torch.equal(a, b), (name, dt)


@pytest.mark.parametrize("k_storage", ["float8_e4m3", "float8_e5m2"])
@pytest.mark.parametrize("dtype,tol", [(None, 1e-4),
                                       ("bfloat16", GRAD_BF16_TOL)])
def test_gkn_fp8_grads_on_card_match_cpu(dev, k_storage, dtype, tol,
                                        monkeypatch):
    """kcached_fused='on' with fp8 K storage: the card's forward and
    gradients (K2 and B2-bwd on k8, one launch of each fp8 form per
    depth step) against the same Functions' plain versions on the CPU.

    fp8 rounding turns the last-bit differences of a K built by cuBLAS and
    by the CPU into whole fp8 steps (1/8 of a value in e4m3) wherever a
    value lies near a rounding edge; so both sides build K in float64
    here (rounded to K's dtype from nearly the same value), and the
    comparison holds the fp8 kernels, not the K build."""
    def k_build_f64(kp, attr, *, compute_dtype, k_dtype, k_storage):
        assert k_storage is None    # the fused path rounds its own k8
        if compute_dtype is not None:
            kp = cast_params(kp, torch.bfloat16)
            attr = attr.to(torch.bfloat16)
        kp64 = tuple({k: v.double() for k, v in layer.items()}
                     for layer in kp)
        return dense_apply(kp64, attr.double()).to(k_dtype)

    monkeypatch.setattr(importlib.import_module(
        "graph_pde_tpu_torch.models.gkn"), "build_cached_k", k_build_f64)
    rng = np.random.default_rng(0)
    n, e = 200, 3000
    host = build_graph(rng.normal(size=(n, 6)), rng.integers(0, n, e),
                       rng.integers(0, n, e), rng.normal(size=(e, 6)))
    cfg = GKNConfig(width=64, ker_width=128, depth=3, ker_in=6, in_width=6,
                    kernel_layers=(6, 64, 128, 4096), impl="kcached",
                    kcached_fused="on", compute_dtype=dtype,
                    k_storage=k_storage)
    p = gkn_init(torch.Generator().manual_seed(1), cfg, device="cpu")
    attr = "e4m3_launches" if k_storage == "float8_e4m3" else "e5m2_launches"
    before = (getattr(fused_iterate_total, attr),
              getattr(fused_iterate_bwd, attr))
    out, grads = _grads(p, cfg, host.to())
    torch.cuda.synchronize()
    assert (getattr(fused_iterate_total, attr) - before[0],
            getattr(fused_iterate_bwd, attr) - before[1]) == (3, 3)
    want_out, want = _grads(p, cfg, host.to("cpu"))
    assert _rel(out, want_out) <= (1e-4 if dtype is None else 5e-3)
    for j, (a, b) in enumerate(zip(grads, want)):
        assert _rel(a, b) <= tol, j


_SHARDED_RANK = r'''
import json, sys
import numpy as np
import torch
from graph_pde_tpu_torch import parallel as par
from graph_pde_tpu_torch.graph import build_graph
from graph_pde_tpu_torch.models import GKNConfig, gkn_init
from graph_pde_tpu_torch.ops.fused_edge_conv import fused_edge_messages

rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
torch.backends.cuda.matmul.allow_tf32 = False
par.initialize(f"localhost:{port}", 2, rank)
assert torch.distributed.get_backend() == "gloo"
rng = np.random.default_rng(7)
n, e = 500, 9000
g = build_graph(rng.normal(size=(n, 6)), rng.integers(0, n, e),
                rng.integers(0, n, e), rng.normal(size=(e, 6)))
cfg = GKNConfig(width=64, ker_width=256, depth=2, impl="pallas",
                kernel_layers=(6, 128, 256, 4096))
p = gkn_init(torch.Generator().manual_seed(3), cfg, device="cuda")
mesh = par.make_mesh((2,), ("data",))
parts = par.partition_graph(g, 2)
fused_edge_messages.launches = fused_edge_messages.simt_launches = 0
with torch.no_grad():
    y = par.gkn_apply_node_sharded(p, cfg, parts, mesh, impl="pallas")
torch.cuda.synchronize()
np.save(f"{out}/rank{rank}.npy", y.cpu().numpy())
with open(f"{out}/rank{rank}.json", "w") as f:
    json.dump([fused_edge_messages.launches,
               fused_edge_messages.simt_launches], f)
torch.distributed.destroy_process_group()
'''


def test_node_sharded_gkn_two_ranks_on_one_card(dev, tmp_path):
    """Two ranks share cuda:0 over gloo through the node-sharded GKN
    forward with impl='pallas': each launches K1 (SIMT form) once a
    depth step on its edge bucket, whose senders index the all-gathered
    features; the gathered output equals the single-process forward
    within 1e-4 of its max-abs on the valid nodes."""
    import json
    import os
    import socket
    import subprocess
    import sys

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _SHARDED_RANK, str(r), str(port),
         str(tmp_path)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out}"
    rng = np.random.default_rng(7)
    n, e = 500, 9000
    g = build_graph(rng.normal(size=(n, 6)), rng.integers(0, n, e),
                    rng.integers(0, n, e), rng.normal(size=(e, 6)))
    cfg = GKNConfig(width=64, ker_width=256, depth=2, impl="pallas",
                    kernel_layers=(6, 128, 256, 4096))
    p = gkn_init(torch.Generator().manual_seed(3), cfg, device=dev)
    with torch.no_grad():
        want = gkn_apply(p, cfg, g.to(dev))[:n]
    for r in range(2):
        got = torch.from_numpy(np.load(tmp_path / f"rank{r}.npy"))[:n]
        assert _rel(got, want.cpu()) <= 1e-4
        with open(tmp_path / f"rank{r}.json") as f:
            assert json.load(f) == [cfg.depth, cfg.depth]


def test_span_clock_matches_the_device_trace(dev):
    """A program span (``utils.tracing``, stamped with time.time_ns())
    around ``synchronize()`` after a ~2 ms device sleep ends just after
    the sleep kernel does, as a device-only torch.profiler stamps it
    (its raw events, read as ``benchmark/trace.py`` reads them).

    The profiler converts the device's timestamps to the wall clock
    with an error of its own in each session (0 to 0.45 ms on the H100,
    the same for every event of one session). So the session's offset
    is measured once as it opens, by the same probe after the session's
    first launch, and taken out: then each of five later kernels ends
    after its span opens and within 0.2 ms of the span's end."""
    from torch.autograd import DeviceType

    from graph_pde_tpu_torch.utils import tracing

    def sleep_then_sync():
        torch.cuda._sleep(4_000_000)
        with tracing.span("sync"):
            torch.cuda.synchronize()

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)        # the session's first launch
        torch.cuda.synchronize()
        with tracing.recording() as rec:
            for _ in range(6):
                sleep_then_sync()
    kernels = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            f = getattr(e, "start_ns", None)
            start = int(f()) if f else int(e.start_us() * 1e3)
            kernels.append((start, int(e.duration_ns())))
    ends = [start + dur for start, dur in sorted(kernels) if dur > 5e5]
    assert len(ends) == len(rec.spans) == 6
    raw = [t1 - end for end, (_, _, _, t1) in zip(ends, rec.spans)]
    offset = raw[0]
    print("span end - kernel end (ms): "
          + ", ".join(f"{r * 1e-6:.4f}" for r in raw))
    for end, (_, _, t0, t1) in zip(ends[1:], rec.spans[1:]):
        assert t0 <= end + offset and abs(t1 - (end + offset)) <= 200_000


def test_orthogonal_kcached_contracts_on_b3(dev):
    """impl='kcached' in float32 on the card: every conv's contraction
    takes B3, so B3-fwd and B3-bwd each launch edge lists x depth times
    a forward and backward, and the output and every parameter gradient
    equal the same model's on CPU tensors (the plain path) within 1e-5
    of their max-abs. With compute_dtype='bfloat16' (a bf16 K) no B3
    launches and every contraction counts on the plain path."""
    from types import SimpleNamespace

    from graph_pde_tpu_torch.data import burgers_multipole_data
    from graph_pde_tpu_torch.models import (MGKNOrthogonalConfig,
                                            mgkn_orthogonal_apply_batched,
                                            mgkn_orthogonal_init,
                                            multipole_batch)
    from graph_pde_tpu_torch.utils import tracing

    cfg = MGKNOrthogonalConfig(width=64, ker_width=64, depth=2, s=32,
                               impl="kcached")
    rng = np.random.default_rng(19)
    a, u = rng.standard_normal((2, 2, cfg.s)).astype(np.float32)
    host = multipole_batch(*burgers_multipole_data(SimpleNamespace(a=a,
                                                                   u=u)))
    params = mgkn_orthogonal_init(torch.Generator().manual_seed(19), cfg,
                                  device="cpu")
    cot = torch.randn(2, cfg.s, 1, generator=torch.Generator().manual_seed(3))

    def run(c, device):
        p = trainable(params, device)
        with tracing.recording() as rec:
            out = mgkn_orthogonal_apply_batched(p, c, host.to(device))
            (out * cot.to(device)).sum().backward()
        return (out.detach().cpu(), [t.grad.cpu() for t in param_leaves(p)],
                rec.counters)

    uses = (cfg.level + 1) * cfg.depth
    before = (cached_contraction.launches, cached_contraction_bwd.launches)
    out, grads, counters = run(cfg, dev)
    torch.cuda.synchronize()
    assert (cached_contraction.launches - before[0],
            cached_contraction_bwd.launches - before[1]) == (uses, uses)
    assert counters.get("contract_b3") == uses
    assert "contract_plain" not in counters
    want_out, want, cpu_counters = run(cfg, "cpu")
    assert cpu_counters.get("contract_plain") == uses
    assert _rel(out, want_out) <= 1e-5
    errs = [_rel(g, w) for g, w in zip(grads, want)]
    print("gradient errors " + " ".join(f"{v:.2e}" for v in errs))
    assert max(errs) <= 1e-5

    bf16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    before = (cached_contraction.launches, cached_contraction_bwd.launches)
    _, _, counters = run(bf16, dev)
    torch.cuda.synchronize()
    assert (cached_contraction.launches,
            cached_contraction_bwd.launches) == before
    assert counters.get("contract_plain") == uses
    assert "contract_b3" not in counters
