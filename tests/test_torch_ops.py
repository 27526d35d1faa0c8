"""Port parity: ops of graph_pde_tpu_torch against graph_pde_tpu, on the
CPU, where the kernel wrappers run their plain PyTorch versions and the
JAX Pallas kernels run in interpret mode.

Tolerance: float32 ops agree to 1e-5 relative to the output's max-abs
(sums over at most a few hundred terms, taken in different orders).
bf16 paths round at the same places in both packages; what differs is
the fp32 summation order before a rounding, which can flip one bf16
ulp, so they are held at 1e-2 relative to the max-abs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_pde_tpu.ops import dense as jdense
from graph_pde_tpu.ops import edge_conv as jconv
from graph_pde_tpu.ops import segment as jseg
from graph_pde_tpu.ops.fused_iterate import (fused_iterate_total as
                                             j_iterate_total,
                                             sorted_iterate_setup as
                                             j_iterate_setup)
from graph_pde_tpu.ops.pallas_edge_conv import fused_edge_messages as j_fused

from graph_pde_tpu_torch.convert import gkn_params_from_numpy
from graph_pde_tpu_torch.ops import dense as tdense
from graph_pde_tpu_torch.ops import edge_conv as tconv
from graph_pde_tpu_torch.ops import segment as tseg
from graph_pde_tpu_torch.ops.cached_contraction import (apply_cached_kernel,
                                                        maybe_quantize_k)
from graph_pde_tpu_torch.ops import fused_edge_conv as fe
from graph_pde_tpu_torch.ops.fused_edge_conv import (b1_bwd_form,
                                                     b1_bwd_simt_grid,
                                                     edge_messages_plain,
                                                     fused_edge_messages,
                                                     fused_path_supported,
                                                     k1_form,
                                                     k1_general_groups,
                                                     k1_simt_groups,
                                                     kernel_shape_supported)
from graph_pde_tpu_torch.ops.fused_iterate import (b2_bwd_form,
                                                   fused_iterate_supported,
                                                   fused_iterate_total,
                                                   sorted_iterate_setup)
from graph_pde_tpu_torch.ops.kcached_loop import build_cached_k

F32_TOL = 1e-5
BF16_TOL = 1e-2


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"max-abs error {err:.3g} > {tol:g} of max-abs"


def _kparams(layers, seed):
    jp = jdense.dense_init(jax.random.PRNGKey(seed), layers)
    return jp, gkn_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _t(a):
    return torch.as_tensor(np.asarray(a))


def test_dense_apply_matches():
    rng = np.random.default_rng(0)
    jp, tp = _kparams([6, 16, 32, 64], 0)
    a = rng.normal(size=(50, 6)).astype(np.float32)
    _close(tdense.dense_apply(tp, _t(a)).numpy(),
           jdense.dense_apply(jp, jnp.asarray(a)), F32_TOL)


def test_dense_init_distributions():
    gen = torch.Generator().manual_seed(0)
    p = tdense.linear_init(gen, 100, 400, device="cpu")
    assert p["w"].shape == (100, 400) and p["b"].shape == (400,)
    bound = 1.0 / np.sqrt(100)
    w = p["w"].numpy()
    assert np.abs(w).max() <= bound
    # U(-b, b): mean 0, std b / sqrt(3); 40k draws
    assert abs(w.mean()) < 0.02 * bound
    assert abs(w.std() - bound / np.sqrt(3)) < 0.02 * bound
    u = tdense.pyg_uniform_init(gen, 64, (64, 64), device="cpu").numpy()
    assert np.abs(u).max() <= 1.0 / 8.0
    net = tdense.dense_init(gen, [6, 16, 32], device="cpu")
    assert [tuple(l["w"].shape) for l in net] == [(6, 16), (16, 32)]


@pytest.mark.parametrize("with_mask", [False, True])
def test_masked_segment_mean_matches(with_mask):
    rng = np.random.default_rng(1)
    e, n = 400, 50
    data = rng.normal(size=(e, 8)).astype(np.float32)
    ids = np.sort(rng.integers(0, n - 10, e))   # last 10 segments empty
    mask = rng.uniform(size=e) > 0.3 if with_mask else np.ones(e, bool)
    want = jseg.masked_segment_mean(jnp.asarray(data), jnp.asarray(ids),
                                    jnp.asarray(mask), n)
    got = tseg.masked_segment_mean(_t(data), _t(ids).long(), _t(mask), n)
    _close(got.numpy(), want, F32_TOL)
    assert np.all(got.numpy()[n - 10:] == 0.0)
    want_s = jseg.masked_segment_sum(jnp.asarray(data), jnp.asarray(ids),
                                     jnp.asarray(mask), n)
    got_s = tseg.masked_segment_sum(_t(data), _t(ids).long(), _t(mask), n)
    _close(got_s.numpy(), want_s, F32_TOL)


def _conv_inputs(seed, n=60, e=700, w=8, kernel_type="full"):
    rng = np.random.default_rng(seed)
    out_k = w * w if kernel_type == "full" else w
    jp, tp = _kparams([6, 16, 32, out_k], seed)
    x = rng.normal(size=(n, w)).astype(np.float32)
    send = rng.integers(0, n, e)
    recv = np.sort(rng.integers(0, n, e))
    attr = rng.normal(size=(e, 6)).astype(np.float32)
    mask = np.arange(e) < e - 40
    root = rng.normal(size=(w, w)).astype(np.float32) * 0.3
    bias = rng.normal(size=(w,)).astype(np.float32)
    return jp, tp, x, send, recv, attr, mask, root, bias


@pytest.mark.parametrize("kernel_type,impl,aggr", [
    ("full", "reference", "mean"), ("diag", "reference", "mean"),
    ("full", "scan", "mean"), ("full", "reference", "add"),
    ("full", "auto", "mean"), ("full", "pallas", "mean"),
    ("full", "kcached", "mean")])
def test_edge_kernel_conv_matches(kernel_type, impl, aggr):
    """Each impl against JAX's; 'kcached' (K built once by
    build_cached_k) against JAX's 'reference', and its K goes with
    impl='kcached' only."""
    w = 8
    jp, tp, x, s, r, a, m, root, bias = _conv_inputs(2, w=w,
                                                     kernel_type=kernel_type)
    kw = dict(in_channels=w, out_channels=w, aggr=aggr,
              kernel_type=kernel_type, impl=impl, chunk_size=256)
    want = jconv.edge_kernel_conv(
        jnp.asarray(x), jnp.asarray(s), jnp.asarray(r), jnp.asarray(a),
        jnp.asarray(m), jp, root=jnp.asarray(root), bias=jnp.asarray(bias),
        **dict(kw, impl="reference" if impl == "kcached" else impl))
    args = (_t(x), _t(s).long(), _t(r).long(), _t(a), _t(m), tp)
    kk = build_cached_k(tp, _t(a)) if impl == "kcached" else None
    got = tconv.edge_kernel_conv(*args, root=_t(root), bias=_t(bias),
                                 cached_k=kk, **kw)
    _close(got.numpy(), want, F32_TOL)
    if impl == "kcached":
        with pytest.raises(ValueError, match="cached_k goes with"):
            tconv.edge_kernel_conv(*args, **kw)
        with pytest.raises(ValueError, match="cached_k goes with"):
            tconv.edge_kernel_conv(*args, cached_k=kk,
                                   **dict(kw, impl="reference"))


def _k1_inputs(seed, e, w=16):
    rng = np.random.default_rng(seed)
    jp, tp = _kparams([6, 16, 32, w * w], seed)
    x = rng.normal(size=(40, w)).astype(np.float32)
    s = rng.integers(0, 40, e)
    a = rng.normal(size=(e, 6)).astype(np.float32)
    return jp, tp, x, s, a


@pytest.mark.parametrize("e,dtype", [(1024, None), (1000, None),
                                     (1024, "bfloat16")])
def test_fused_edge_messages_plain_matches_pallas(e, dtype):
    """K1's plain version vs the JAX fused kernel (interpret mode),
    including a ragged E and bf16 compute."""
    w = 16
    jp, tp, x, s, a = _k1_inputs(3, e, w)
    want = j_fused(jnp.asarray(x), jnp.asarray(s), jnp.asarray(a), jp,
                   in_channels=w, out_channels=w, compute_dtype=dtype,
                   interpret=True)
    got = edge_messages_plain(_t(x), _t(s).long(), _t(a), tp,
                              in_channels=w, out_channels=w,
                              compute_dtype=dtype)
    _close(got.numpy(), want, F32_TOL if dtype is None else BF16_TOL)
    # the wrapper takes the plain version for CPU tensors, uncounted
    before = fused_edge_messages.launches
    wrapped = fused_edge_messages(_t(x), _t(s).long(), _t(a), tp,
                                  in_channels=w, out_channels=w,
                                  compute_dtype=dtype)
    torch.testing.assert_close(wrapped, got, rtol=0, atol=0)
    assert fused_edge_messages.launches == before


def test_fused_path_gate():
    """The port's gates are the JAX package's, shape for shape: the CUDA
    kernels take every shape the JAX gates admit, so 'auto' and
    kcached_fused pick the same branch in both packages."""
    from graph_pde_tpu.ops.fused_iterate import (fused_iterate_supported
                                                 as j_iter_ok)
    from graph_pde_tpu.ops.pallas_edge_conv import (fused_path_supported
                                                    as j_fused_ok)

    shapes = [([6, 128, 256, 64 * 64], 64, 64),      # neurips1 GKN
              ([6, 1024, 1024, 64 * 64], 64, 64),    # ker_width 1024 'nn'
              ([6, 500, 1000, 64 * 64], 64, 64),     # ker_width 1000 'nn3'
              ([6, 16, 32, 16 * 16], 16, 16),
              ([6, 32, 64], 64, 64),                 # diag-shaped output
              ([6, 16, 3000, 64 * 64], 64, 64)]      # last layer too wide
    for layers, i, o in shapes:
        jp, tp = _kparams(layers, 0)
        assert fused_path_supported(tp, i, o) == j_fused_ok(jp, i, o), layers
    assert fused_path_supported(_kparams([6, 1024, 1024, 4096], 0)[1], 64, 64)
    assert not fused_path_supported(_kparams([6, 32, 64], 0)[1], 64, 64)
    for args in [(1024, 64, 64, 64), (1000, 64, 64, 64), (1024, 64, 64, 0),
                 (1024, 128, 128, 64), (1024, 6, 6, 64), (512, 16, 16, 8)]:
        assert fused_iterate_supported(*args) == j_iter_ok(*args), args
    assert fused_iterate_supported(1024, 128, 128, 64)


# (kw, in, out) of the B1-bwd card tests (tests/test_torch_cuda.py), and
# the B2-bwd widths they take
B1_SHAPES = [(256, 64, 64), (1024, 64, 64), (32, 16, 16), (6, 3, 100),
             (40, 2, 200)]
B2_WIDTHS = [6, 8, 12, 16, 32, 64, 128, 256, 512, 1024]


def test_backward_kernel_forms():
    """Every (kw, in, out) of the registry's kappas (and their smoke
    sizes) and of the card tests that the JAX fused-path gate admits maps
    to one B1-bwd form per compute dtype, the SIMT form in float32; every
    width the JAX iteration gate admits maps to one B2-bwd form, and none
    that the general form would refuse. The GKN main paths take the
    redesigned forms: uai4_full_grid_241 (bf16, kw 256) and the
    ker_width-1024 kappa the tensor-core form, width 64 the warp form."""
    from graph_pde_tpu.experiments import registry
    from graph_pde_tpu.experiments.runners import _kernel_layers
    from graph_pde_tpu.ops.fused_iterate import (fused_iterate_supported
                                                 as j_iter_ok)
    from graph_pde_tpu.ops.pallas_edge_conv import (fused_path_supported
                                                    as j_fused_ok)

    shapes = set(B1_SHAPES)
    for name in registry.names():
        for cfg in (registry.get(name), registry.get(name).smoke()):
            shapes.add((_kernel_layers(cfg, 6)[-2], cfg.width, cfg.width))
    admitted = 0
    for kw, i, o in sorted(shapes):
        layers = [{"w": jax.ShapeDtypeStruct((6, kw), jnp.float32)},
                  {"w": jax.ShapeDtypeStruct((kw, i * o), jnp.float32)}]
        if not j_fused_ok(layers, i, o):
            continue
        admitted += 1
        assert b1_bwd_form(kw, i, o, None) == "simt"
        assert b1_bwd_form(kw, i, o, "bfloat16") in ("tc", "simt")
    assert admitted >= len(B1_SHAPES)
    for kw in (256, 1024, 1000):
        assert b1_bwd_form(kw, 64, 64, "bfloat16") == "tc", kw
    assert b1_bwd_form(6, 3, 100, "bfloat16") == "simt"
    assert b1_bwd_form(40, 2, 200, "bfloat16") == "simt"
    # the tensor-core form's in_channels bound (its shared memory)
    assert b1_bwd_form(256, 256, 64, "bfloat16") == "tc"
    assert b1_bwd_form(256, 264, 64, "bfloat16") == "simt"

    widths = set(B2_WIDTHS) | {o for _, _, o in shapes}
    for w in sorted(widths):
        for i in (1, 3, w):
            if not j_iter_ok(512, i, w, 64):
                continue
            form = b2_bwd_form(w)
            assert form in ("warp", "general")
            if form == "general":   # the block form's own shape rule
                assert i * w <= 4096 or 4096 % w == 0, (i, w)
    assert [w for w in sorted(widths) if b2_bwd_form(w) == "warp"] == [
        8, 16, 32, 64, 128, 256]


def test_k1_forms():
    """k1_form maps each shape to one K1 kernel form: the bf16 tensor-core
    form on the single-launch shapes with kw1 <= 128 (the GKN kappas,
    kw1 16 included), the SIMT form in float32 there and in bf16 where
    kw1 > 128, the general form on every other shape in both dtypes."""
    def dims(*layers):
        return list(zip(layers[:-1], layers[1:]))

    gkn = dims(6, 128, 256, 64 * 64)
    for dt in ("bfloat16", torch.bfloat16):
        assert k1_form(gkn, 64, 64, dt) == "tc"
    assert k1_form(gkn, 64, 64, None) == "simt"
    assert k1_form(dims(6, 32, 128, 4 * 64), 4, 64, "bfloat16") == "tc"
    assert k1_form(dims(6, 16, 128, 8 * 64), 8, 64, "bfloat16") == "tc"
    # off the tiles: kw1 beyond the last h2 column tile
    off = dims(6, 144, 256, 64 * 64)
    assert kernel_shape_supported(off, 64, 64)
    assert k1_form(off, 64, 64, "bfloat16") == "simt"
    assert k1_form(off, 64, 64, None) == "simt"
    # general: the ker_width 1024 kappa, out != 64, no small layer
    for layers, i, o in (((6, 1024, 1024, 64 * 64), 64, 64),
                         ((6, 16, 32, 16 * 16), 16, 16),
                         ((6, 3 * 100), 3, 100)):
        for dt in (None, "bfloat16"):
            assert k1_form(dims(*layers), i, o, dt) == "general", layers


# (E, kw, in, out) at which K1's general form and B1-bwd's SIMT form run:
# the orthogonal MGKN's ten levels at s=1024 (one sample's edges, kappa
# (4, kw, kw, 4096)), the MGKN-general kappas (ker_width 256: conv_mid
# (6, kw, kw, 4096) at kw 256, 128, 64; conv_down/up (6, kw, 4096) at
# kw 128, 64) at a small and a large edge count, the (6, 16, 32, 256)
# kappa and kw 40 with out 200
ORTHO_LEVELS = [(2048, 1024), (3066, 512), (1530, 256), (762, 128),
                (378, 64), (186, 32), (90, 16), (42, 16), (18, 16), (16, 16)]
GRID_SHAPES = ([(e, kw, 64, 64) for e, kw in ORTHO_LEVELS]
               + [(e, kw, 64, 64) for e in (4000, 131072)
                  for kw in (256, 128, 64)]
               + [(e, 32, 16, 16) for e in (3000, 131072)]
               + [(e, 40, 2, 200) for e in (1000, 131072)])
SMS = 132   # an H100's SMs


def _ranges(total, per, groups):
    """The contiguous runs [g * per, min(total, (g + 1) * per)) that a
    grid of ``groups`` blocks covers."""
    return [(g * per, min(total, (g + 1) * per)) for g in range(groups)]


def _covers_once(total, per, groups, unit):
    """The runs cover 0 .. total - 1 exactly once, each non-empty and
    starting on a multiple of ``unit``."""
    runs = _ranges(total, per, groups)
    assert [lo for lo, _ in runs[1:]] == [hi for _, hi in runs[:-1]]
    assert runs[0][0] == 0 and runs[-1][1] == total
    assert all(lo < hi and lo % unit == 0 for lo, hi in runs)


@pytest.mark.parametrize("e,kw,i,o", GRID_SHAPES)
def test_general_grids(e, kw, i, o):
    """The grids of K1's general form (channel groups G) and B1-bwd's
    SIMT form (dx channel groups Gx, dh depth splits S) on an H100's 132
    SMs: the groups cover every input channel once, each starting on a
    K tile's channels (K1: 128 // ow of them, ow = out rounded up to a
    power of two; B1-bwd: 128 // out where out divides 128, else one),
    the splits every column of the depth C once, each whole 16-deep
    slabs; one group and one split where the edge tiles fill the card
    (131,072 edges); else at least two waves of two resident blocks an
    SM, or every tile its own group where that is fewer blocks; the
    partial buffers within their stated bound."""
    et = -(-e // 128)
    two_waves = 2 * fe._RESIDENT * SMS
    # K1
    groups, per = k1_general_groups(e, i, o, SMS)
    ow = 1
    while ow < o and ow < 128:
        ow *= 2
    p = 128 // ow
    assert groups == -(-i // per)
    _covers_once(i, per, groups, p)
    blocks = et * groups * -(-o // 128)
    assert blocks >= two_waves or groups == -(-i // p)
    assert groups == 1 or groups * e * o <= fe._PART_ELEMS
    # B1-bwd: dx over channel groups, dh over depth splits
    gx, x_per, hs, depth = b1_bwd_simt_grid(e, kw, i, o, SMS)
    q = max(1, 128 // o)
    assert gx == -(-i // x_per)
    _covers_once(i, x_per, gx, q)
    assert et * gx >= two_waves or gx == -(-i // q)
    c = i * o
    assert hs == -(-c // depth)
    _covers_once(c, depth, hs, 16)
    assert et * -(-kw // 128) * hs >= two_waves or hs == -(-c // 16)
    assert hs == 1 or hs * e * kw <= fe._PART_ELEMS
    if e >= 131072:
        assert groups == gx == hs == 1
    if (e, kw) == (2048, 1024):
        # the widest orthogonal level: every K tile and every channel
        # pair its own group (512 blocks: two waves of one block an SM),
        # dh2 split five ways (640 blocks)
        assert (groups, gx, hs) == (32, 32, 5)
        assert blocks >= 2 * SMS and et * 8 * hs >= two_waves


@pytest.mark.parametrize("e,kw,c,want", [(1209117, 256, 4096, 16),
                                         (51200, 64, 1024, 32),
                                         (12800, 64, 1024, 13),
                                         (20011, 256, 4096, 16),
                                         (37, 256, 4096, 1),
                                         (5000, 1024, 4096, 4),
                                         (300, 8, 32768, 1)])
def test_b1_bwd_tc_splits(e, kw, c, want):
    """The dWl splits of B1-bwd's tensor-core form on an H100: its dw
    kernel runs one block an SM over 128 x 256 tiles of dWl, so at most
    four waves of them, no more splits than 1024-edge runs, at most 32;
    the uai4 graph takes 16 (512 blocks)."""
    splits = fe.b1_bwd_tc_splits(e, kw, c, SMS)
    assert splits == want
    tiles = -(-kw // 128) * -(-c // 256)
    assert 1 <= splits <= 32
    assert splits == 1 or splits * tiles <= 4 * SMS
    assert splits <= -(-e // 1024)


@pytest.mark.parametrize("layers,i,o", [((4, 32, 32, 32 * 8), 32, 8),
                                        ((6, 16, 3 * 100), 3, 100),
                                        ((6, 20, 2 * 200), 2, 200)])
def test_k1_channel_groups_sum_to_the_whole(layers, i, o):
    """K1's general form sums its channel groups' partial messages in
    group order: the plain version run per group on the group's slices
    of Wl, bl and x and summed so equals the whole plain output within
    1e-6 of its max-abs (the same fp32 products, their sum over the
    input channels taken in another order: a few float32 ulps)."""
    rng = np.random.default_rng(5)
    _, tp = _kparams(list(layers), 5)
    e = 700
    x = _t(rng.normal(size=(40, i)).astype(np.float32))
    s = _t(rng.integers(0, 40, e)).long()
    a = _t(rng.normal(size=(e, layers[0])).astype(np.float32))
    whole = edge_messages_plain(x, s, a, tp, in_channels=i, out_channels=o)
    groups, per = k1_general_groups(e, i, o, SMS)
    assert groups > 1
    total = torch.zeros_like(whole)
    for lo, hi in _ranges(i, per, groups):
        last = {"w": tp[-1]["w"][:, lo * o:hi * o],
                "b": tp[-1]["b"][lo * o:hi * o]}
        total += edge_messages_plain(x[:, lo:hi].contiguous(), s, a,
                                     [*tp[:-1], last], in_channels=hi - lo,
                                     out_channels=o)
    _close(total.numpy(), whole.numpy(), 1e-6)


# the clusters of G K1 SIMT blocks an H100 keeps resident at once, as
# cudaOccupancyMaxActiveClusters reported them on an NVIDIA H100 80GB
# HBM3 at the kappas (6, 128, 128, 4096), (4, 128, 128, 4096) and (6,
# 128, 256, 4096), in 64, both roundings (one block an SM; clusters are
# placed within a GPC); `python3 chip_smoke.py --k1-simt` logs them
H100_SIMT_CLUSTERS = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15,
                      8: 15, 9: 9, **{g: 7 for g in range(10, 17)}}
SIMT_CLUSTERS = {128: H100_SIMT_CLUSTERS, 256: H100_SIMT_CLUSTERS}


@pytest.mark.parametrize("kw2", [128, 256])
@pytest.mark.parametrize("e", [1, 127, 762, 4864, 131072, 1378816])
def test_k1_simt_groups(e, kw2):
    """K1 SIMT's grid on an H100's 132 SMs (in 64: 32 channel pairs):
    the clusters' ranks cover every pair once, each a non-empty run; G =
    1 where the edge tiles fill the card twice (131,072 edges and
    above); G within the largest resident cluster and the pairs; else
    the G, up to the fewest whose grid reaches two waves of resident
    clusters, with the least waves x pairs a block, the fewest G on a
    tie: at the general MGKN's mid l=1 (4,864 edges, 38 tiles) 3, at
    the orthogonal kw-128 level (762) and below one tile 16."""
    clusters = SIMT_CLUSTERS[kw2]
    pairs, tiles = 32, -(-e // 128)
    groups, per = k1_simt_groups(e, 64, SMS, clusters)
    _covers_once(pairs, per, groups, 1)
    assert groups == -(-pairs // per)
    fits = [g for g, n in clusters.items() if n >= 1 and g <= pairs]
    assert groups <= max(fits)
    if e >= 131072:
        assert (groups, per) == (1, pairs)
        return
    exact = [g for g in fits if -(-pairs // -(-pairs // g)) == g]
    two = next((g for g in exact if tiles >= 2 * clusters[g]), exact[-1])
    cost = {g: -(-tiles // clusters[g]) * -(-pairs // g)
            for g in exact if g <= two}
    assert groups == min(g for g in cost if cost[g] == min(cost.values()))
    assert groups == {1: 16, 127: 16, 762: 16, 4864: 3}[e]


def test_k1_simt_pair_groups_sum_to_the_whole():
    """K1's SIMT form sums its cluster ranks' partial messages in rank
    order: at a small single-launch shape ((4, 16, 128, 8 * 64), in 8,
    700 edges: four ranks of one channel pair) the plain version run per
    rank on the rank's slices of Wl, bl and x and summed so equals the
    whole plain output within 1e-6 of its max-abs (the same fp32
    products, their sum over the input channels taken in another
    order)."""
    layers, i, o, e = (4, 16, 128, 8 * 64), 8, 64, 700
    rng = np.random.default_rng(6)
    _, tp = _kparams(list(layers), 6)
    dims = [(a, b) for a, b in zip(layers, layers[1:])]
    assert k1_form(dims, i, o, None) == "simt"
    x = _t(rng.normal(size=(40, i)).astype(np.float32))
    s = _t(rng.integers(0, 40, e)).long()
    a = _t(rng.normal(size=(e, layers[0])).astype(np.float32))
    whole = edge_messages_plain(x, s, a, tp, in_channels=i, out_channels=o)
    groups, per = k1_simt_groups(e, i, SMS, H100_SIMT_CLUSTERS)
    assert (groups, per) == (4, 1)
    total = torch.zeros_like(whole)
    for lo, hi in _ranges(i // 2, per, groups):
        c0, c1 = 2 * lo, 2 * hi
        last = {"w": tp[-1]["w"][:, c0 * o:c1 * o],
                "b": tp[-1]["b"][c0 * o:c1 * o]}
        total += edge_messages_plain(x[:, c0:c1].contiguous(), s, a,
                                     [*tp[:-1], last], in_channels=c1 - c0,
                                     out_channels=o)
    _close(total.numpy(), whole.numpy(), 1e-6)


def test_library_name_covers_included_headers(tmp_path, monkeypatch):
    """A kernel library's name hashes the source, every csrc header it
    includes (through other headers too) and the flags, so an edited
    header is rebuilt rather than loaded stale."""
    from graph_pde_tpu_torch.ops import kernels

    (tmp_path / "a.cu").write_text('#include <cuda_runtime.h>\n'
                                   '#include "h1.cuh"\nint a;\n')
    (tmp_path / "h1.cuh").write_text('#pragma once\n#include "h2.cuh"\n')
    (tmp_path / "h2.cuh").write_text("int two;\n")
    monkeypatch.setattr(kernels, "CSRC", tmp_path)
    assert kernels._sources("a") == ["a.cu", "h1.cuh", "h2.cuh"]
    first = kernels.library_path("a")
    assert kernels.library_path("a") == first
    (tmp_path / "h2.cuh").write_text("int three;\n")
    second = kernels.library_path("a")
    assert second != first
    monkeypatch.setattr(kernels, "NVCC_FLAGS", kernels.NVCC_FLAGS + ("-I.",))
    assert kernels.library_path("a") not in (first, second)


@pytest.mark.parametrize("k_dtype", [np.float32, "bfloat16"])
def test_fused_iterate_plain_matches_pallas(k_dtype):
    """K2's plain version vs the JAX fused iteration (interpret mode),
    with padding edges parked on the last node, which is real here."""
    rng = np.random.default_rng(4)
    n, e, w = 30, 1024, 8
    recv = np.sort(rng.integers(0, n, e)).astype(np.int32)
    recv[-100:] = n - 1
    mask = np.arange(e) < e - 100
    s = rng.integers(0, n, e).astype(np.int32)
    x = rng.normal(size=(n, w)).astype(np.float32)
    kk = rng.normal(size=(e, w * w)).astype(np.float32)
    jk = jnp.asarray(kk)
    tk = _t(kk)
    if k_dtype == "bfloat16":
        jk, tk = jk.astype(jnp.bfloat16), tk.to(torch.bfloat16)
    span = 64
    oh, ids, counts = j_iterate_setup(jnp.asarray(recv), jnp.asarray(mask),
                                      n, span)
    want = j_iterate_total(jnp.asarray(x)[jnp.asarray(s)], jk, oh, ids, n,
                           span, in_channels=w, out_channels=w,
                           interpret=True)
    setup = sorted_iterate_setup(_t(recv).long(), _t(mask), n)
    got = fused_iterate_total(_t(x), _t(s).long(), tk, setup,
                              in_channels=w, out_channels=w)
    _close(got.numpy(), want, F32_TOL)
    np.testing.assert_array_equal(setup.counts.numpy(), np.asarray(counts))
    assert setup.rowptr[-1].item() == e


def test_sorted_iterate_setup_rejects_unsorted():
    with pytest.raises(ValueError, match="receiver-sorted"):
        sorted_iterate_setup(torch.tensor([0, 2, 1]),
                             torch.ones(3, dtype=torch.bool), 3)


@pytest.mark.parametrize("bf16", [False, True])
def test_apply_cached_kernel_matches(bf16):
    from graph_pde_tpu.ops.cached_contraction import (apply_cached_kernel
                                                      as j_apply)

    rng = np.random.default_rng(5)
    e, w = 300, 8
    x = rng.normal(size=(e, w)).astype(np.float32)
    kk = rng.normal(size=(e, w * w)).astype(np.float32)
    jk, tk = jnp.asarray(kk), _t(kk)
    if bf16:
        jk, tk = jk.astype(jnp.bfloat16), tk.to(torch.bfloat16)
    want = j_apply(jnp.asarray(x), jk, w, w)
    got = apply_cached_kernel(_t(x), tk, w, w)
    _close(got.numpy(), want, F32_TOL if not bf16 else BF16_TOL)
    assert maybe_quantize_k(tk, None) is tk
    with pytest.raises(ValueError, match="unknown k_storage"):
        maybe_quantize_k(tk, "float8")
    # fp8 storage behind the straight-through estimator, as in JAX
    from graph_pde_tpu.ops.cached_contraction import (maybe_quantize_k
                                                      as j_quantize)
    want = j_apply(jnp.asarray(x), j_quantize(jk, "float8_e4m3"), w, w)
    got = apply_cached_kernel(_t(x), maybe_quantize_k(tk, "float8_e4m3"),
                              w, w)
    _close(got.numpy(), want, F32_TOL if not bf16 else BF16_TOL)
