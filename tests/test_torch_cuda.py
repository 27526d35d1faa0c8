"""The CUDA kernels of graph_pde_tpu_torch against their plain PyTorch
versions, on an NVIDIA GPU (sm_90a; nvcc builds them at first use).

Skips without a GPU. On the card (tests/conftest.py imports jax, which the
GPU machine need not have): python -m pytest --noconftest tests/test_torch_cuda.py

Tolerance: 1e-4 of the output's max-abs in float32 (sums in another
order); bf16 K1 at 5e-3 (one bf16 ulp can flip where the fp32 sums
before a rounding differ in order). TF32 is off for every comparison.
"""
import numpy as np
import pytest
import torch

from graph_pde_tpu_torch.graph import build_graph
from graph_pde_tpu_torch.models import GKNConfig, gkn_apply, gkn_init
from graph_pde_tpu_torch.models.gkn import params_to
from graph_pde_tpu_torch.ops.dense import dense_init
from graph_pde_tpu_torch.ops.fused_edge_conv import (edge_messages_plain,
                                                     fused_edge_messages)
from graph_pde_tpu_torch.ops.fused_iterate import (fused_iterate_total,
                                                   fused_iterate_total_plain,
                                                   sorted_iterate_setup)

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
