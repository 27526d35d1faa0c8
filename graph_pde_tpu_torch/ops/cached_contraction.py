"""Cached-K contraction of the unfused kcached path (counterpart of
``apply_cached_kernel`` and ``maybe_quantize_k`` in
graph_pde_tpu/ops/cached_contraction.py; plain PyTorch, as the JAX
package leaves this one to XLA).
"""
from __future__ import annotations

import torch

_CHUNK = 65536  # edges per step: bounds the [chunk, in, out] product


def apply_cached_kernel(x_src: torch.Tensor, kk2d: torch.Tensor,
                        in_channels: int, out_channels: int) -> torch.Tensor:
    """msg[e, o] = sum_i K[e, i, o] * x[e, i], float32 [E, out].

    Products are taken in K's dtype (a bf16 K rounds x to bf16 and each
    product to bf16) and summed in float32, as the JAX formulation does.
    """
    e = x_src.shape[0]
    out = torch.empty((e, out_channels), dtype=torch.float32,
                      device=x_src.device)
    for s0 in range(0, e, _CHUNK):
        s1 = min(e, s0 + _CHUNK)
        kk = kk2d[s0:s1].view(s1 - s0, in_channels, out_channels)
        xs = x_src[s0:s1].to(kk.dtype)
        out[s0:s1] = (kk * xs[:, :, None]).sum(dim=1, dtype=torch.float32)
    return out


def maybe_quantize_k(kk: torch.Tensor, k_storage) -> torch.Tensor:
    """The cached-K storage policy: None keeps K as it is. The JAX
    package's fp8 storage (a straight-through estimator in training,
    1-byte K streamed by its kernels) is not ported."""
    if k_storage is None:
        return kk
    if k_storage in ("float8_e4m3", "float8_e5m2"):
        raise NotImplementedError(
            f"k_storage={k_storage!r} (fp8 cached K behind a straight-"
            "through estimator) is not ported; use k_storage=None")
    raise ValueError(f"unknown k_storage {k_storage!r}")


__all__ = ["apply_cached_kernel", "maybe_quantize_k"]
