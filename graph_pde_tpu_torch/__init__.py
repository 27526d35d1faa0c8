"""PyTorch/CUDA port of graph_pde_tpu (GKN serving slice).

Mirrors the JAX package's module layout (graph/, ops/, models/, utils/,
data/, inference.py) so each module has an obvious counterpart. Tensors
follow the JAX package's layouts at every public function: parameters are
``{"w": [in, out], "b": [out]}`` dicts, graphs are padded and
receiver-sorted with padding edges parked at ``N_pad - 1``.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; with no GPU present they raise instead of falling back.
The two hand-written CUDA kernels (``ops/fused_edge_conv.py``,
``ops/fused_iterate.py``) are built from ``csrc/`` at first use.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
