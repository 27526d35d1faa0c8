"""PyTorch/CUDA port of graph_pde_tpu (GKN, GCN and the two MGKNs on
Darcy and Burgers: serving, training, the experiment registry and
runner, bundles, run figures and the command line).

Mirrors the JAX package's module layout (graph/, ops/, models/, utils/,
data/, train/, experiments/, compat/, inference.py, cli.py) so each
module has an obvious counterpart. Tensors
follow the JAX package's layouts at every public function: parameters are
``{"w": [in, out], "b": [out]}`` dicts, graphs are padded and
receiver-sorted with padding edges parked at ``N_pad - 1``.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; with no GPU present they raise instead of falling back.
The hand-written CUDA kernels (``ops/fused_edge_conv.py``,
``ops/fused_iterate.py``, ``ops/cached_contraction.py``) are built from
``csrc/`` at first use.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
