"""Data, tensor and node-sharded parallelism on torch.distributed
(counterpart of graph_pde_tpu/parallel/). The port-only names are the
collectives that jax.lax provides there (``all_gather_rows``,
``gather_shards``, ``ring_shift``, ``copy_to``, ``reduce_from``,
``axis_index``, ``axis_size``), ``allreduce_grads`` and ``global_sum``
(the data-parallel train step's sums), and
``gather_params`` / ``TPKernel`` for tensor-parallel parameters."""
from .mesh import make_mesh, default_mesh_shape
from .distributed import initialize, is_multiprocess
from .sharding import (
    batch_spec,
    batch_sharding,
    param_specs,
    param_sharding,
    replicated_sharding,
    gather_params,
    TPKernel,
)
from .halo import (partition_graph, partition_graph_ring,
                   gkn_apply_node_sharded,
                   gkn_apply_node_sharded_ring)
from .halo_mgkn import (partition_multilevel_graph,
                        mgkn_general_apply_node_sharded,
                        partition_multipole1d,
                        mgkn_orthogonal_apply_node_sharded)
from ._comm import (all_gather_rows, gather_shards, ring_shift, copy_to,
                    reduce_from, axis_index, axis_size, allreduce_grads,
                    global_sum)

__all__ = [
    "make_mesh", "default_mesh_shape", "initialize", "is_multiprocess",
    "batch_spec", "batch_sharding", "param_specs", "param_sharding",
    "replicated_sharding",
    "partition_graph", "partition_graph_ring",
    "gkn_apply_node_sharded", "gkn_apply_node_sharded_ring",
    "partition_multilevel_graph", "mgkn_general_apply_node_sharded",
    "partition_multipole1d", "mgkn_orthogonal_apply_node_sharded",
    # port-only
    "all_gather_rows", "gather_shards", "ring_shift", "copy_to",
    "reduce_from", "axis_index", "axis_size", "allreduce_grads",
    "global_sum", "gather_params", "TPKernel",
]
