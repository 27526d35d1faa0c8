from .graph import (Graph, MultiLevelGraph, NodeBatch, build_graph,
                    build_multilevel_graph, pad_capacities, stack_graphs,
                    flatten_stacked, repad_edges, round_up)
from .lattice import (simple_grid, grid_edge, grid_edge1d, grid_edge_aug,
                      grid_edge_aug_full, downsample_field, multi_grid)
from .build import (radius_connectivity, forward_filter, edge_attributes,
                    gaussian_connectivity, torus1d_connectivity,
                    torus2d_connectivity)
from .mesh import (make_box_grid, SquareMeshGenerator, RandomMeshGenerator,
                   RandomTwoMeshGenerator, RandomMultiMeshGenerator)
from .splitters import (RandomGridSplitter, RandomMultiMeshSplitter,
                        DownsampleGridSplitter, TorusGridSplitter)

__all__ = [
    "Graph", "MultiLevelGraph", "NodeBatch", "build_graph",
    "build_multilevel_graph", "pad_capacities", "stack_graphs", "flatten_stacked", "repad_edges",
    "round_up",
    "simple_grid", "grid_edge", "grid_edge1d", "grid_edge_aug",
    "grid_edge_aug_full", "downsample_field", "multi_grid",
    "radius_connectivity", "forward_filter", "edge_attributes",
    "gaussian_connectivity", "torus1d_connectivity", "torus2d_connectivity",
    "make_box_grid", "SquareMeshGenerator", "RandomMeshGenerator",
    "RandomTwoMeshGenerator", "RandomMultiMeshGenerator",
    "RandomGridSplitter", "RandomMultiMeshSplitter",
    "DownsampleGridSplitter", "TorusGridSplitter",
]
