from .graph import (Graph, MultiLevelGraph, build_graph,
                    build_multilevel_graph, pad_capacities, stack_graphs,
                    flatten_stacked, repad_edges, round_up)
from .build import radius_connectivity, forward_filter, edge_attributes
from .mesh import (make_box_grid, SquareMeshGenerator, RandomMeshGenerator,
                   RandomTwoMeshGenerator, RandomMultiMeshGenerator)
from .splitters import (RandomGridSplitter, RandomMultiMeshSplitter,
                        DownsampleGridSplitter)

__all__ = [
    "Graph", "MultiLevelGraph", "build_graph", "build_multilevel_graph",
    "pad_capacities", "stack_graphs", "flatten_stacked", "repad_edges",
    "round_up",
    "radius_connectivity", "forward_filter", "edge_attributes",
    "make_box_grid", "SquareMeshGenerator", "RandomMeshGenerator",
    "RandomTwoMeshGenerator", "RandomMultiMeshGenerator",
    "RandomGridSplitter", "RandomMultiMeshSplitter",
    "DownsampleGridSplitter",
]
