from .graph import (Graph, build_graph, stack_graphs, flatten_stacked,
                    repad_edges, round_up)
from .build import radius_connectivity, forward_filter, edge_attributes
from .mesh import make_box_grid, SquareMeshGenerator, RandomMeshGenerator
from .splitters import RandomGridSplitter, DownsampleGridSplitter

__all__ = [
    "Graph", "build_graph", "stack_graphs", "flatten_stacked", "repad_edges",
    "round_up",
    "radius_connectivity", "forward_filter", "edge_attributes",
    "make_box_grid", "SquareMeshGenerator", "RandomMeshGenerator",
    "RandomGridSplitter", "DownsampleGridSplitter",
]
