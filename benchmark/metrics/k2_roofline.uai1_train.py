"""K2 (``ops/fused_iterate.py``'s per-node sum of the cached-K
contraction, the kernels ``iterate_total*_kernel``) at the cell's graph:
the bound of a launch (``cost_iterate.k2_cost`` on the valid edges, a
float32 K) over the mean device time of a launch in the traced window
(launches by the port's counter ``K2``), in percent."""
from benchmark import cost_iterate, readers


def read(ctx):
    s = ctx.shapes
    if "edges_padded" not in s:
        return None
    bound = cost_iterate.k2_cost(s["edges_padded"], s["edges"], s["nodes"],
                                 s["width"], s["width"])["bound_s"]
    return readers.roofline(ctx, r"iterate_total(_fp8|_general)?_kernel",
                            "K2", bound)
