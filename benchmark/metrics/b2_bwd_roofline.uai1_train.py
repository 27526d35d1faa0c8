"""B2-bwd (``ops/fused_iterate.py``'s backward of the cached-K
contraction, the kernels ``iterate_bwd_warp_kernel`` and
``iterate_bwd_block_kernel``) at the cell's graph: the bound of a launch
(``cost_iterate.b2_bwd_cost`` on the valid edges, a float32 K) over the
mean device time of a launch in the traced window (launches by the
port's counter ``B2-bwd``), in percent."""
from benchmark import cost_iterate, readers


def read(ctx):
    s = ctx.shapes
    if "edges_padded" not in s:
        return None
    bound = cost_iterate.b2_bwd_cost(s["edges_padded"], s["edges"],
                                     s["nodes"], s["width"],
                                     s["width"])["bound_s"]
    return readers.roofline(ctx, r"iterate_bwd_(warp|block)_kernel",
                            "B2-bwd", bound)
