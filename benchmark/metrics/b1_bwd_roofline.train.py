"""B1-bwd (``ops/fused_edge_conv.py``'s backward of the last kappa
layer and the contraction, in its bf16 tensor-core form: the kernels
``tc::dx_dh_kernel``, ``tc::dw_kernel`` and the partial sums'
``reduce_kernel``) at the cell's conv: the bound of a launch
(``cost.b1_bwd_cost`` on the valid edges) over the mean device time of
a launch in the traced window, in percent."""
from benchmark import cost, readers


def read(ctx):
    s = ctx.shapes
    if "edges" not in s:
        return None
    layers = s["kernel_layers"]
    bound = cost.b1_bwd_cost(layers[-2], layers[-1], s["edges"],
                             s["nodes"], bf16=True,
                             w=s["width"])["bound_s"]
    kernels = (r"tc::dx_dh_kernel|tc::dw_kernel"
               r"|^\(anonymous namespace\)::reduce_kernel")
    return readers.roofline(ctx, kernels, "B1-bwd tc", bound)
