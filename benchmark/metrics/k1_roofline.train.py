"""K1 (``ops/fused_edge_conv.py``'s fused kappa MLP and contraction, in
its bf16 tensor-core form ``tc::k1_kernel``) at the cell's conv: the
bound of a launch (``cost.k1_cost`` on the valid edges and nodes, the
larger of its bytes and operations over the published peaks) over the
mean device time of a launch in the traced window, in percent."""
from benchmark import cost, readers


def read(ctx):
    s = ctx.shapes
    if "edges" not in s:
        return None
    bound = cost.k1_cost(s["kernel_layers"], s["edges"], s["nodes"],
                         tc=True, w=s["width"])["bound_s"]
    return readers.roofline(ctx, r"tc::k1_kernel", "K1 tc", bound)
