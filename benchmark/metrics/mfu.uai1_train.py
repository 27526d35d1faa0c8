"""The whole UAI-GKN training step's share of the chip's peak: the least
time the step's useful model FLOPs need at the published fp32 peak (67
TFLOP/s), counted on the valid edges and nodes (``cost.
gkn_forward_flops``: kappa once a forward, the contraction every depth
step) with the backward as twice the forward, over the traced window,
in percent."""
from benchmark import readers


def read(ctx):
    return readers.mfu(ctx)
