"""The whole orthogonal-MGKN training step's share of the chip's peak:
the least time the step's useful model FLOPs need at the published fp32
peak (67 TFLOP/s), counted from the edge lists' lengths
(``systems/mgkn_orthogonal.py``: each kappa once a forward) with the
backward as twice the forward, over the traced window, in percent."""
from benchmark import readers


def read(ctx):
    return readers.mfu(ctx)
