"""The whole training step's share of the chip's peak: the least time
the step's useful model FLOPs need at the published peaks (bf16 989
TFLOP/s, fp32 67; the two kinds of unit at once), counted from the
shapes on valid edges and nodes with the backward as twice the forward,
over the traced window, in percent."""
from benchmark import readers


def read(ctx):
    return readers.mfu(ctx)
