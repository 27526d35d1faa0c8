"""Host wall time in the general-MGKN step's optimizer (the port's
``optimizer`` spans: the zero-gradient fill and Adam's step), ms a
step, mean over the traced window."""
from benchmark import program_spans


def read(ctx):
    return program_spans.span_ms(ctx, "optimizer")
