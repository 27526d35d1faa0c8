"""Host wall time in the general-MGKN step's ``loss.backward()`` (the
port's ``backward`` spans), ms a step, mean over the traced window."""
from benchmark import program_spans


def read(ctx):
    return program_spans.span_ms(ctx, "backward")
