"""Host wall time in the general-MGKN forward's level transfers (the
port's ``conv.down`` and ``conv.up`` spans, 4 a V-cycle), ms a step,
mean over the traced window."""
from benchmark import program_spans


def read(ctx):
    return program_spans.span_ms(ctx, "conv.down", "conv.up")
