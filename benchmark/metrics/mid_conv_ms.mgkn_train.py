"""Host wall time in the general-MGKN forward's same-level convs (the
port's ``conv.mid`` spans: gather, kcached contraction, masked mean and
root weight, 3 a V-cycle), ms a step, mean over the traced window."""
from benchmark import program_spans


def read(ctx):
    return program_spans.span_ms(ctx, "conv.mid")
