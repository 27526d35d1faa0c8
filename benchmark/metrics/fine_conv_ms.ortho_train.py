"""Host wall time in the orthogonal MGKN's convs on the finest level
(the port's ``conv.fine`` spans, edge lists 0 and 1: gather, kcached
contraction, mean, root and bias; 2 a V-cycle), ms a step, mean over
the traced window."""
from benchmark import program_spans


def read(ctx):
    return program_spans.span_ms(ctx, "conv.fine")
