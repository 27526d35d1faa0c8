"""Host wall time in the orthogonal MGKN's convs on the coarser levels
(the port's ``conv.coarse`` spans, edge lists 2 and up; 8 a V-cycle at
s = 1024), ms a step, mean over the traced window."""
from benchmark import program_spans


def read(ctx):
    return program_spans.span_ms(ctx, "conv.coarse")
