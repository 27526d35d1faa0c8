"""Host wall time in the orthogonal MGKN's kcached K build (the port's
``kbuild`` span: the ten kappa MLPs on their edge lists, once a
forward), ms a step, mean over the traced window."""
from benchmark import program_spans


def read(ctx):
    return program_spans.span_ms(ctx, "kbuild")
