"""Host wall time in the UAI GKN's kcached K build (the port's
``kbuild`` span: kappa on every edge, once a forward), ms a step, mean
over the traced window; none where the program has no such span."""
from benchmark import program_spans


def read(ctx):
    return program_spans.span_ms(ctx, "kbuild")
