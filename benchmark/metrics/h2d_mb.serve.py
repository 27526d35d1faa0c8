"""Host-to-device bytes of the predictor (the port's ``h2d_bytes``
counter: every window's padded multilevel graph), MiB a request, mean
over the traced window."""
from benchmark import program_spans


def read(ctx):
    return program_spans.counter(ctx, "h2d_bytes", 2.0 ** 20)
