"""Device-to-host copies of the predictor (the port's ``readbacks``
counter: each CUDA tensor it reads back, a wait for the device), a
request, mean over the traced window."""
from benchmark import program_spans


def read(ctx):
    return program_spans.counter(ctx, "readbacks")
