"""Host wall time in the serving windows (the port's ``window`` spans:
each window's graph to the device, its forward's enqueue and the wait
for its answer), ms a request, mean over the traced window."""
from benchmark import program_spans


def read(ctx):
    return program_spans.span_ms(ctx, "window")
