"""Host wall time in the serving splitter (the port's ``split`` spans:
``RandomMultiMeshSplitter.splitter``'s radius graphs, edge attributes
and padding of every window), ms a request, mean over the traced
window."""
from benchmark import program_spans


def read(ctx):
    return program_spans.span_ms(ctx, "split")
