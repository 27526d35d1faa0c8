"""MiB of cached K the UAI GKN builds a step (the port's ``k_bytes``
counter, from K's shape and dtype: [E_pad, width^2] once a forward,
float32 unless the port lowered it), mean over the traced window; none
where the program never counted it."""
from benchmark import program_spans


def read(ctx):
    rec = program_spans.recording(ctx)
    if rec is None or "k_bytes" not in rec.counters:
        return None
    return program_spans.counter(ctx, "k_bytes", 2 ** 20)
