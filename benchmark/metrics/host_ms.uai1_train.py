"""Host wall time inside each UAI-GKN training-step call (the
benchmark's own span around the program's ``train_step``), ms a step,
mean over the traced window."""


def read(ctx):
    spans = ctx.spans.get("train_step")
    return 1e3 * sum(spans) / len(spans) if spans else None
