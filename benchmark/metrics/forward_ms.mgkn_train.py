"""Host wall time in the general-MGKN step's forward and loss (the
port's ``forward`` spans inside ``train_step``), ms a step, mean over
the traced window."""
from benchmark import program_spans


def read(ctx):
    return program_spans.span_ms(ctx, "forward")
