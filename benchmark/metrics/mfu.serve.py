"""The whole request's share of the chip's peak: the least time the
forwards of every window of the traced requests need at the published
peaks, counted from the windows' valid edges, over the traced window,
in percent."""
from benchmark import readers


def read(ctx):
    return readers.mfu(ctx)
