"""Percent of the traced UAI-GKN training window with no device
operation running (torch.profiler's device events, their intervals'
union)."""
from benchmark import readers


def read(ctx):
    return readers.idle_share(ctx)
