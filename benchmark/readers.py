"""Shared arithmetic of the per-layer metric readers (``metrics/``)."""
from __future__ import annotations

from . import cost


def idle_share(ctx):
    """Percent of the traced window in which no device operation ran."""
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)


def mfu(ctx):
    """Percent of the window that the useful model FLOPs need at the
    chip's published peaks."""
    if not ctx.flops or ctx.window_s <= 0:
        return None
    t = cost.min_time_s(ctx.flops["bf16"], ctx.flops["f32"])
    return 100.0 * t / ctx.window_s if t > 0 else None


def roofline(ctx, pattern: str, counter: str, bound_s: float):
    """Percent of a launch's bound over its mean device time: the
    device time of the kernels matching ``pattern`` in the traced
    window, over the launches the port's counter ``counter`` took
    there."""
    if ctx.trace is None:
        return None
    seconds, _ = ctx.trace.kernel_time(pattern)
    launches = ctx.counters.get(counter, 0)
    if seconds <= 0 or launches == 0:
        return None
    return 100.0 * bound_s * launches / seconds
