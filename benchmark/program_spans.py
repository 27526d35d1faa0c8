"""The program's own spans and counters in a traced window, for the
per-layer metrics that read them and for naming the device's idle gaps.

The port records its spans and counters (``graph_pde_tpu_torch.utils.
tracing``) while torch.profiler runs, so the traced window's recording
is the one ``tracing.profiled()`` returns once the window has closed.
Where the program has no such module, or the run was not traced, every
reader returns None.
"""
from __future__ import annotations

import bisect

from . import trace


def recording(ctx):
    """The program's recording of the traced window, or None."""
    if ctx.trace is None or not ctx.work:
        return None
    try:
        from graph_pde_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing.profiled()


def span_ms(ctx, *names: str):
    """Milliseconds a step or request inside the program's spans called
    any of ``names``; None where none closed in the window."""
    rec = recording(ctx)
    if rec is None:
        return None
    ns = [t1 - t0 for n, _, t0, t1 in rec.spans
          if n in names and t1 is not None]
    return 1e-6 * sum(ns) / ctx.work if ns else None


def counter(ctx, name: str, unit: float = 1.0):
    """The program's counter ``name`` a step or request, in ``unit``s
    (0 where the program recorded spans but never counted it)."""
    rec = recording(ctx)
    if rec is None or not rec.spans:
        return None
    return rec.counters.get(name, 0) / unit / ctx.work


def gap_names(bench_spans, rec, times: list) -> list:
    """What the host was doing at each of ``times`` (ns): the
    benchmark's span there (one call into the program), then the
    program's spans open there below its outermost one, which is that
    call itself, e.g. ``request/split/split.connect``; "between calls"
    outside the benchmark's spans. One sweep over the spans' ends."""
    bench = sorted(bench_spans)
    starts = [h[0] for h in bench]
    marks = [(t, 1, k) for k, t in enumerate(times)]
    for i, (_, _, t0, t1) in enumerate(rec.spans if rec is not None
                                       else ()):
        marks.append((t0, 0, i))
        marks.append((t1 if t1 is not None else float("inf"), 2, i))
    marks.sort()
    names, stack = [None] * len(times), []
    for t, kind, i in marks:
        if kind == 0:
            stack.append(i)
        elif kind == 2:
            stack.remove(i)
        else:
            j = bisect.bisect_right(starts, t) - 1
            if j < 0 or t > bench[j][1]:
                names[i] = "between calls"
                continue
            inner = [rec.spans[k][0] for k in stack]
            names[i] = "/".join([bench[j][2]] + (inner[1:] if len(inner) > 1
                                                 else inner))
    return names


def device_intervals(prof) -> list:
    """(start ns, end ns) of every device operation in a profiled
    window, sorted, as ``trace.read`` reads them."""
    from torch.autograd import DeviceType

    dev = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            start = trace._ns(e, "start")
            dev.append((start, start + int(e.duration_ns())))
    return sorted(dev)


def named_gaps(prof, bench_spans, rec, offset_ns: int = 0) -> list:
    """Every idle gap of the device in a profiled window, longest first:
    [[name, seconds], ...], each named by ``gap_names`` at its middle.
    The gaps are those ``trace.read`` finds; ``offset_ns`` is added to
    the device's times first (the profiler's clock error of the
    session, measured as the window opened)."""
    gaps, end = [], None
    for s, t in device_intervals(prof):
        if end is not None and s > end:
            gaps.append((s - end, end, s))
        end = t if end is None else max(end, t)
    gaps.sort(reverse=True)
    names = gap_names(bench_spans, rec, [(g0 + g1) // 2 + offset_ns
                                         for _, g0, g1 in gaps])
    return [[n, length * 1e-9] for n, (length, _, _) in zip(names, gaps)]
