"""The traced window: torch.profiler over the device's activity (CUPTI:
kernels, copies, sets), read from its raw events.

``Trace`` holds what the per-layer metrics read: the device time and
count of each device operation by name, the device's busy seconds (the
union of its operations' intervals), the traced window's length, and
the longest idle gaps of the device, each named by what the host was
doing then: the benchmark's own span (one call into the program) that
covers the gap's middle, or "between calls". Host operators are not
recorded: their profiling slowed the general MGKN's step from 33 to 87
ms on the H100, which would distort every per-layer reading of a
host-bound cell; the spans are the benchmark's, stamped with the same
wall clock (ns since the epoch) as the profiler's events.
"""
from __future__ import annotations

import dataclasses
import re
import time

import torch

NAME_CHARS = 160   # of a device op's name in the breakdown


def _ns(e, what: str) -> int:
    f = getattr(e, f"{what}_ns", None)
    return int(f()) if f is not None else int(getattr(e, f"{what}_us")() * 1e3)


@dataclasses.dataclass
class Trace:
    ops: dict            # device op name -> [seconds, count]
    busy_s: float
    window_s: float
    gaps: list           # [[host activity, seconds], ...], longest first

    def kernel_time(self, pattern: str) -> tuple:
        """(seconds, launches) of the device ops whose names match the
        regular expression ``pattern``."""
        rx = re.compile(pattern)
        hits = [v for k, v in self.ops.items() if rx.search(k)]
        return sum(h[0] for h in hits), sum(h[1] for h in hits)

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(([k[:NAME_CHARS], v[0]] for k, v in self.ops.items()),
                     key=lambda kv: -kv[1])
        return {"device_ops": ops[:top], "idle_gaps": self.gaps[:top]}



class Spans(list):
    """The benchmark's calls into the program: (start ns, end ns, name),
    by the wall clock the profiler stamps its events with."""

    def call(self, name: str, fn, *args):
        t0 = time.time_ns()
        out = fn(*args)
        self.append((t0, time.time_ns(), name))
        return out

    def seconds(self, name: str) -> list:
        return [(b - a) * 1e-9 for a, b, n in self if n == name]


class Tracer:
    """Context manager around the window; ``trace`` after exit."""

    def __init__(self, sync, spans: Spans):
        self.sync, self.spans = sync, spans
        self.trace = None

    def __enter__(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts = [torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.sync()
        window = time.perf_counter() - self.t0
        self.prof.__exit__(*exc)
        if exc[0] is None:
            t0 = time.perf_counter()
            self.trace = read(self.prof, window, self.spans)
            self.read_s = time.perf_counter() - t0 + (t0 - self.t0 - window)
        return False


def read(prof, window_s: float, spans) -> Trace:
    from torch.autograd import DeviceType

    dev, ops = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        start, dur = _ns(e, "start"), int(e.duration_ns())
        dev.append((start, start + dur))
        rec = ops.setdefault(e.name(), [0.0, 0])
        rec[0] += dur * 1e-9
        rec[1] += 1
    dev.sort()
    busy, gaps, end = 0, [], None
    for s, t in dev:
        if end is None or s > end:
            if end is not None:
                gaps.append((s - end, end, s))
            busy += t - s
            end = t
        elif t > end:
            busy += t - end
            end = t
    gaps.sort(reverse=True)
    named = []
    for length, g0, g1 in gaps[:10]:
        mid = (g0 + g1) // 2
        cover = [h for h in spans if h[0] <= mid <= h[1]]
        what = cover[0][2] if cover else "between calls"
        named.append([what, length * 1e-9])
    return Trace(ops=ops, busy_s=busy * 1e-9, window_s=window_s, gaps=named)
