"""Spans and counters of graph_pde_tpu_torch: where the host spends a
request or a training step, and what it moves.

    with tracing.span("split"):        # a fixed name, never formatted
        ...
    tracing.count("readbacks")         # adds 1; count(name, n) adds n

Nothing is recorded unless a recording is open:

- ``recording()`` opens one explicitly and yields it;
- while ``torch.profiler`` runs and no explicit recording is open, the
  spans and counters go to a recording of that profiler session, which
  ``profiled()`` returns afterwards. A profiled window of a caller's
  loop thus reads the program's own spans without any change to the
  caller.

Off, ``span`` returns one shared no-op object and ``count`` returns at
once: no string is formatted and nothing is allocated.

A ``Recording`` holds ``spans``, a list of (name, parent index, start
ns, end ns) in the order they opened (parent None at the top; the end
None while the span is open), and ``counters``, a dict of name -> sum.
Spans are stamped with ``time.time_ns()``, the wall clock torch.profiler
stamps its events with, so a span can be laid over the device's
activity. Parents come from a stack of the spans open on the recording
thread: no span is opened inside an autograd ``backward``, which runs on
autograd's own device thread; the span around ``loss.backward()``
covers it.

With ``profiler_ranges=True`` each span also enters
``torch.profiler.record_function``, so an exported trace shows the
program's spans above the operators and kernels they launched.
"""
from __future__ import annotations

import contextlib
import time

import torch.autograd.profiler as _profiler


class Recording:
    """The spans and counters of one recording."""

    def __init__(self, profiler_ranges: bool = False, session: bool = False):
        self.spans: list = []      # (name, parent, start ns, end ns)
        self.counters: dict = {}
        self.profiler_ranges = profiler_ranges
        self.session = session     # opened by a profiler session
        self._stack: list = []     # indices of the open spans


class _Off:
    """The span of a process that is not recording."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_rec = None      # the open recording, explicit or a profiler session's
_last = None     # the last profiler session's recording, once closed


class _Span:
    __slots__ = ("rec", "name", "index", "range")

    def __init__(self, rec: Recording, name: str):
        self.rec, self.name, self.range = rec, name, None

    def __enter__(self):
        rec = self.rec
        if rec.profiler_ranges:
            self.range = _profiler.record_function(self.name)
            self.range.__enter__()
        stack = rec._stack
        self.index = len(rec.spans)
        rec.spans.append((self.name, stack[-1] if stack else None,
                          time.time_ns(), None))
        stack.append(self.index)
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        rec = self.rec
        name, parent, t0, _ = rec.spans[self.index]
        rec.spans[self.index] = (name, parent, t0, t1)
        rec._stack.pop()
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def _session():
    """The open recording where a profiler session runs without an
    explicit recording (opening one), else None (closing a session
    whose profiler has stopped)."""
    global _rec, _last
    if _profiler._is_profiler_enabled:
        if _rec is None:
            _rec = Recording(session=True)
        return _rec
    if _rec is not None:
        _last, _rec = _rec, None
    return None


def span(name: str):
    """A context manager that records ``name`` from enter to exit."""
    rec = _rec
    if rec is None and not _profiler._is_profiler_enabled:
        return _OFF
    if rec is None or rec.session:
        rec = _session()
        if rec is None:
            return _OFF
    return _Span(rec, name)


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to the counter ``name``."""
    rec = _rec
    if rec is None and not _profiler._is_profiler_enabled:
        return
    if rec is None or rec.session:
        rec = _session()
        if rec is None:
            return
    rec.counters[name] = rec.counters.get(name, 0) + n


@contextlib.contextmanager
def recording(profiler_ranges: bool = False):
    """Records the enclosed block's spans and counters; yields the
    ``Recording``. Recordings do not nest."""
    global _rec
    if _rec is not None and not _rec.session:
        raise RuntimeError("a recording is already open")
    outer, _rec = _rec, Recording(profiler_ranges)
    try:
        yield _rec
    finally:
        _rec = outer


def profiled():
    """The recording of the current or last profiler session, or None."""
    return _rec if _rec is not None and _rec.session else _last


__all__ = ["Recording", "span", "count", "recording", "profiled"]
