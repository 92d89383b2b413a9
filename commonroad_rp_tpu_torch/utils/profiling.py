"""Tracing / profiling utilities: spans, counters, stage timers and a device
trace.

The reference instruments wall-clock per planning stage and keeps a
per-cycle latency list (reference: reactive_planner.py:577, :659-660,
:1083-1132; exposed via the planning_times property :147-150).  This module
is the port's one tracer:

* ``with span(name):`` records a span (name, start and end on
  ``time.perf_counter_ns``, the index of the enclosing open span, a request
  id) while a ``torch.profiler`` records, and is then also a
  ``record_function`` of that name, so that it lands in the profiler's
  Chrome trace as a ``user_annotation`` event beside the device intervals.
  With no profiler recording a span costs one attribute read.  A span
  opened with no span open starts a new request; every span inside it
  shares that request's id.  The last ``MAX_SPANS`` spans are kept, in
  memory, for one thread.
* ``count(name, n)`` adds to a counter, always (it is called on cold paths
  only); ``counters()`` reads them.
* :class:`StageTimers` keeps the planner's per-stage history of wall
  times; each stage is also the span ``planner.<stage>``.
* :func:`device_trace` runs a block under ``torch.profiler``.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict, deque
from typing import Dict, List, NamedTuple

import torch.autograd.profiler as _autograd_profiler

MAX_SPANS = 1 << 20


class Span(NamedTuple):
    """A closed span: ``index`` in opening order, ``parent`` the index of
    the span open around it (-1 for a request's root), times in ns."""
    index: int
    name: str
    start_ns: int
    end_ns: int
    parent: int
    request: int


_spans: deque = deque(maxlen=MAX_SPANS)
_stack: List[tuple] = []          # (index, request) of the open spans
_next = [0, 0]                    # next span index, next request id
_counters: Dict[str, int] = {}


class span:
    """``with span(name):`` -- a span while a ``torch.profiler`` records,
    nothing otherwise (see the module docstring)."""

    __slots__ = ("name", "start", "_index", "_function")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        # read at call time: the profiler sets the module attribute
        if _autograd_profiler._is_profiler_enabled:
            self._open()
        else:
            self._index = None
        return self

    def __exit__(self, *exc):
        if self._index is not None:
            self._close(time.perf_counter_ns())
        return False

    def _open(self):
        index = _next[0]
        _next[0] += 1
        if _stack:
            request = _stack[-1][1]
        else:
            request = _next[1]
            _next[1] += 1
        _stack.append((index, request))
        self._index = index
        self._function = _autograd_profiler.record_function(self.name)
        self._function.__enter__()
        self.start = time.perf_counter_ns()

    def _close(self, end: int):
        self._function.__exit__(None, None, None)
        index, request = _stack.pop()
        parent = _stack[-1][0] if _stack else -1
        _spans.append(Span(index, self.name, self.start, end, parent,
                           request))


class _Stage(span):
    """A stage of :class:`StageTimers`: always timed, its wall appended to
    the history; a span as well while a profiler records (the same
    interval)."""

    __slots__ = ("_history", "_key")

    def __init__(self, name: str, history: dict, key: str):
        self.name = name
        self._history = history
        self._key = key

    def __enter__(self):
        if _autograd_profiler._is_profiler_enabled:
            self._open()
        else:
            self._index = None
            self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self._index is not None:
            self._close(end)
        self._history[self._key].append((end - self.start) * 1e-9)
        return False


def spans() -> List[Span]:
    """The kept spans in opening order."""
    return sorted(_spans)


def per_request(name: str) -> List[float]:
    """Seconds of the spans called ``name`` summed per request, one value
    for each request that holds such a span, in request order."""
    sums: Dict[int, int] = {}
    for s in _spans:
        if s.name == name:
            sums[s.request] = sums.get(s.request, 0) + s.end_ns - s.start_ns
    return [sums[r] * 1e-9 for r in sorted(sums)]


def count(name: str, n: int = 1):
    """Add ``n`` to the counter ``name``."""
    _counters[name] = _counters.get(name, 0) + n


def counters() -> Dict[str, int]:
    return dict(_counters)


def reset():
    """Forget every kept span and counter."""
    _spans.clear()
    _counters.clear()


class StageTimers:
    """Named wall-clock stage timers with per-cycle history (seconds, on
    ``time.perf_counter``); ``stage(name)`` is also the span
    ``planner.<name>``."""

    def __init__(self):
        self._history: Dict[str, List[float]] = defaultdict(list)

    def stage(self, name: str) -> _Stage:
        return _Stage("planner." + name, self._history, name)

    @property
    def history(self) -> Dict[str, List[float]]:
        return dict(self._history)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """``torch.profiler`` trace (CPU and, when a card is present, CUDA
    activities) around a code block; the Chrome trace is written to
    ``log_dir/trace.json``.  Yields the profiler, whose ``key_averages()``
    give per-kernel device time."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
