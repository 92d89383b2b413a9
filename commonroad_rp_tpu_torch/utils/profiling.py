"""Tracing / profiling utilities.

The reference instruments wall-clock per planning stage and keeps a
per-cycle latency list (reference: reactive_planner.py:577, :659-660,
:1083-1132; exposed via the planning_times property :147-150).  This module
adds a stage-timer registry and a context manager around ``torch.profiler``
for device traces.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List


class StageTimers:
    """Named wall-clock stage timers with per-cycle history."""

    def __init__(self):
        self._history: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            self._history[name].append(time.time() - t0)

    def record(self, name: str, seconds: float):
        self._history[name].append(seconds)

    @property
    def history(self) -> Dict[str, List[float]]:
        return dict(self._history)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, values in self._history.items():
            ordered = sorted(values)
            n = len(ordered)
            out[name] = {
                "count": n,
                "mean_ms": 1e3 * sum(ordered) / n,
                "p50_ms": 1e3 * ordered[n // 2],
                "max_ms": 1e3 * ordered[-1],
            }
        return out


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
