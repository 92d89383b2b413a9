"""Reduction of a ``torch.profiler`` trace of a stretch of the window.

The trace is exported as Chrome trace JSON and read back: device intervals
are the events of the categories ``kernel``, ``gpu_memcpy`` and
``gpu_memset``; host activity is every ``cpu_op``, ``user_annotation`` and
``cuda_runtime`` event.  ``busy_s`` is the union of the device intervals,
so overlapping operations count once.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime")
# idle gaps shorter than this (between the nodes of a graph replay) are
# summed under one label instead of being attributed one by one
SHORT_GAP_S = 2e-6
# the breakdown keeps this much of a (demangled C++) kernel name
NAME_CHARS = 160


def union_seconds(intervals) -> float:
    """Length of the union of (start, end) intervals (any unit, seconds
    when given seconds)."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def gaps(intervals, lo, hi):
    """The idle (start, end) gaps between the union of ``intervals`` inside
    [lo, hi]."""
    out, cursor = [], lo
    for a, b in sorted(intervals):
        if a > cursor:
            out.append((cursor, min(a, hi)))
        cursor = max(cursor, b)
        if cursor >= hi:
            break
    if cursor < hi:
        out.append((cursor, hi))
    return [(a, b) for a, b in out if b > a]


def read(path: str) -> dict:
    """{'device': [(name, start_s, end_s, category)], 'host': [(name,
    start_s, end_s)]} from an exported Chrome trace."""
    with open(path) as fh:
        events = json.load(fh).get("traceEvents", [])
    device, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        start = float(e["ts"]) * 1e-6
        row = (e.get("name", "?"), start, start + float(e["dur"]) * 1e-6)
        if e.get("cat") in DEVICE_CATS:
            device.append(row + (e.get("cat"),))
        elif e.get("cat") in HOST_CATS:
            host.append(row)
    return dict(device=device, host=host)


def reduce(trace: dict) -> dict:
    """busy_s, the device's span, and the breakdown: the ten device
    operations that took most time, and the ten longest idle stretches by
    what the host was doing (the innermost host event open at the start of
    each idle gap)."""
    device = trace["device"]
    intervals = [(a, b) for _, a, b, _ in device]
    busy = union_seconds(intervals)
    per_op = collections.Counter()
    for name, a, b, _ in device:
        per_op[name] += b - a
    host = sorted(trace["host"], key=lambda e: e[1])
    if host or intervals:
        lo = min([a for _, a, _ in host] + [a for a, _ in intervals])
        hi = max([b for _, _, b in host] + [b for _, b in intervals])
    else:
        lo = hi = 0.0
    idle = collections.Counter()
    starts = [e[1] for e in host]
    for a, b in gaps(intervals, lo, hi):
        if b - a < SHORT_GAP_S:
            idle[f"gaps under {SHORT_GAP_S * 1e6:g} us"] += b - a
            continue
        i = bisect.bisect_right(starts, a)
        label = "host idle"
        best = None
        for name, h0, h1 in host[max(0, i - 64):i]:
            if h0 <= a < h1 and (best is None or h0 >= best):
                best, label = h0, name
        idle[label] += b - a
    return dict(busy_s=busy, span_s=hi - lo,
                device_ops=[[n[:NAME_CHARS], s]
                            for n, s in per_op.most_common(10)],
                idle_gaps=[[n[:NAME_CHARS], s]
                           for n, s in idle.most_common(10)],
                per_op=dict(per_op),
                n_kernels=sum(1 for e in device if e[3] == "kernel"))


def profile(run_stretch):
    """Run ``run_stretch()`` under ``torch.profiler`` (CPU and CUDA) and
    return its reduced trace; the Chrome trace goes to a file of its own
    under the temporary directory (``TMPDIR``) and is deleted."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with torch_profile(activities=activities) as prof:
        run_stretch()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    try:
        return reduce(read(path))
    finally:
        os.remove(path)
