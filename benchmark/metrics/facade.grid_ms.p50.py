"""Median host grid time per ``plan()`` call: the span
``planner.grid_generation`` (the candidate grid of the fused levels)
summed per request, one request per ``plan()`` call of the traced
stretch, in ms.  None when no such span was recorded."""

import statistics

from commonroad_rp_tpu_torch.utils import profiling


def read(record):
    per_request = getattr(profiling, "per_request", None)
    values = per_request("planner.grid_generation") if per_request else None
    return 1e3 * statistics.median(values) if values else None
