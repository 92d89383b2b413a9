"""Median host time of the facade per ``plan()`` call: the planner's own
clock of the call (``planning_times``) less its level program's call
(``stage_timers['device_cycle']``): the host grid, argument building and
the winner's trajectory pair."""

import statistics


def read(record):
    values = record.get("host_ms")
    return statistics.median(values) if values else None
