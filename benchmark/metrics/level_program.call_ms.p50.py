"""Median time of the level program's call per ``plan()``
(``stage_timers['device_cycle']``): staging, the graph's replay and the
readback."""

import statistics


def read(record):
    values = record.get("level_ms")
    return statistics.median(values) if values else None
