"""Median staging time of the level program per ``plan()`` call: the span
``level_program.stage`` (host fill of the staged row, its host-to-device
copy, the copy of the scene into the static buffers) summed per request,
one request per ``plan()`` call of the traced stretch, in ms.  None when
no such span was recorded."""

import statistics

from commonroad_rp_tpu_torch.utils import profiling


def read(record):
    per_request = getattr(profiling, "per_request", None)
    values = per_request("level_program.stage") if per_request else None
    return 1e3 * statistics.median(values) if values else None
