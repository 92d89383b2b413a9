"""Median staging time of a scan program's call in the traced stretch: the
span ``scan_program.stage`` (the carry's load into the static buffers and
the XLA rollout's scene copy), one request per call, in ms.  None when no
such span was recorded."""

import statistics

from commonroad_rp_tpu_torch.utils import profiling


def read(record):
    per_request = getattr(profiling, "per_request", None)
    values = per_request("scan_program.stage") if per_request else None
    return 1e3 * statistics.median(values) if values else None
