"""The fleet scorer's share of its roofline per cycle of the fused fleet
scan: the least time the card needs for the scoring work of the traced
cycles (``work/``, counted from the reference at the cycles' inputs) over
the device time of the kernels named below, in %.  None when no such
kernel ran."""

import re

from benchlib.core import load_module

KERNELS = re.compile(r"fleet_score_kernel\b")


def read(record):
    work = load_module("work", "planning")
    seconds = sum(t for name, t in record["trace"]["per_op"].items()
                  if KERNELS.search(name))
    if not seconds or "scoring_work" not in record:
        return None
    bound, _ = work.bound_s(*record["scoring_work"])
    return 100.0 * bound / seconds
