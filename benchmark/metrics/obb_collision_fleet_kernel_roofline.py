"""The fleet form of the OBB collision kernel's share of its roofline: the
least time the card needs for the collision work of the traced cycles
(``work/collision.py``, counted from the reference at the cycles' inputs)
over the device time of the kernels named below, in %.  None when no such
kernel ran."""

import re

from benchlib.core import load_module

KERNELS = re.compile(r"obb_collision_fleet_kernel\b")


def read(record):
    seconds = sum(t for name, t in record["trace"]["per_op"].items()
                  if KERNELS.search(name))
    if not seconds or "collision_work" not in record:
        return None
    bound, _ = load_module("work", "planning").bound_s(
        *record["collision_work"])
    return 100.0 * bound / seconds
