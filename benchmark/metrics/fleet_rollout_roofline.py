"""The XLA fleet rollout's share of the roofline of its scoring work: the
least time the card needs for the scoring work of the traced cycles
(``work/planning.py``, counted from the reference at the cycles' inputs,
the yardstick of ``fleet_score_kernel_roofline``) over the whole cycles'
device time (the union of device intervals), in %.  None when nothing ran
on the device."""

from benchlib.core import load_module


def read(record):
    busy = record["trace"]["busy_s"]
    if not busy or "scoring_work" not in record:
        return None
    bound, _ = load_module("work", "planning").bound_s(
        *record["scoring_work"])
    return 100.0 * bound / busy
