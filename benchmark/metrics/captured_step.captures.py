"""CUDA graph captures over the whole run, set-up and window (the
program's counter ``captured_step.captures``).  None when the program
counted none."""

from commonroad_rp_tpu_torch.utils import profiling


def read(record):
    counters = getattr(profiling, "counters", None)
    return counters().get("captured_step.captures") if counters else None
