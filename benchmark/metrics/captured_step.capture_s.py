"""Host wall time of the CUDA graph captures over the whole run, each
capture's warm-up step and capture (the program's counter
``captured_step.capture_ns``), in s.  None when the program counted none."""

from commonroad_rp_tpu_torch.utils import profiling


def read(record):
    counters = getattr(profiling, "counters", None)
    ns = counters().get("captured_step.capture_ns") if counters else None
    return None if ns is None else ns * 1e-9
