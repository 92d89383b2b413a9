"""The device's idle share over the traced stretch of XLA fleet rollout
calls: 1 - (union of device intervals / the stretch's wall time), in %."""


def read(record):
    trace = record["trace"]
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
