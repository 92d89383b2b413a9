"""Kernels the device ran per replanning cycle in the traced stretch (the
profiler's kernel events over the cycles): a count that fusing kernels
lowers."""


def read(record):
    cycles = record.get("cycles")
    if not cycles:
        return None
    return record["trace"]["n_kernels"] / cycles
