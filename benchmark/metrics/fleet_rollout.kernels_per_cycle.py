"""Kernels the device ran per cycle of the XLA fleet rollout in the traced
stretch (the profiler's kernel events over the cycles the program counted
there, ``scan_program.cycles``).  None when the program counts no
cycles."""


def read(record):
    cycles = record.get("program_cycles")
    if not cycles:
        return None
    return record["trace"]["n_kernels"] / cycles
