"""Device time per cycle of the XLA fleet rollout in the traced stretch:
the union of device intervals over the cycles the program counted there
(its counter ``scan_program.cycles``), in ms.  None when the program
counts no cycles."""


def read(record):
    cycles = record.get("program_cycles")
    if not cycles:
        return None
    return 1e3 * record["trace"]["busy_s"] / cycles
