"""Device time per replanning cycle in the traced stretch: the union of
device intervals over the cycles the stretch held, in ms."""


def read(record):
    cycles = record.get("cycles")
    if not cycles:
        return None
    return 1e3 * record["trace"]["busy_s"] / cycles
