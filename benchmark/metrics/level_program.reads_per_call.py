"""Level-program readbacks per ``plan()`` call in the traced stretch: the
spans ``level_program.readback`` inside ``planner.plan`` requests over the
number of those requests (1 a call, 2 where the refinement overflowed and
was continued).  None when no ``planner.plan`` span was recorded."""

from commonroad_rp_tpu_torch.utils import profiling


def read(record):
    spans = getattr(profiling, "spans", None)
    if spans is None:
        return None
    rows = spans()
    plans = {s.request for s in rows if s.name == "planner.plan"}
    if not plans:
        return None
    reads = sum(1 for s in rows
                if s.name == "level_program.readback" and s.request in plans)
    return reads / len(plans)
