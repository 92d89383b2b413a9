"""Operations and bytes of the fleet collision pass (the fleet form of the
OBB collision kernel), counted from the benchmark's plain reference
(``reference/planner.py``, the obstacle loop of ``evaluate``), never from
the program's kernel or operand layout.

Per candidate and step the ego box's centre (the ``ego_box`` stage of
``work/planning.py``); per candidate, step and obstacle row occupying that
step the separating-axis test of two boxes (or box and disc,
``OBSTACLE_STEP_OPS``).  Bytes, in float32 (4 bytes): the candidates' ego
poses (x, y, heading each step) and the obstacle rows over the horizon
(pose and validity each step; half extents and radius) read once, the
[K] collision mask written once (1 byte a candidate).
"""

import numpy as np

from benchlib.core import load_module

EGO_STEP_VALUES = 3
MASK_BYTES = 1


def collision(K: int, T: int, M: int, occupied_steps: int):
    """(operations, bytes) of checking ``K`` candidates over ``T`` steps
    against ``M`` obstacle rows, of which ``occupied_steps`` (obstacle,
    step) pairs are occupied in the window."""
    planning = load_module("work", "planning")
    ops = K * T * planning.STAGE_OPS["ego_box"] + \
        K * occupied_steps * planning.OBSTACLE_STEP_OPS
    values = (EGO_STEP_VALUES * K * T
              + planning.OBSTACLE_STEP_VALUES * M * T
              + planning.OBSTACLE_ROW_VALUES * M)
    return ops, values * planning.BYTES + MASK_BYTES * K


def of_cycles(bases, members, K: int, T: int, cycles, span: int):
    """(operations, bytes) of the collision pass over every member's
    candidates over ``cycles`` (each member at scenario step = cycle), at
    the reference's own obstacles of each base (``benchlib/fleet.py``'s
    ``Base``)."""
    from reference.scene import obstacles

    valid = {b: obstacles(base.scn, span).valid for b, base in
             enumerate(bases)}
    count = np.bincount([b for b, *_ in members], minlength=len(bases))
    ops = nbytes = 0
    for c in cycles:
        for b, n in enumerate(count):
            if not n:
                continue
            o, y = collision(K, T, len(valid[b]),
                             int(valid[b][:, c:c + T].sum()))
            ops, nbytes = ops + n * o, nbytes + n * y
    return ops, nbytes
