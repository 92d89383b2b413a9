"""Operations and bytes of the planning cycle's work, counted from the
benchmark's plain reference (``reference/planner.py``), never from the
program's kernels or operand layout.

Operations are floating-point arithmetic and transcendental functions, one
each, per candidate and step; comparisons, selects and index searches are
not counted.  Bytes are the problem's inputs read once and its outputs
written once, in float32 (4 bytes): each candidate's terminal sample (time,
target speed, lateral target) and its two costs, the start state, the path
table (arclength, heading, curvature and its derivative, the vertex, its
tangent and normal, the two corridor bands: 12 values a vertex), and the
obstacle rows over the horizon (pose and validity, 4 values a step; half
extents and radius, 3 a row).
"""

BYTES = 4

# per candidate and step, by stage of reference/planner.evaluate
STAGE_OPS = {
    "polynomials": 2 * 36 + 1,      # p, v, a of the lon and lat polynomials
    "path_lookup": 24,              # interpolation fraction, heading, curvature
    #                                 and its rate, the Cartesian point
    "werling": 9 + 33,              # d', d'', headings; curvature, v, a
    "kinematic_checks": 20,         # yaw rate, curvature rate, acceleration
    "cost": 16,                     # acceleration, speed, offset, heading terms
    "corridor": 22,                 # ego box extents, three stations
    "ego_box": 6,                   # box centre and heading for the SAT
}
STEP_OPS = sum(STAGE_OPS.values())
# per candidate, step and obstacle occupying that step: the separating-axis
# test of two boxes (or box and disc)
OBSTACLE_STEP_OPS = 45
START_VALUES = 9                    # s, s', s'', d, d', d'', heading, v, step
TABLE_VALUES = 12
OBSTACLE_STEP_VALUES = 4
OBSTACLE_ROW_VALUES = 3


def scoring(K: int, T: int, P: int, M: int, occupied_steps: int):
    """(operations, bytes) of scoring ``K`` candidates over ``T`` steps
    against a path of ``P`` vertices and ``M`` obstacle rows, of which
    ``occupied_steps`` (obstacle, step) pairs are occupied in the window."""
    ops = K * T * STEP_OPS + K * occupied_steps * OBSTACLE_STEP_OPS
    values = (3 * K + 2 * K + START_VALUES + TABLE_VALUES * P
              + OBSTACLE_STEP_VALUES * M * T + OBSTACLE_ROW_VALUES * M)
    return ops, values * BYTES


# the card's published peaks (NVIDIA H100 SXM data sheet, 700 W)
PEAK_FLOPS_F32 = 67e12
PEAK_BYTES_S = 3.35e12


def bound_s(ops: float, nbytes: float):
    """(least seconds, 'operations' or 'bytes'): the roofline bound."""
    t_ops, t_bytes = ops / PEAK_FLOPS_F32, nbytes / PEAK_BYTES_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
