"""Hostile operands for the fleet scorer, made from a seed with numpy.

``hostile_fleet(seed)`` returns the arguments of ``ops.scoring.score_fleet``
(and of the JAX package's ``pallas_cycle.score_fleet_pallas``, whose layout it
shares) as float32 numpy arrays: three problems whose reference tables have
different real lengths under one padded length, and per problem eight groups
of candidates aimed at the table search and the early exits of
``csrc/scoring.cu``:

  normal       in-domain candidates with full and short horizons (the
               constant-acceleration extension);
  still        ``s`` that stands still, creeps forward or creeps backward by
               less than the zeroing threshold of ``s_dot``;
  below_zero   starts below ``s = 0`` or just above it (the corridor probes
               clamp at the low end);
  past_end     runs past the last real row into the sentinel rows (probes
               clamp at the high end), some far enough to land among the
               padded rows;
  nan          one NaN coefficient, longitudinal or lateral;
  then_prefilter  a curvature violation at the first step, and the
               longitudinal prefilter (acceleration or reverse speed) tripping
               steps later;
  then_leaves  the same violation, then ``s`` leaves the domain or the lateral
               offset overflows to inf/NaN;
  short        horizons of one and two valid steps.

The CPU tests feed the same arrays to the JAX scorer and to the port's plain
version; ``chip_smoke.py`` and ``tests/test_torch_gpu.py`` feed them to the
CUDA kernel and the plain version on the card.
"""

from __future__ import annotations

import numpy as np

GROUPS = ("normal", "still", "below_zero", "past_end", "nan",
          "then_prefilter", "then_leaves", "short")
PER_GROUP = 48
N_STEPS, DT = 20, 0.1
# real table rows per problem (1 m apart); all are padded to the largest
REAL_ROWS = (40, 97, 160)


def _packed_table(n_rows: int, n_padded: int, curvature: float) -> np.ndarray:
    """[n_padded + 1, 12] packed table (``ops.scoring.pack_ref_tables``
    columns) of a constant-curvature path: ``n_rows`` real rows, then copies
    of the last row with arclengths stepping by 1e6, then the successor
    sentinel 1e7 further."""
    s = np.arange(n_rows, dtype=np.float64)
    theta = curvature * s
    px = np.sin(theta) / curvature
    py = (1.0 - np.cos(theta)) / curvature
    rows = np.stack([
        s, theta, np.full(n_rows, curvature), np.zeros(n_rows),
        -3.5 - 0.5 * np.cos(0.3 * s), 3.5 + 0.5 * np.sin(0.2 * s),
        px, py, np.cos(theta), np.sin(theta), -np.sin(theta), np.cos(theta)],
        axis=1)
    pad = np.repeat(rows[-1:], n_padded - n_rows + 1, axis=0)
    pad[:, 0] += 1e6 * np.arange(1, len(pad) + 1)
    pad[-1, 0] += 1e7
    return np.concatenate([rows, pad]).astype(np.float32)


def _candidates(rng, length: float, a_max: float):
    """(coeffs_lon, coeffs_lat, traj_len) of one problem, group by group."""
    T = N_STEPS + 1
    n = PER_GROUP
    cl = np.zeros((len(GROUPS), n, 6))
    ca = np.zeros((len(GROUPS), n, 6))
    tl = np.full((len(GROUPS), n), float(T))
    # every group starts from in-domain candidates at constant speed
    cl[:, :, 0] = rng.uniform(5.0, 0.5 * length, cl.shape[:2])
    cl[:, :, 1] = rng.uniform(3.0, 9.0, cl.shape[:2])
    ca[:, :, 0] = rng.uniform(-1.0, 1.0, ca.shape[:2])
    g = {name: i for i, name in enumerate(GROUPS)}

    tl[g["normal"]] = rng.choice([5.0, 11.0, 16.0, float(T)], n)
    cl[g["normal"], :, 2] = rng.uniform(-0.5, 0.5, n)
    ca[g["normal"], :, 2] = rng.uniform(-0.05, 0.05, n)

    cl[g["still"], :, 1] = rng.choice([0.0, 5e-6, -5e-6, 2e-3, 0.5], n)
    tl[g["still"]] = rng.choice([7.0, float(T)], n)

    cl[g["below_zero"], :, 0] = rng.uniform(-3.0, 1.5, n)
    cl[g["below_zero"], :, 1] = rng.uniform(1.0, 5.0, n)

    cl[g["past_end"], :, 0] = rng.uniform(length - 8.0, length + 2.0, n)
    cl[g["past_end"], :, 1] = rng.uniform(2.0, 12.0, n)
    cl[g["past_end"], ::6, 1] = rng.uniform(3e5, 3e6, len(range(0, n, 6)))
    tl[g["past_end"]] = rng.choice([9.0, float(T)], n)

    which = rng.integers(0, 12, n)
    for k in range(n):
        (cl if which[k] < 6 else ca)[g["nan"], k, which[k] % 6] = np.nan
    tl[g["nan"]] = rng.choice([6.0, float(T)], n)

    # lateral acceleration 2 * c2 at 3-4 m/s: curvature far above kappa_max
    # at the first step
    for name in ("then_prefilter", "then_leaves"):
        cl[g[name], :, 1] = rng.uniform(3.0, 4.0, n)
        ca[g[name], :, 2] = rng.choice([-1.0, 1.0], n) * rng.uniform(6, 9, n)
    # s_ddot = 6 * c3 * t passes a_max near t = 1 s, or s_dot turns negative
    jerk = g["then_prefilter"]
    cl[jerk, ::2, 3] = rng.uniform(1.2, 2.0, n // 2) * a_max / 6.0
    cl[jerk, 1::2, 2] = -rng.uniform(1.6, 3.0, n // 2)
    leave = g["then_leaves"]
    cl[leave, ::2, 0] = rng.uniform(length - 4.0, length - 1.0, n // 2)
    cl[leave, ::2, 1] = rng.uniform(6.0, 12.0, n // 2)
    ca[leave, 1::2, 5] = rng.choice([1e30, -1e30, 3e38], n // 2)

    tl[g["short"]] = rng.choice([1.0, 2.0], n)
    return (cl.reshape(-1, 6).astype(np.float32),
            ca.reshape(-1, 6).astype(np.float32),
            tl.reshape(-1).astype(np.float32))


def hostile_fleet(seed: int = 0) -> dict:
    """The arguments of ``score_fleet`` by name (float32 numpy arrays; ``dt``
    a float, ``n_steps`` an int) plus ``group`` [K], each candidate's index
    into ``GROUPS``."""
    rng = np.random.default_rng(seed)
    F, T = len(REAL_ROWS), N_STEPS + 1
    f32 = np.float32
    packed = np.stack([_packed_table(n, max(REAL_ROWS), c) for n, c in
                       zip(REAL_ROWS, (0.01, -0.004, 0.006))])
    ref_s_last = np.array([n - 1.0 for n in REAL_ROWS], f32)
    veh = np.array([[2.578, 1.422, 11.5, 7.319, 0.7, 0.4, 2.25, 0.9]], f32) \
        * np.array([[1.0], [0.9], [1.1]], f32)
    parts = [_candidates(rng, float(ref_s_last[f]), float(veh[f, 2]))
             for f in range(F)]
    cl, ca, tl = (np.stack(x) for x in zip(*parts))
    K = cl.shape[1]

    # a box parked on the path, a disc moving along it, a row that is never
    # valid; the box is turned against the path
    steps = np.arange(T)
    pose = np.zeros((F, 3, T, 3), f32)
    half = np.zeros((F, 3, 2), f32)
    valid = np.zeros((F, 3, T), f32)
    radius = np.zeros((F, 3), f32)
    for f in range(F):
        mid = packed[f, int(0.45 * REAL_ROWS[f])]
        pose[f, 0, :, 0] = mid[6] + 1.5 * mid[10]
        pose[f, 0, :, 1] = mid[7] + 1.5 * mid[11]
        pose[f, 0, :, 2] = mid[1] + 0.4
        half[f, 0] = (2.4, 1.0)
        valid[f, 0] = 1.0
        start = packed[f, int(0.2 * REAL_ROWS[f])]
        pose[f, 1, :, 0] = start[6] + 0.6 * steps * start[8]
        pose[f, 1, :, 1] = start[7] + 0.6 * steps * start[9]
        radius[f, 1] = 1.1
        valid[f, 1, 3:] = 1.0
        pose[f, 2] = pose[f, 0]
        half[f, 2] = (5.0, 5.0)
    return dict(
        coeffs_lon=cl, coeffs_lat=ca, traj_len=tl,
        goal_valid=(rng.uniform(size=(F, K)) > 0.1).astype(f32),
        packed_tables=packed, obs_pose=pose, obs_half_ext=half,
        obs_valid=valid, veh_stack=veh,
        x0_orientation=np.array([0.1, -0.05, 0.08], f32), dt=DT,
        low_vel=np.array([0.0, 1.0, 0.0], f32),
        desired_speed=np.array([6.0, 3.0, 8.0], f32),
        desired_d=np.zeros(F, f32), w_a=np.full(F, 5.0, f32),
        ref_s_last=ref_s_last, obs_radius=radius, n_steps=N_STEPS,
        group=np.tile(np.repeat(np.arange(len(GROUPS)), PER_GROUP), (F, 1)))


ARGUMENT_ORDER = ("coeffs_lon", "coeffs_lat", "traj_len", "goal_valid",
                  "packed_tables", "obs_pose", "obs_half_ext", "obs_valid",
                  "veh_stack", "x0_orientation", "dt", "low_vel",
                  "desired_speed", "desired_d", "w_a", "ref_s_last")


def score_fleet_arguments(case: dict, convert):
    """(args, kwargs) of ``score_fleet`` / ``score_fleet_reference`` from a
    :func:`hostile_fleet` case, every array through ``convert``."""
    args = tuple(case[name] if name == "dt" else convert(case[name])
                 for name in ARGUMENT_ORDER)
    return args, dict(obs_radius=convert(case["obs_radius"]),
                      n_steps=case["n_steps"])
