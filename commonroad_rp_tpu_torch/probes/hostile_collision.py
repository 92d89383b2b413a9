"""Hostile and near-touching operands for the OBB collision kernels, made
from a seed with numpy.

``hostile_collision(seed, dtype)`` returns the fleet-form operands of
``ops.collision_kernel.obb_collision_fleet`` (problem ``f`` alone is an
operand set of ``obb_collision``) aimed at the staged rows and the
bounding-circle skip of ``csrc/collision.cu``: one problem per ego extent of
``EGO_EXTENTS`` (a car, a point, a sliver, a negative extent, NaN, inf),
eight rows (boxes, discs with and without garbage extents, a point, a
negative extent, a row with NaN, huge and infinite poses, a row at the
origin that is never valid), and candidates placed by ``CASES``:

  shell        centre distance d at (1 + delta)(R_e + R_o) and (1 - delta)
               (R_e + R_o), the skip's reach, and 1 ulp either side, along an
               axis (exact) or a random direction;
  touch        boxes side by side at exactly the sum of their extents (a
               disc at ehl + r), and 1 ulp either side;
  near         uniform within twice the reach;
  bad_pose     NaN or +-inf ego centre or heading;
  huge         centres at 1e19-3e38 and headings at 1e30;
  tiny         subnormal centres and headings.

At step t, row t // 2 sits at the origin (heading 0 at even steps, random
at odd ones) and the candidates aim at it; the other rows wait 1e4 away.

``near_touching_collision(seed, dtype, F, K, T)`` is a scene at the kernels'
working scale: F problems of K candidates over T steps, six moving boxes and
two discs, every candidate-step within a few ulps of touching one row (the
touching distance along a random direction by bisection in float64).

The CPU tests hold the plain versions, and the g++-compiled pair test of
``csrc/collision.cu``, against each other on these arrays; ``chip_smoke.py``
and ``tests/test_torch_gpu.py`` hold the kernels against the plain versions
on the card.
"""

from __future__ import annotations

import numpy as np

# ego half extents (length, width) of the problems of hostile_collision
EGO_EXTENTS = ((2.25, 0.8), (0.0, 0.0), (1e-30, 2.0), (-1.0, 0.9),
               (np.nan, 0.8), (np.inf, 0.8))
# rows: half extents and disc radius (0: a box)
ROWS = (((2.2, 0.9), 0.0), ((1.0, 1.0), 0.0), ((0.0, 0.0), 1.2),
        ((np.nan, 7.0), 0.5), ((0.0, 0.0), 0.0), ((3.0, -0.5), 0.0),
        ((1.5, 0.7), 0.0), ((2.0, 1.0), 0.0))
CASES = ("shell", "touch", "near", "bad_pose", "huge", "tiny")
PER_CASE = 24
SKIP_DELTA = 2.0 ** -8        # csrc/collision.cu, Skip::kScale - 1


def _ulp_steps(x, dtype, n):
    """x moved n ulps (n < 0: down) in ``dtype``, elementwise."""
    x = np.asarray(x, dtype)
    n = np.broadcast_to(n, x.shape)
    out = x.copy()
    for step, target in ((1, np.inf), (-1, -np.inf)):
        for _ in range(int(np.abs(n).max(initial=0))):
            move = (n * step > 0) & (np.abs(n) > 0)
            out = np.where(move, np.nextafter(out, dtype(target)), out)
            n = np.where(move, n - step, n)
    return out


def _row_radius(half, r, dtype):
    h = np.asarray(half, dtype)
    return dtype(r) if r > 0 else np.hypot(h[0], h[1]).astype(dtype)


def hostile_collision(seed: int = 0, dtype=np.float32) -> dict:
    """Fleet-form operands by name (``dtype`` numpy arrays, ``valid``
    bool): cx, cy, theta [F, T, K], pose [F, M, T, 3], half_ext [F, M, 2],
    valid [F, M, T], radius [F, M], half_length, half_width [F]; plus
    ``case`` [K], each candidate's index into ``CASES``."""
    rng = np.random.default_rng(seed)
    F, M = len(EGO_EXTENTS), len(ROWS)
    T = 2 * (M - 1)
    K = len(CASES) * PER_CASE
    pose = np.zeros((M, T, 3))
    pose[:, :, 0] = 1e4 + 100.0 * np.arange(M)[:, None]
    pose[:, :, 1] = 1e4
    for t in range(T):
        m = t // 2
        pose[m, t] = (0.0, 0.0, 0.0 if t % 2 == 0 else
                      rng.uniform(-np.pi, np.pi))
    pose[M - 1, :, :2] = 0.0                    # never valid, in the way
    bad = M - 2                                 # NaN, huge and inf poses
    pose[bad, 2 * bad + 1, 2] = np.nan
    pose[bad, 0, 2] = 1e6
    pose[bad, 1, 0] = np.inf
    pose[bad, 3, 1] = -np.inf
    pose[bad, 5, 2] = np.inf
    valid = rng.random((M, T)) > 0.15
    for t in range(T):
        valid[t // 2, t] = True
    valid[M - 1] = False
    half = np.array([h for h, _ in ROWS])
    radius = np.array([r for _, r in ROWS])

    case = np.repeat(np.arange(len(CASES)), PER_CASE)
    c = {name: np.flatnonzero(case == i) for i, name in enumerate(CASES)}
    cx = np.zeros((F, T, K), dtype)
    cy = np.zeros((F, T, K), dtype)
    theta = np.zeros((F, T, K), dtype)
    for f, (ehl, ehw) in enumerate(EGO_EXTENTS):
        r_ego = np.hypot(dtype(ehl), dtype(ehw)).astype(dtype)
        for t in range(T):
            m = t // 2
            h, r = ROWS[m]
            r_sum = dtype(r_ego + _row_radius(h, r, dtype))
            if not np.isfinite(r_sum) or r_sum <= 0:
                r_sum = dtype(3.0)
            # the obstacle is at the origin: dx = -ex exactly
            idx = c["shell"]
            n = len(idx)
            reach = dtype(dtype(1.0 + SKIP_DELTA) * r_sum)
            inner = dtype(dtype(1.0 - SKIP_DELTA) * r_sum)
            d = _ulp_steps(np.where(np.arange(n) % 2 == 0, reach, inner),
                           dtype, np.arange(n) // 2 % 3 - 1)
            # half along an axis (d in one coordinate), half at random
            axis = np.arange(n) % 4 < 2
            a = rng.integers(0, 4, n)
            phi = rng.uniform(-np.pi, np.pi, n)
            cx[f, t, idx] = np.where(
                axis, np.select([a == 0, a == 2], [d, -d], 0.0),
                d * np.cos(phi)).astype(dtype)
            cy[f, t, idx] = np.where(
                axis, np.select([a == 1, a == 3], [d, -d], 0.0),
                d * np.sin(phi)).astype(dtype)
            theta[f, t, idx] = rng.uniform(-np.pi, np.pi, n)

            idx = c["touch"]
            n = len(idx)
            oh = np.asarray(h, dtype)
            reach_x = dtype(dtype(ehl) + (dtype(r) if r > 0 else oh[0]))
            d = _ulp_steps(np.full(n, reach_x, dtype), dtype,
                           np.arange(n) % 3 - 1)
            side = np.where(np.arange(n) % 2 == 0, 1.0, -1.0)
            cx[f, t, idx] = (side * d).astype(dtype)
            lim = abs(float(ehw)) + abs(float(oh[1]) if np.isfinite(oh[1])
                                        else 0.0)
            cy[f, t, idx] = np.where(np.arange(n) % 6 < 3, 0.0,
                                     rng.uniform(-lim, lim, n)).astype(dtype)
            theta[f, t, idx] = np.where(np.arange(n) % 4 == 3, np.pi, 0.0)

            idx = c["near"]
            n = len(idx)
            cx[f, t, idx] = rng.uniform(-2, 2, n) * reach
            cy[f, t, idx] = rng.uniform(-2, 2, n) * reach
            theta[f, t, idx] = rng.uniform(-np.pi, np.pi, n)

            idx = c["bad_pose"]
            n = len(idx)
            cx[f, t, idx] = rng.uniform(-1, 1, n) * reach
            cy[f, t, idx] = rng.uniform(-1, 1, n) * reach
            theta[f, t, idx] = rng.uniform(-np.pi, np.pi, n)
            which = rng.integers(0, 9, n)
            values = np.array([np.nan, np.inf, -np.inf])
            for j, w in zip(idx, which):
                target = (cx, cy, theta)[w // 3]
                if rng.random() < 0.5:
                    target[f, t, j] = values[w % 3]

            idx = c["huge"]
            n = len(idx)
            big = np.array([1e19, 3e19, 1e30, 3e38, 1.7e308])
            big = big[big <= np.finfo(dtype).max]
            cx[f, t, idx] = rng.choice(big, n) * rng.choice([-1.0, 1.0], n)
            cy[f, t, idx] = np.where(np.arange(n) % 2 == 0, 0.0, 1.0)
            theta[f, t, idx] = np.where(np.arange(n) % 3 == 0, 1e30, 0.3)

            idx = c["tiny"]
            n = len(idx)
            tiny = np.array([1e-40, -1e-42, 1e-310, 0.0, 1e-30])
            cx[f, t, idx] = rng.choice(tiny, n).astype(dtype)
            cy[f, t, idx] = rng.choice(tiny, n).astype(dtype)
            theta[f, t, idx] = rng.choice(tiny, n).astype(dtype)
    ego = np.array(EGO_EXTENTS, dtype)
    tile = lambda a: np.ascontiguousarray(np.broadcast_to(a, (F,) + a.shape))
    return dict(cx=cx, cy=cy, theta=theta,
                pose=tile(pose.astype(dtype)),
                half_ext=tile(half.astype(dtype)), valid=tile(valid),
                radius=tile(radius.astype(dtype)),
                half_length=ego[:, 0].copy(), half_width=ego[:, 1].copy(),
                case=case)


def _gap(dx, dy, e_c, e_s, o_c, o_s, ehl, ehw, ohl, ohw, r):
    """float64 separation of ego and row (> 0: apart) along the same terms
    as the kernel's pair test: the largest SAT axis gap for boxes, the
    closest-point distance minus the radius for discs."""
    lx = np.abs(dx * e_c + dy * e_s)
    ly = np.abs(-dx * e_s + dy * e_c)
    rel_cos = np.abs(e_c * o_c + e_s * o_s)
    rel_sin = np.abs(o_s * e_c - o_c * e_s)
    box = np.maximum.reduce([
        lx - (ehl + ohl * rel_cos + ohw * rel_sin),
        ly - (ehw + ohl * rel_sin + ohw * rel_cos),
        np.abs(dx * o_c + dy * o_s) - (ohl + ehl * rel_cos + ehw * rel_sin),
        np.abs(-dx * o_s + dy * o_c) - (ohw + ehl * rel_sin + ehw * rel_cos)])
    disc = np.hypot(np.maximum(lx - ehl, 0.0), np.maximum(ly - ehw, 0.0)) - r
    return np.where(r > 0, disc, box)


def near_touching_collision(seed: int = 0, dtype=np.float32, F: int = 1,
                            K: int = 3414, T: int = 21) -> dict:
    """Fleet-form operands by name, as :func:`hostile_collision` returns
    them, of F problems whose every candidate-step sits within a few ulps of
    touching one of eight rows (six moving boxes, two discs; one box
    invalid over the first third of the horizon)."""
    rng = np.random.default_rng(seed)
    M = 8
    ehl, ehw = 2.25, 0.8
    t = np.arange(T) * 0.1
    pose = np.zeros((F, M, T, 3))
    pose[..., 0] = rng.uniform(10.0, 60.0, (F, M, 1)) \
        + rng.uniform(0.0, 8.0, (F, M, 1)) * t
    pose[..., 1] = rng.uniform(-4.0, 4.0, (F, M, 1))
    pose[..., 2] = rng.uniform(-0.6, 0.6, (F, M, 1)) \
        + rng.uniform(-0.2, 0.2, (F, M, 1)) * t
    half = np.tile([[2.2, 0.9], [1.0, 1.0], [2.5, 1.1], [0.4, 0.4],
                    [3.0, 1.2], [2.0, 0.8], [0.0, 0.0], [0.0, 0.0]], (F, 1, 1))
    radius = np.tile([0.0] * 6 + [1.1, 0.6], (F, 1))
    valid = np.ones((F, M, T), bool)
    valid[:, 2, :T // 3] = False

    pose = pose.astype(dtype).astype(np.float64)
    half = half.astype(dtype).astype(np.float64)
    radius = radius.astype(dtype).astype(np.float64)
    row = rng.integers(0, M, (F, T, K))
    row = np.where((row == 2) & (np.arange(T)[None, :, None] < T // 3), 0,
                   row)
    fi = np.arange(F)[:, None, None]
    ti = np.arange(T)[None, :, None]
    o = pose[fi, row, ti]                                    # [F, T, K, 3]
    ohl, ohw = half[fi, row, 0], half[fi, row, 1]
    r = radius[fi, row]
    theta = rng.uniform(-np.pi, np.pi, (F, T, K)).astype(dtype)
    th = theta.astype(np.float64)
    e_c, e_s = np.cos(th), np.sin(th)
    o_c, o_s = np.cos(o[..., 2]), np.sin(o[..., 2])
    phi = rng.uniform(-np.pi, np.pi, (F, T, K))
    ux, uy = np.cos(phi), np.sin(phi)
    lo, hi = np.zeros((F, T, K)), np.full((F, T, K), 20.0)
    for _ in range(60):                 # 20 m / 2^60: below an ulp
        mid = 0.5 * (lo + hi)
        apart = _gap(mid * ux, mid * uy, e_c, e_s, o_c, o_s, ehl, ehw, ohl,
                     ohw, r) > 0
        hi = np.where(apart, mid, hi)
        lo = np.where(apart, lo, mid)
    s = 0.5 * (lo + hi)
    cx = _ulp_steps(o[..., 0] - s * ux, dtype, rng.integers(-3, 4, s.shape))
    cy = _ulp_steps(o[..., 1] - s * uy, dtype, rng.integers(-3, 4, s.shape))
    return dict(cx=cx, cy=cy, theta=theta,
                pose=pose.astype(dtype), half_ext=half.astype(dtype),
                valid=valid, radius=radius.astype(dtype),
                half_length=np.full(F, ehl, dtype),
                half_width=np.full(F, ehw, dtype))


def fleet_operands(case: dict, tensor, flag):
    """(cx, cy, theta, ObstacleArrays, half_length, half_width) of
    ``obb_collision_fleet`` from a case; ``tensor``/``flag`` convert the
    float and the bool arrays."""
    from commonroad_rp_tpu_torch.ops.collision import ObstacleArrays

    return (tensor(case["cx"]), tensor(case["cy"]), tensor(case["theta"]),
            ObstacleArrays(pose=tensor(case["pose"]),
                           half_ext=tensor(case["half_ext"]),
                           valid=flag(case["valid"]),
                           radius=tensor(case["radius"])),
            tensor(case["half_length"]), tensor(case["half_width"]))


def problem_operands(ops, f: int):
    """Problem ``f`` of fleet-form operands as operands of ``obb_collision``
    (ego extents as host floats)."""
    cx, cy, theta, obstacles, ehl, ehw = ops
    return (cx[f].contiguous(), cy[f].contiguous(), theta[f].contiguous(),
            type(obstacles)(*(None if a is None else a[f].contiguous()
                              for a in obstacles)),
            float(ehl[f]), float(ehw[f]))
