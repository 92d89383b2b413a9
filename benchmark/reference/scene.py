"""The scene of a planning problem, derived on the host (NumPy, float64).

* the road boundary: every lanelet bound without an adjacent lanelet,
  segment by segment, except segments that lie inside the union of the
  other lanelets (junction overlaps);
* the drivable corridor along a reference path: for each path vertex the
  nearest boundary crossing of the left normal on either side, clamped to
  +-32 m and rounded inwards to 1 mm;
* the obstacle table over scenario time: per rectangle or circle obstacle
  its pose at each time step (rectangle centre offset and orientation
  applied), its half extents or radius, and whether it occupies that step
  (static obstacles always; dynamic ones over their prediction).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

BAND_CLAMP = 32.0
BAND_QUANTUM = 1024.0


class Obstacles(NamedTuple):
    pose: np.ndarray        # [M, S, 3] centre x, y, orientation per step
    half: np.ndarray        # [M, 2] half length, half width (0 for discs)
    valid: np.ndarray       # [M, S] bool
    radius: np.ndarray      # [M] disc radius, 0 for rectangles


def _inside(point, poly) -> bool:
    x, y = point
    inside = False
    j = len(poly) - 1
    for i in range(len(poly)):
        xi, yi = poly[i]
        xj, yj = poly[j]
        if (yi > y) != (yj > y):
            if x < (xj - xi) * (y - yi) / (yj - yi) + xi:
                inside = not inside
        j = i
    return inside


def road_boundary(scenario) -> np.ndarray:
    """Boundary segments [B, 2, 2] of the scenario's lanelet network."""
    lanelets = scenario.lanelet_network.lanelets
    polygons = {l.lanelet_id: np.concatenate(
        (np.asarray(l.left_vertices), np.asarray(l.right_vertices)[::-1]))
        for l in lanelets}
    segments = []
    for lanelet in lanelets:
        others = [p for lid, p in polygons.items()
                  if lid != lanelet.lanelet_id]
        for adjacent, pts in ((lanelet.adj_left, lanelet.left_vertices),
                              (lanelet.adj_right, lanelet.right_vertices)):
            if adjacent is not None:
                continue
            pts = np.asarray(pts, dtype=np.float64)
            for a, b in zip(pts[:-1], pts[1:]):
                probes = [f * a + (1.0 - f) * b
                          for f in (0.1, 0.3, 0.5, 0.7, 0.9)]
                if not all(any(_inside(p, poly) for poly in others)
                           for p in probes):
                    segments.append(np.stack([a, b]))
    return np.stack(segments) if segments else np.zeros((0, 2, 2))


def corridor(points: np.ndarray, normals: np.ndarray, segments: np.ndarray,
             d_default: float = 1e4):
    """(d_lo [P], d_hi [P]): the drivable band along the path."""
    P = len(points)
    if len(segments) == 0:
        d_lo, d_hi = np.full(P, -d_default), np.full(P, d_default)
    else:
        a, ab = segments[:, 0], segments[:, 1] - segments[:, 0]
        n = normals[:, None, :]
        ap = a[None] - points[:, None]
        denom = n[..., 0] * -ab[None, :, 1] - n[..., 1] * -ab[None, :, 0]
        denom = np.where(np.abs(denom) < 1e-12, np.nan, denom)
        t = (ap[..., 0] * -ab[None, :, 1] - ap[..., 1] * -ab[None, :, 0]) \
            / denom
        u = (n[..., 0] * ap[..., 1] - n[..., 1] * ap[..., 0]) / denom
        hit = (u >= -1e-9) & (u <= 1 + 1e-9) & np.isfinite(t)
        d_hi = np.minimum(np.where(hit & (t > 1e-9), t, np.inf).min(axis=1),
                          d_default)
        d_lo = np.maximum(np.where(hit & (t < -1e-9), t, -np.inf).max(axis=1),
                          -d_default)
    d_hi = np.floor(np.clip(d_hi, -BAND_CLAMP, BAND_CLAMP) * BAND_QUANTUM) \
        / BAND_QUANTUM
    d_lo = np.ceil(np.clip(d_lo, -BAND_CLAMP, BAND_CLAMP) * BAND_QUANTUM) \
        / BAND_QUANTUM
    return d_lo, d_hi


def obstacles(scenario, span: int) -> Obstacles:
    """The obstacle table over scenario steps 0 .. span - 1."""
    poses, halves, valids, radii = [], [], [], []
    entries = [(o, True) for o in scenario.static_obstacles] + \
        [(o, False) for o in scenario.dynamic_obstacles]
    for obstacle, static in entries:
        shape = obstacle.shape
        if hasattr(shape, "length"):
            offset = np.asarray(shape.center, dtype=np.float64)
            d_theta = float(shape.orientation)
            half, radius = (0.5 * shape.length, 0.5 * shape.width), 0.0
        elif hasattr(shape, "radius"):
            offset = np.asarray(shape.center, dtype=np.float64)
            d_theta, half, radius = 0.0, (0.0, 0.0), float(shape.radius)
        else:
            raise ValueError(f"the reference takes rectangles and circles, "
                             f"not {type(shape).__name__}")
        by_step = {} if static else {s.time_step: s
                                     for s in obstacle.trajectory}
        by_step.setdefault(obstacle.initial_state.time_step,
                           obstacle.initial_state)
        pose = np.zeros((span, 3))
        valid = np.zeros(span, dtype=bool)
        for t in range(span):
            state = obstacle.initial_state if static else by_step.get(t)
            if state is None or state.position is None:
                continue
            theta = float(state.orientation or 0.0)
            c, s = np.cos(theta), np.sin(theta)
            centre = np.asarray(state.position, dtype=np.float64) + np.array(
                [c * offset[0] - s * offset[1], s * offset[0] + c * offset[1]])
            pose[t] = [centre[0], centre[1], theta + d_theta]
            valid[t] = True
        poses.append(pose)
        halves.append(half)
        valids.append(valid)
        radii.append(radius)
    if not poses:
        return Obstacles(np.zeros((0, span, 3)), np.zeros((0, 2)),
                         np.zeros((0, span), dtype=bool), np.zeros(0))
    return Obstacles(np.stack(poses), np.asarray(halves, dtype=np.float64),
                     np.stack(valids), np.asarray(radii, dtype=np.float64))


def desired_speed(planning_problem) -> float:
    """The goal's mean velocity, else the start's (upstream
    ``retrieve_desired_velocity_from_pp``)."""
    velocity = planning_problem.goal.state_list[0].velocity
    if velocity is not None:
        if velocity.start > 0:
            return 0.5 * (velocity.start + velocity.end)
        return 0.5 * velocity.end
    return planning_problem.initial_state.velocity
