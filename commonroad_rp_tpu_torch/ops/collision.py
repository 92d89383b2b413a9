"""Batched collision checking: OBB obstacles + road-boundary segments.

Counterpart of ``commonroad_rp_tpu/ops/collision.py`` (reference:
reactive_planner.py:218-256 scene construction, :1019-1063 per-pose RectOBB
+ TimeVariantCollisionObject collide() calls).  The scene is compiled once
on the host (numpy float64) into dense tensors on the planner's device —
obstacle pose tables [M, T, 3] with validity masks, road-boundary segments
[B, 2, 2], and the quantized drivable d-band along the reference path.  The
per-cycle checks of the conformance level program are dense separating-axis
tests over [T x M x K] (``check_collisions``, whose box/disc obstacle pass
is the CUDA kernel of ``ops.collision_kernel`` on the card), [T x B x K]
segment tests, the corridor band probes (``check_corridor``) and the swept
pass (``check_collisions_continuous``), in the tables' dtype (float32 or
float64).  The fused scorer (``ops.scoring``) covers the float32 main path.

``check_collisions`` and ``check_corridor`` also take a fleet: rollout states
[F, K, T] with a leading problem axis, the scene tables of
``parallel.fleet.FleetScene`` ([F, M, T, ...] rows, [F, P] corridor bands
and reference arclengths) and per-problem vehicle extents [F] -- what
``jax.vmap`` of the single-problem functions gives (the XLA fleet path,
``commonroad_rp_tpu/parallel/fleet.py:138-144``).  The fleet's box/disc pass
is one launch of the fleet form of the collision kernel; the polygon pass and
the corridor probes stay tensor code over [F, T, K] arrays, one polygon piece
and vertex at a time, so no [F, T, Mp, V, K] or [F, T, K, P] array is built.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from commonroad_rp_tpu_torch import native
from commonroad_rp_tpu_torch.ops.collision_kernel import (obb_collision,
                                                          obb_collision_fleet)
from commonroad_rp_tpu_torch.utils.scenario import (Circle, Polygon, Rectangle,
                                              Scenario)


class ObstacleArrays(NamedTuple):
    """Dense obstacle occupancy tables (on the planner's device).

    Box/disc group (every obstacle whose occupancy is an OBB or a disc):
      pose: [M, T, 3]  (center x, center y, orientation)
      half_ext: [M, 2] (half length, half width; (0, 0) for discs)
      valid: [M, T]    occupancy exists at that scenario time step
      radius: [M]      disc radius; 0 marks an OBB row.  None when the scene
                       has no circle obstacles (pure-OBB fast layout).

    Polygon group (convex pieces of polygon obstacles; exact SAT on device —
    pycrcc collides exact polygon primitives, reactive_planner.py:236-239):
      poly_verts: [Mp, T, V, 2]  world-frame vertices per step, padded along
                                 V by repeating the last vertex (degenerate
                                 edges contribute no separating axis)
      poly_valid: [Mp, T]
    Both None when the scene has no polygon obstacles.
    """

    pose: torch.Tensor
    half_ext: torch.Tensor
    valid: torch.Tensor
    radius: Optional[torch.Tensor] = None
    poly_verts: Optional[torch.Tensor] = None
    poly_valid: Optional[torch.Tensor] = None


class BoundaryArrays(NamedTuple):
    """Road-boundary segments [B, 2, 2] ((x1,y1),(x2,y2)) + validity [B]."""

    segments: torch.Tensor
    valid: torch.Tensor


class CorridorArrays(NamedTuple):
    """Drivable band in the reference-path frame: for each path vertex the
    signed lateral offsets of the nearest road boundary on either side.

    Fast equivalent of the boundary-obstacle collision check: instead of
    testing the ego OBB against every boundary segment ([K, T, B] SAT), the
    rollout's native (s, d) states are compared against gathered d-band
    limits — O(K*T) gathers (SURVEY.md section 7 hard part 5: the boundary
    needs a compact representation rather than the reference's triangle soup).
    """

    d_lo: torch.Tensor                      # [P] right-side boundary offset (<0)
    d_hi: torch.Tensor                      # [P] left-side boundary offset (>0)


# Corridor-band value contract: every band is a multiple of 2**-10 m (1 mm)
# clamped to [-32, 32] m.  Semantics-free given the 19.9 m lateral
# projection-domain cap (|d_center| + lat_ext < 24 m for any in-domain
# candidate, so a band at +-32 never binds), and the quantization shrinks the
# drivable band by at most 1 mm on each side (conservative: floor on d_hi,
# ceil on d_lo).  The contract is what makes the Pallas scorer's
# prefix-difference band gather bit-exact; the port's scorer gathers the band
# row directly and keeps the quantized values, so both packages score
# against the same bands.
BAND_CLAMP = 32.0
_BAND_QUANTUM = 1024.0   # 2**10 per metre


def quantize_bands(d_lo, d_hi):
    """(d_lo, d_hi) quantized to the corridor-band value contract (see
    module comment above): 1 mm grid, [-32, 32] m clamp, conservative
    rounding (the band only ever shrinks)."""
    d_hi_q = np.floor(np.clip(np.asarray(d_hi, np.float64), -BAND_CLAMP,
                              BAND_CLAMP) * _BAND_QUANTUM) / _BAND_QUANTUM
    d_lo_q = np.ceil(np.clip(np.asarray(d_lo, np.float64), -BAND_CLAMP,
                             BAND_CLAMP) * _BAND_QUANTUM) / _BAND_QUANTUM
    return d_lo_q, d_hi_q


def _tensor(a, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


def _host(t: torch.Tensor) -> np.ndarray:
    """float64 host copy of a table (the float32-rounded values when the
    planner runs float32, as the JAX package's np.asarray does)."""
    return t.detach().cpu().to(torch.float64).numpy()


# ---------------------------------------------------------------------------
# host-side scene compilation
# ---------------------------------------------------------------------------

def compile_obstacles(scenario: Scenario, t_start: int, horizon_steps: int,
                      factor: int = 1, dtype=torch.float64,
                      device="cpu") -> ObstacleArrays:
    """Flatten scenario obstacles into [M, T] occupancy tables for one window.

    Plays the role of create_collision_object per obstacle
    (reactive_planner.py:235-245) with pycrcc's exact shape primitives:
    rectangles become OBB rows, circles disc rows (half_ext (0,0) + radius),
    polygons convex pieces in the polygon group (concave inputs are
    ear-clipped on the host, ``utils.geometry.decompose_polygon``).  Static
    obstacles occupy every step; dynamic obstacles occupy the steps covered
    by their trajectory prediction (no occupancy -> no collision, matching
    pycrcc time-variant semantics).  Queried ego step i corresponds to
    scenario step t_start + i * factor (:1040).
    """
    from commonroad_rp_tpu_torch.utils.geometry import decompose_polygon

    T = horizon_steps + 1
    rows_pose: List[np.ndarray] = []
    rows_ext: List[Tuple[float, float]] = []
    rows_valid: List[np.ndarray] = []
    rows_radius: List[float] = []
    poly_piece_verts: List[np.ndarray] = []      # body-frame [V, 2] per piece
    poly_piece_states: List[List] = []           # per-step (pos, theta) or None

    def world_center(state, offset: np.ndarray):
        center = np.asarray(state.position, dtype=np.float64)
        theta = float(state.orientation or 0.0)
        if offset[0] or offset[1]:
            c, s = np.cos(theta), np.sin(theta)
            center = center + np.array([c * offset[0] - s * offset[1],
                                        s * offset[0] + c * offset[1]])
        return center, theta

    def states_over_window(obstacle, static: bool):
        """Per-ego-step obstacle state (None = no occupancy)."""
        if static:
            return [obstacle.initial_state] * T
        return [obstacle.state_at_time(t_start + i * factor) for i in range(T)]

    def add_obstacle(obstacle, static: bool):
        shape = obstacle.shape
        states = states_over_window(obstacle, static)
        if isinstance(shape, (Rectangle, Circle)):
            if isinstance(shape, Rectangle):
                offset = np.asarray(shape.center, dtype=np.float64)
                d_theta = float(shape.orientation)
                ext = (0.5 * shape.length, 0.5 * shape.width)
                radius = 0.0
            else:
                offset = np.asarray(shape.center, dtype=np.float64)
                d_theta = 0.0
                ext = (0.0, 0.0)
                radius = float(shape.radius)
            pose = np.zeros((T, 3))
            valid = np.zeros(T, dtype=bool)
            for i, state in enumerate(states):
                if state is not None and state.position is not None:
                    center, theta = world_center(state, offset)
                    pose[i] = [center[0], center[1], theta + d_theta]
                    valid[i] = True
            rows_pose.append(pose)
            rows_ext.append(ext)
            rows_valid.append(valid)
            rows_radius.append(radius)
        elif isinstance(shape, Polygon):
            pieces = decompose_polygon(shape.points)
            step_states = [(np.asarray(s.position, dtype=np.float64),
                            float(s.orientation or 0.0))
                           if s is not None and s.position is not None else None
                           for s in states]
            for piece in pieces:
                poly_piece_verts.append(piece)
                poly_piece_states.append(step_states)
        else:
            raise ValueError(f"unsupported obstacle shape {type(shape)}")

    for obstacle in scenario.static_obstacles:
        add_obstacle(obstacle, static=True)
    for obstacle in scenario.dynamic_obstacles:
        add_obstacle(obstacle, static=False)

    if rows_pose:
        pose = _tensor(np.stack(rows_pose), dtype, device)
        half_ext = _tensor(np.array(rows_ext), dtype, device)
        valid = _tensor(np.stack(rows_valid), torch.bool, device)
        radius_arr = np.asarray(rows_radius)
        radius = _tensor(radius_arr, dtype, device) \
            if np.any(radius_arr > 0) else None
    else:
        pose = torch.zeros((0, T, 3), dtype=dtype, device=device)
        half_ext = torch.zeros((0, 2), dtype=dtype, device=device)
        valid = torch.zeros((0, T), dtype=torch.bool, device=device)
        radius = None

    poly_verts = poly_valid = None
    if poly_piece_verts:
        V_max = max(len(p) for p in poly_piece_verts)
        Mp = len(poly_piece_verts)
        verts = np.zeros((Mp, T, V_max, 2))
        pvalid = np.zeros((Mp, T), dtype=bool)
        for m, (body, step_states) in enumerate(
                zip(poly_piece_verts, poly_piece_states)):
            padded = np.concatenate(
                [body, np.repeat(body[-1:], V_max - len(body), axis=0)])
            for i, st in enumerate(step_states):
                if st is None:
                    continue
                position, theta = st
                c, s = np.cos(theta), np.sin(theta)
                rot = np.array([[c, -s], [s, c]])
                verts[m, i] = padded @ rot.T + position
                pvalid[m, i] = True
        poly_verts = _tensor(verts, dtype, device)
        poly_valid = _tensor(pvalid, torch.bool, device)

    return ObstacleArrays(pose=pose, half_ext=half_ext, valid=valid,
                          radius=radius, poly_verts=poly_verts,
                          poly_valid=poly_valid)


def compile_road_boundary(scenario: Scenario, dtype=torch.float64,
                          device="cpu") -> BoundaryArrays:
    """Extract the outer boundary of the drivable area as segment arrays.

    Equivalent of create_road_boundary_obstacle (reactive_planner.py:246-248),
    which triangulates the lanelet-network complement in C++.  Here the
    boundary is derived from lanelet topology and geometry: a lanelet's
    left/right bound is a road boundary wherever no adjacent lanelet shares it
    AND the segment is not interior to the union of lanelet polygons (lanelets
    overlap without adjacency links inside junction areas).
    """
    from commonroad_rp_tpu_torch.utils.scenario import point_in_polygon

    lanelets = scenario.lanelet_network.lanelets
    polygons = {l.lanelet_id: l.polygon for l in lanelets}

    def interior(seg_a: np.ndarray, seg_b: np.ndarray, own_id: int) -> bool:
        """Segment lies inside the UNION of other lanelet polygons (junction
        overlap).  Each probe may be covered by a different lanelet — at a
        T-junction a lanelet edge can cross several turning lanelets, none of
        which contains the whole segment alone."""
        others = [poly for lanelet_id, poly in polygons.items()
                  if lanelet_id != own_id]
        probes = [f * seg_a + (1.0 - f) * seg_b
                  for f in (0.1, 0.3, 0.5, 0.7, 0.9)]
        return all(any(point_in_polygon(p, poly) for poly in others)
                   for p in probes)

    segments: List[np.ndarray] = []
    for lanelet in lanelets:
        for side, adjacent in (("left", lanelet.adj_left),
                               ("right", lanelet.adj_right)):
            if adjacent is not None:
                continue
            pts = lanelet.left_vertices if side == "left" else lanelet.right_vertices
            for a, b in zip(pts[:-1], pts[1:]):
                if not interior(a, b, lanelet.lanelet_id):
                    segments.append(np.stack([a, b]))
    if not segments:
        return BoundaryArrays(
            segments=torch.zeros((0, 2, 2), dtype=dtype, device=device),
            valid=torch.zeros((0,), dtype=torch.bool, device=device))
    seg = np.stack(segments)
    return BoundaryArrays(segments=_tensor(seg, dtype, device),
                          valid=torch.ones(len(seg), dtype=torch.bool,
                                           device=device))


def compile_corridor(boundary: BoundaryArrays, ref_tables,
                     d_default: float = 1e4, dtype=torch.float64,
                     device="cpu") -> CorridorArrays:
    """Build the drivable d-band along the reference path (host, once).

    For each reference vertex, intersect the lateral normal line with every
    road-boundary segment; the nearest intersection on each side bounds the
    drivable band.  Where no boundary crosses the normal, a large default
    keeps the side unbounded.  The sweep runs in the C++ host module
    (``native``) when it is built, else in numpy, as the JAX package's
    does.
    """
    points = _host(ref_tables.points)                              # [P, 2]
    normals = _host(ref_tables.normal)                             # [P, 2]
    segments = _host(boundary.segments)                            # [B, 2, 2]
    P = len(points)
    if segments.shape[0] == 0:
        big = np.full(P, d_default)
        d_lo, d_hi = quantize_bands(-big, big)
        return CorridorArrays(d_lo=_tensor(d_lo, dtype, device),
                              d_hi=_tensor(d_hi, dtype, device))

    if native.available():
        d_lo, d_hi = native.corridor_sweep(points, normals, segments,
                                           d_default=d_default)
    else:
        d_lo, d_hi = _corridor_sweep_numpy(points, normals, segments,
                                           d_default)
    d_lo, d_hi = quantize_bands(d_lo, d_hi)
    return CorridorArrays(d_lo=_tensor(d_lo, dtype, device),
                          d_hi=_tensor(d_hi, dtype, device))


def _corridor_sweep_numpy(points: np.ndarray, normals: np.ndarray,
                          segments: np.ndarray, d_default: float):
    """The numpy route of the corridor sweep: (d_lo[P], d_hi[P]) before
    quantization."""
    a = segments[:, 0]                                             # [B, 2]
    b = segments[:, 1]
    ab = b - a                                                     # [B, 2]

    # solve p + t*n = a + u*ab for each (vertex, segment) pair
    # [P, B] linear systems via cross products
    n = normals[:, None, :]                                        # [P, 1, 2]
    ap = a[None, :, :] - points[:, None, :]                        # [P, B, 2]
    denom = n[..., 0] * (-ab[None, :, 1]) - n[..., 1] * (-ab[None, :, 0])
    denom = np.where(np.abs(denom) < 1e-12, np.nan, denom)
    t = (ap[..., 0] * (-ab[None, :, 1]) - ap[..., 1] * (-ab[None, :, 0])) / denom
    u = (n[..., 0] * ap[..., 1] - n[..., 1] * ap[..., 0]) / denom
    hit = (u >= -1e-9) & (u <= 1 + 1e-9) & np.isfinite(t)

    t_pos = np.where(hit & (t > 1e-9), t, np.inf)
    t_neg = np.where(hit & (t < -1e-9), t, -np.inf)
    d_hi = np.minimum(t_pos.min(axis=1), d_default)
    d_lo = np.maximum(t_neg.max(axis=1), -d_default)
    return d_lo, d_hi


def check_corridor(s: torch.Tensor, d: torch.Tensor, theta_cl: torch.Tensor,
                   ref_s: torch.Tensor, corridor: CorridorArrays,
                   half_length, half_width, wb_rear_axle,
                   active: Optional[torch.Tensor] = None,
                   s_last=None) -> torch.Tensor:
    """Road-boundary violation mask [K] from curvilinear rollout states
    [K, T].

    The ego OBB (centered wb_rear_axle ahead of the rear axle along the
    heading) is conservatively boxed in the road frame: lateral half-extent
    |half_width cos(theta_cl)| + |half_length sin(theta_cl)|, probed at the
    front/center/rear longitudinal stations; each probe gathers the band row
    of its reference segment.  In the fleet form ``s_last`` [F], each
    route's end, clamps the probes from above, so that a probe past the end
    reads the band of the route's last vertex and not the rows a fleet's
    tables are padded with (``parallel.fleet``).
    """
    from commonroad_rp_tpu_torch.ops.frenet import searchsorted_right

    if s.dim() == 3:
        return _check_corridor_fleet(s, d, theta_cl, ref_s, corridor,
                                     half_length, half_width, wb_rear_axle,
                                     active, s_last)
    P = ref_s.shape[0]
    # step-major internally (the rollout's storage)
    s_t, d_t, theta_t = s.T, d.T, theta_cl.T
    s_center = s_t + wb_rear_axle * torch.cos(theta_t)
    d_center = d_t + wb_rear_axle * torch.sin(theta_t)
    lat_ext = (half_width * torch.abs(torch.cos(theta_t)) +
               half_length * torch.abs(torch.sin(theta_t)))
    lon_ext = (half_length * torch.abs(torch.cos(theta_t)) +
               half_width * torch.abs(torch.sin(theta_t)))

    bands = torch.stack([corridor.d_lo, corridor.d_hi], dim=1)      # [P, 2]
    violate = torch.zeros(s_t.shape, dtype=torch.bool, device=s.device)
    for offset in (-1.0, 0.0, 1.0):
        s_probe = s_center + offset * lon_ext
        seg = torch.clamp(searchsorted_right(ref_s, s_probe) - 1, 0, P - 1)
        rows = bands[seg]
        lo, hi = rows[..., 0], rows[..., 1]
        violate = violate | (d_center + lat_ext > hi) | \
            (d_center - lat_ext < lo)
    if active is not None:
        violate = violate & active.T
    return torch.any(violate, dim=0)


def pad_obstacles(obstacles: ObstacleArrays, m_max: int) -> ObstacleArrays:
    """Pad the box/disc obstacle axis to a fixed size (invalid rows, half
    extents 1) for static shapes.  The polygon group passes through
    unchanged."""
    M, T, _ = obstacles.pose.shape
    if M == m_max:
        return obstacles
    assert M < m_max, f"more obstacles ({M}) than padding target ({m_max})"
    pad = m_max - M
    pose, half = obstacles.pose, obstacles.half_ext
    radius = obstacles.radius
    if radius is not None:
        radius = torch.cat([radius, radius.new_zeros((pad,))])
    return ObstacleArrays(
        pose=torch.cat([pose, pose.new_zeros((pad, T, 3))]),
        half_ext=torch.cat([half, half.new_ones((pad, 2))]),
        valid=torch.cat([obstacles.valid,
                         obstacles.valid.new_zeros((pad, T))]),
        radius=radius, poly_verts=obstacles.poly_verts,
        poly_valid=obstacles.poly_valid)


# ---------------------------------------------------------------------------
# device checks
# ---------------------------------------------------------------------------

def _fill(value, like: torch.Tensor) -> torch.Tensor:
    """A scalar (float or 0-d tensor) broadcast to ``like``'s shape, dtype
    and device; a 0-d tensor already there is not copied (no device read
    inside a scan), and a float is a fill (no host->device copy)."""
    if not isinstance(value, torch.Tensor):
        return torch.full_like(like, float(value))
    return torch.as_tensor(value, dtype=like.dtype,
                           device=like.device).expand(like.shape)


def _obb_axes(theta: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unit axes (major, minor) of an OBB with orientation theta [..., 2]."""
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([c, s], dim=-1), torch.stack([-s, c], dim=-1)


def _project_radius(axis, major, minor, half_ext) -> torch.Tensor:
    """Projection radius of an OBB onto a unit axis."""
    return (half_ext[..., 0] * torch.abs(torch.sum(axis * major, dim=-1)) +
            half_ext[..., 1] * torch.abs(torch.sum(axis * minor, dim=-1)))


def obb_overlap(center_a, theta_a, half_a, center_b, theta_b,
                half_b) -> torch.Tensor:
    """Separating-axis OBB-OBB overlap test; broadcasts over leading dims.

    Batched equivalent of pycrcc.RectOBB vs RectOBB collide()
    (reactive_planner.py:1041-1042).
    """
    maj_a, min_a = _obb_axes(theta_a)
    maj_b, min_b = _obb_axes(theta_b)
    delta = center_b - center_a

    overlap = None
    for axis in (maj_a, min_a, maj_b, min_b):
        dist = torch.abs(torch.sum(delta * axis, dim=-1))
        r_a = _project_radius(axis, maj_a, min_a, half_a)
        r_b = _project_radius(axis, maj_b, min_b, half_b)
        ok = dist <= r_a + r_b
        overlap = ok if overlap is None else overlap & ok
    return overlap


def disc_obb_overlap(disc_center, radius, box_center, box_theta,
                     box_half) -> torch.Tensor:
    """Exact disc vs OBB overlap (closest-point test); broadcasts leading
    dims.

    Batched equivalent of pycrcc.Circle vs RectOBB collide(): the disc
    center is clamped into the box frame; overlap iff the clamped point lies
    within the radius (no corner over-approximation).
    """
    major, minor = _obb_axes(box_theta)
    delta = disc_center - box_center
    lx = torch.abs(torch.sum(delta * major, dim=-1))
    ly = torch.abs(torch.sum(delta * minor, dim=-1))
    qx = torch.clamp(lx - box_half[..., 0], min=0.0)
    qy = torch.clamp(ly - box_half[..., 1], min=0.0)
    return qx * qx + qy * qy <= radius * radius


def _poly_obb_overlap_tmajor(vt, pvalid_t, cx, cy, e_cos, e_sin,
                             ehl, ehw) -> torch.Tensor:
    """Exact convex-polygon vs ego-OBB SAT in the step-major layout.

    vt: [T, Mp, V, 2] world vertices (padded V repeats the final vertex);
    pvalid_t: [T, Mp]; cx/cy/e_cos/e_sin: [T, K] ego OBB center poses;
    ehl/ehw: scalar half extents.  Returns the hit mask [T, Mp, K].

    Axes: the 2 ego box axes + the polygon's V edge normals (exact for
    convex-convex SAT).  Edge normals stay unnormalized: the ego projection
    radius and the polygon interval scale identically, and zero-length
    padded edges contribute no separating axis.
    """
    # ego axes: project polygon vertices into the ego frame
    rel_x = vt[..., 0][:, :, :, None] - cx[:, None, None, :]   # [T, Mp, V, K]
    rel_y = vt[..., 1][:, :, :, None] - cy[:, None, None, :]
    ec = e_cos[:, None, None, :]
    es = e_sin[:, None, None, :]
    proj_major = rel_x * ec + rel_y * es
    proj_minor = -rel_x * es + rel_y * ec
    sep = (torch.amin(proj_major, dim=2) > ehl) | \
        (torch.amax(proj_major, dim=2) < -ehl)
    sep = sep | (torch.amin(proj_minor, dim=2) > ehw) | \
        (torch.amax(proj_minor, dim=2) < -ehw)                 # [T, Mp, K]

    # polygon edge-normal axes (candidate-independent intervals)
    edges = torch.roll(vt, -1, dims=2) - vt                    # [T, Mp, V, 2]
    nx = -edges[..., 1]
    ny = edges[..., 0]
    # the polygon's own projection interval on each normal: [T, Mp, V]
    vert_proj = (nx[..., None] * vt[..., 0][:, :, None, :] +
                 ny[..., None] * vt[..., 1][:, :, None, :])    # [T, Mp, V, V]
    lo_n = torch.amin(vert_proj, dim=-1)
    hi_n = torch.amax(vert_proj, dim=-1)
    # ego center projection + projection radius on each normal
    c_proj = (nx[..., None] * cx[:, None, None, :] +
              ny[..., None] * cy[:, None, None, :])            # [T, Mp, V, K]
    r_ego = (ehl * torch.abs(nx[..., None] * ec + ny[..., None] * es) +
             ehw * torch.abs(-nx[..., None] * es + ny[..., None] * ec))
    sep_n = (c_proj - r_ego > hi_n[..., None]) | \
        (c_proj + r_ego < lo_n[..., None])
    sep = sep | torch.any(sep_n, dim=2)
    return ~sep & pvalid_t[:, :, None]


def obb_segment_overlap(center, theta, half_ext, seg_a,
                        seg_b) -> torch.Tensor:
    """Separating-axis OBB vs line-segment overlap; broadcasts leading dims.

    Axes: the two box axes plus the segment normal (exact for convex vs
    segment).  The road-boundary check that replaces the triangle-soup
    boundary obstacle (reactive_planner.py:246-248).
    """
    major, minor = _obb_axes(theta)
    mid = 0.5 * (seg_a + seg_b)
    half_seg = 0.5 * (seg_b - seg_a)
    delta = mid - center

    overlap = None
    for axis in (major, minor):
        dist = torch.abs(torch.sum(delta * axis, dim=-1))
        r_box = _project_radius(axis, major, minor, half_ext)
        r_seg = torch.abs(torch.sum(half_seg * axis, dim=-1))
        ok = dist <= r_box + r_seg
        overlap = ok if overlap is None else overlap & ok
    seg_dir = seg_b - seg_a
    normal = torch.stack([-seg_dir[..., 1], seg_dir[..., 0]], dim=-1)
    norm_len = torch.linalg.vector_norm(normal, dim=-1, keepdim=True)
    normal = normal / torch.where(norm_len > 0, norm_len,
                                  torch.ones_like(norm_len))
    dist = torch.abs(torch.sum(delta * normal, dim=-1))
    r_box = _project_radius(normal, major, minor, half_ext)
    return overlap & (dist <= r_box)


def merge_obb_pairs(center: torch.Tensor, theta: torch.Tensor,
                    half_ext: torch.Tensor):
    """Enclose consecutive OBB pairs along the time axis in one OBB each.

    Batched closed-form equivalent of the C++ ``trajectory_preprocess_obb_sum``
    (reference: reactive_planner.py:241, :1053): for poses at steps t and t+1
    build an OBB with the circular-mean orientation whose half-extents cover
    both boxes (projected corner radii plus center-offset projections).

    Shapes: center [..., T, 2], theta [..., T], half_ext broadcastable
    [..., 2]; returns (center_m [..., T-1, 2], theta_m [..., T-1],
    half_m [..., T-1, 2]).
    """
    c0, c1 = center[..., :-1, :], center[..., 1:, :]
    t0, t1 = theta[..., :-1], theta[..., 1:]
    theta_m = torch.atan2(torch.sin(t0) + torch.sin(t1),
                          torch.cos(t0) + torch.cos(t1))
    center_m = 0.5 * (c0 + c1)
    major, minor = _obb_axes(theta_m)

    hl = torch.broadcast_to(half_ext[..., None, 0], t0.shape)
    hw = torch.broadcast_to(half_ext[..., None, 1], t0.shape)

    def cover(c_i, t_i):
        # projection radius of box i onto the merged axes + center offset
        d_theta = t_i - theta_m
        r_major = hl * torch.abs(torch.cos(d_theta)) + \
            hw * torch.abs(torch.sin(d_theta))
        r_minor = hl * torch.abs(torch.sin(d_theta)) + \
            hw * torch.abs(torch.cos(d_theta))
        off = c_i - center_m
        off_major = torch.abs(torch.sum(off * major, dim=-1))
        off_minor = torch.abs(torch.sum(off * minor, dim=-1))
        return off_major + r_major, off_minor + r_minor

    a_major, a_minor = cover(c0, t0)
    b_major, b_minor = cover(c1, t1)
    half_m = torch.stack([torch.maximum(a_major, b_major),
                          torch.maximum(a_minor, b_minor)], dim=-1)
    return center_m, theta_m, half_m


def check_collisions_continuous(x: torch.Tensor, y: torch.Tensor,
                                theta: torch.Tensor,
                                obstacles: ObstacleArrays,
                                half_length, half_width,
                                wb_rear_axle) -> torch.Tensor:
    """Swept (continuous) collision mask [K]: merged consecutive ego OBBs vs
    merged consecutive obstacle OBBs (reference continuous mode,
    reactive_planner.py:1049-1058 with obstacle preprocessing at :240-244).

    Like pycrcc's ``trajectory_preprocess_obb_sum``, non-rectangle occupancy
    pairs are enclosed in covering OBBs: discs as their bounding squares
    (half extents = radius) before merging, polygon pieces as the
    axis-aligned box covering both steps' vertices.
    """
    cx = x + wb_rear_axle * torch.cos(theta)
    cy = y + wb_rear_axle * torch.sin(theta)
    ego_center = torch.stack([cx, cy], dim=-1)                     # [K, T, 2]
    K = theta.shape[0]
    ego_half = torch.stack([_fill(half_length, theta[:, 0]),
                            _fill(half_width, theta[:, 0])], dim=-1)
    ego_c, ego_t, ego_h = merge_obb_pairs(ego_center, theta, ego_half)

    collides = torch.zeros(K, dtype=torch.bool, device=theta.device)

    if obstacles.pose.shape[0] > 0:
        half_ext = obstacles.half_ext
        if obstacles.radius is not None:
            r = obstacles.radius
            half_ext = torch.where((r > 0)[:, None],
                                   torch.stack([r, r], dim=-1), half_ext)
        obs_c, obs_t, obs_h = merge_obb_pairs(
            obstacles.pose[..., :2], obstacles.pose[..., 2], half_ext)
        pair_valid = obstacles.valid[:, :-1] & obstacles.valid[:, 1:]

        # [K, T-1, M]
        hit = obb_overlap(ego_c[:, :, None, :], ego_t[:, :, None],
                          ego_h[:, :, None, :],
                          obs_c.permute(1, 0, 2)[None], obs_t.T[None],
                          obs_h.permute(1, 0, 2)[None])
        hit = hit & pair_valid.T[None]
        collides = collides | torch.any(hit.reshape(K, -1), dim=1)

    if obstacles.poly_verts is not None:
        vt = obstacles.poly_verts                                 # [Mp, T, V, 2]
        pair_min = torch.amin(torch.minimum(vt[:, :-1], vt[:, 1:]), dim=2)
        pair_max = torch.amax(torch.maximum(vt[:, :-1], vt[:, 1:]), dim=2)
        p_center = 0.5 * (pair_min + pair_max)
        p_half = 0.5 * (pair_max - pair_min)
        p_theta = p_half.new_zeros(p_half.shape[:-1])
        pair_valid = obstacles.poly_valid[:, :-1] & \
            obstacles.poly_valid[:, 1:]
        hit = obb_overlap(ego_c[:, :, None, :], ego_t[:, :, None],
                          ego_h[:, :, None, :],
                          p_center.permute(1, 0, 2)[None], p_theta.T[None],
                          p_half.permute(1, 0, 2)[None])
        hit = hit & pair_valid.T[None]
        collides = collides | torch.any(hit.reshape(K, -1), dim=1)

    return collides


def check_collisions(x: torch.Tensor, y: torch.Tensor, theta: torch.Tensor,
                     obstacles: ObstacleArrays,
                     boundary: Optional[BoundaryArrays],
                     half_length, half_width, wb_rear_axle) -> torch.Tensor:
    """Collision mask [K] for ego trajectories [K, T] (rear-axle positions).

    Mirrors _check_collisions pose construction (reactive_planner.py:1033-1041):
    the ego OBB is centered at the rear-axle position shifted forward by
    wb_rear_axle along the heading.  The box/disc obstacle pass is
    ``ops.collision_kernel.obb_collision`` (the CUDA kernel for tensors on
    the card, its plain version on the CPU); the polygon and road-boundary
    passes are plain tensor code over [T, Mp|B, K].
    """
    if x.dim() == 3:
        if boundary is not None:
            raise ValueError("check_collisions: the fleet form checks no "
                             "road-boundary segments (the fleet path bounds "
                             "the road with check_corridor)")
        return _check_collisions_fleet(x, y, theta, obstacles, half_length,
                                       half_width, wb_rear_axle)
    # step-major: the rollout's [K, T] arrays are views of [T, K] storage
    theta_t = theta.T.contiguous()                           # [T, K]
    cx = (x.T + wb_rear_axle * torch.cos(theta_t)).contiguous()
    cy = (y.T + wb_rear_axle * torch.sin(theta_t)).contiguous()
    ehl, ehw = half_length, half_width

    collides = obb_collision(cx, cy, theta_t, obstacles, ehl, ehw)

    if obstacles.poly_verts is not None:
        vt = obstacles.poly_verts.permute(1, 0, 2, 3)        # [T, Mp, V, 2]
        hit_p = _poly_obb_overlap_tmajor(
            vt, obstacles.poly_valid.T, cx, cy,
            torch.cos(theta_t), torch.sin(theta_t), ehl, ehw)
        collides = collides | torch.any(
            hit_p.reshape(-1, hit_p.shape[-1]), dim=0)

    if boundary is not None and boundary.segments.shape[0] > 0:
        ego_center = torch.stack([cx, cy], dim=-1)           # [T, K, 2]
        ego_half = torch.stack([_fill(ehl, cx), _fill(ehw, cx)], dim=-1)
        seg_a = boundary.segments[None, :, None, 0, :]       # [1, B, 1, 2]
        seg_b = boundary.segments[None, :, None, 1, :]
        hit_b = obb_segment_overlap(ego_center[:, None], theta_t[:, None],
                                    ego_half[:, None], seg_a, seg_b)
        hit_b = hit_b & boundary.valid[None, :, None]        # [T, B, K]
        collides = collides | torch.any(
            hit_b.reshape(-1, hit_b.shape[-1]), dim=0)

    return collides


# ---------------------------------------------------------------------------
# fleet forms: a leading problem axis F (jax.vmap of the functions above)
# ---------------------------------------------------------------------------

def _per_problem(value, like: torch.Tensor) -> torch.Tensor:
    """A vehicle value -- a Python float, a 0-d tensor or per-problem [F] --
    shaped [F, 1, 1] (or left a float) to broadcast against [F, T, K]."""
    if isinstance(value, torch.Tensor) and value.dim() == 1:
        return value.to(like.dtype).reshape(-1, 1, 1)
    return value


def per_problem_vector(value, like: torch.Tensor) -> torch.Tensor:
    """A vehicle value (a Python float, a 0-d or an [F] tensor) as a
    contiguous [F] tensor on ``like``'s device and in its dtype, F =
    ``like.shape[0]`` (a fill for a Python float: no host-to-device copy)."""
    F = like.shape[0]
    if isinstance(value, torch.Tensor):
        return value.to(like.dtype).expand(F).contiguous()
    return torch.full((F,), float(value), dtype=like.dtype, device=like.device)


def _poly_obb_overlap_fleet(vt, pvalid, cx, cy, e_cos, e_sin, ehl,
                            ehw) -> torch.Tensor:
    """:func:`_poly_obb_overlap_tmajor` with a leading problem axis, reduced
    over steps and pieces: the hit mask [F, K].

    vt: [F, T, Mp, V, 2] world vertices; pvalid: [F, T, Mp]; cx/cy/e_cos/
    e_sin: [F, T, K]; ehl/ehw: [F, 1, 1] (or floats).  Each piece and vertex
    is one [F, T, K] step of a Python loop (Mp and V are a few), with the
    single-problem form's arithmetic element for element."""
    F, T, Mp, V, _ = vt.shape
    edges = torch.roll(vt, -1, dims=3) - vt                    # [F, T, Mp, V, 2]
    nx = -edges[..., 1]
    ny = edges[..., 0]
    vert_proj = (nx[..., None] * vt[..., 0][..., None, :] +
                 ny[..., None] * vt[..., 1][..., None, :])     # [F, T, Mp, V, V]
    lo_n = torch.amin(vert_proj, dim=-1)
    hi_n = torch.amax(vert_proj, dim=-1)
    hit = torch.zeros((F, cx.shape[-1]), dtype=torch.bool, device=cx.device)
    for m in range(Mp):
        bounds = None
        for v in range(V):
            rel_x = vt[:, :, m, v, 0, None] - cx                # [F, T, K]
            rel_y = vt[:, :, m, v, 1, None] - cy
            proj = (rel_x * e_cos + rel_y * e_sin,
                    -rel_x * e_sin + rel_y * e_cos)
            bounds = [(p, p) for p in proj] if bounds is None else [
                (torch.minimum(lo, p), torch.maximum(hi, p))
                for (lo, hi), p in zip(bounds, proj)]
        (maj_lo, maj_hi), (min_lo, min_hi) = bounds
        sep = (maj_lo > ehl) | (maj_hi < -ehl)
        sep = sep | (min_lo > ehw) | (min_hi < -ehw)
        for e in range(V):
            nx_e = nx[:, :, m, e, None]                         # [F, T, 1]
            ny_e = ny[:, :, m, e, None]
            c_proj = nx_e * cx + ny_e * cy
            r_ego = (ehl * torch.abs(nx_e * e_cos + ny_e * e_sin) +
                     ehw * torch.abs(-nx_e * e_sin + ny_e * e_cos))
            sep = sep | (c_proj - r_ego > hi_n[:, :, m, e, None]) | \
                (c_proj + r_ego < lo_n[:, :, m, e, None])
        hit = hit | torch.any(~sep & pvalid[:, :, m, None], dim=1)
    return hit


def _check_collisions_fleet(x, y, theta, obstacles: ObstacleArrays,
                            half_length, half_width,
                            wb_rear_axle) -> torch.Tensor:
    """Collision masks [F, K] for F problems' trajectories [F, K, T]
    against ``obstacles`` with leading problem axes (pose [F, M, T, 3],
    half_ext [F, M, 2], valid [F, M, T], radius [F, M] or None, poly_verts
    [F, Mp, T, V, 2] or None, poly_valid [F, Mp, T]); vehicle values are
    floats, 0-d or [F] tensors."""
    theta_t = theta.transpose(1, 2).contiguous()             # [F, T, K]
    wb = _per_problem(wb_rear_axle, theta_t)
    cx = (x.transpose(1, 2) + wb * torch.cos(theta_t)).contiguous()
    cy = (y.transpose(1, 2) + wb * torch.sin(theta_t)).contiguous()
    box = ObstacleArrays(
        pose=obstacles.pose.contiguous(),
        half_ext=obstacles.half_ext.contiguous(),
        valid=obstacles.valid.contiguous(),
        radius=None if obstacles.radius is None
        else obstacles.radius.contiguous())
    collides = obb_collision_fleet(
        cx, cy, theta_t, box, per_problem_vector(half_length, theta_t),
        per_problem_vector(half_width, theta_t))
    if obstacles.poly_verts is not None and obstacles.poly_verts.shape[1]:
        collides = collides | _poly_obb_overlap_fleet(
            obstacles.poly_verts.transpose(1, 2),
            obstacles.poly_valid.transpose(1, 2), cx, cy,
            torch.cos(theta_t), torch.sin(theta_t),
            _per_problem(half_length, theta_t),
            _per_problem(half_width, theta_t))
    return collides


def _check_corridor_fleet(s, d, theta_cl, ref_s, corridor: CorridorArrays,
                          half_length, half_width, wb_rear_axle,
                          active=None, s_last=None) -> torch.Tensor:
    """Road-boundary violation masks [F, K] for rollout states [F, K, T]
    against per-problem bands [F, P] over arclengths [F, P], each probe
    clamped to its problem's ``s_last`` [F] where given."""
    from commonroad_rp_tpu_torch.ops.frenet import (searchsorted_right,
                                                    take_rows)

    P = ref_s.shape[-1]
    s_t, d_t, theta_t = (a.transpose(1, 2) for a in (s, d, theta_cl))
    wb = _per_problem(wb_rear_axle, s_t)
    hl = _per_problem(half_length, s_t)
    hw = _per_problem(half_width, s_t)
    s_center = s_t + wb * torch.cos(theta_t)
    d_center = d_t + wb * torch.sin(theta_t)
    lat_ext = (hw * torch.abs(torch.cos(theta_t)) +
               hl * torch.abs(torch.sin(theta_t)))
    lon_ext = (hl * torch.abs(torch.cos(theta_t)) +
               hw * torch.abs(torch.sin(theta_t)))

    bands = torch.stack([corridor.d_lo, corridor.d_hi], dim=-1)     # [F, P, 2]
    violate = torch.zeros(s_t.shape, dtype=torch.bool, device=s.device)
    for offset in (-1.0, 0.0, 1.0):
        s_probe = s_center + offset * lon_ext
        if s_last is not None:
            s_probe = torch.minimum(s_probe, _per_problem(s_last, s_probe))
        seg = torch.clamp(searchsorted_right(ref_s, s_probe) - 1, 0, P - 1)
        rows = take_rows(bands, seg, batched=True)                  # [F, T, K, 2]
        lo, hi = rows[..., 0], rows[..., 1]
        violate = violate | (d_center + lat_ext > hi) | \
            (d_center - lat_ext < lo)
    if active is not None:
        violate = violate & active.transpose(1, 2)
    return torch.any(violate, dim=1)
