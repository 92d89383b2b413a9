"""Curvilinear (Frenet) frame as dense tensors + batched transforms.

Counterpart of ``commonroad_rp_tpu/ops/frenet.py``.  The reference path is
compiled once on the host into fixed-size tables (``from_polyline``, numpy
float64) and moved to the planner's device; conversion is a binary search
(``torch.searchsorted``) plus a gather over the whole [K, T] batch.

Every lookup also takes a fleet of reference paths: tables with a leading
problem axis (leaves [F, P, ...], as ``parallel.fleet.FleetScene.ref``) and
queries whose first axis is that problem axis ([F, ...]), each query searched
in its own problem's table -- what ``jax.vmap`` over the JAX functions does.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from commonroad_rp_tpu_torch.utils import geometry


class RefPathTables(NamedTuple):
    """Dense reference-path state tables (on the planner's device)."""

    points: torch.Tensor     # [P, 2] vertices
    s: torch.Tensor          # [P] arclength at each vertex (ref_pos)
    theta: torch.Tensor      # [P] unwrapped orientation (ref_theta)
    curv: torch.Tensor       # [P] curvature (ref_curv)
    curv_d: torch.Tensor     # [P] curvature rate (ref_curv_d)
    curv_dd: torch.Tensor    # [P] curvature rate change (ref_curv_dd)
    tangent: torch.Tensor    # [P, 2] unit tangent of segment i (last repeats)
    normal: torch.Tensor     # [P, 2] unit left normal of segment i


def from_polyline(polyline: np.ndarray, dtype=torch.float64,
                  device="cpu") -> RefPathTables:
    """Build the Frenet tables from an [P, 2] (already smoothed) reference
    polyline: host float64 math, then one cast + copy to ``device``."""
    polyline = np.asarray(polyline, dtype=np.float64)
    s = geometry.compute_pathlength(polyline)
    theta = np.unwrap(geometry.compute_orientation(polyline))
    curv = geometry.compute_curvature(polyline)
    curv_d = np.gradient(curv, s)
    curv_dd = np.gradient(curv_d, s)

    seg = np.diff(polyline, axis=0)
    seg_len = np.linalg.norm(seg, axis=1, keepdims=True)
    tangent_seg = seg / seg_len
    tangent = np.concatenate((tangent_seg, tangent_seg[-1:]), axis=0)
    normal = np.stack((-tangent[:, 1], tangent[:, 0]), axis=1)

    as_dev = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return RefPathTables(points=as_dev(polyline), s=as_dev(s),
                         theta=as_dev(theta), curv=as_dev(curv),
                         curv_d=as_dev(curv_d), curv_dd=as_dev(curv_dd),
                         tangent=as_dev(tangent), normal=as_dev(normal))


def per_problem(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Per-problem values [F] shaped to broadcast against [F, ...]."""
    return x.reshape(x.shape + (1,) * (like.dim() - x.dim()))


def searchsorted_right(table: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """count(table <= s) for a sorted 1-D table and queries of any shape, or
    for a batched [F, P] table and queries [F, ...] (row f searched for the
    queries of problem f)."""
    if table.dim() == 1:
        flat = s.reshape(-1).contiguous()
    else:
        flat = s.reshape(s.shape[0], -1).contiguous()
    return torch.searchsorted(table.contiguous(), flat,
                              right=True).reshape(s.shape)


def take_rows(table: torch.Tensor, idx: torch.Tensor,
              batched: bool) -> torch.Tensor:
    """table[idx] along the row axis: [P, ...] tables, or batched
    [F, P, ...] tables with indices [F, ...]."""
    if not batched:
        return table[idx]
    problem = torch.arange(table.shape[0], device=idx.device)
    return table[per_problem(problem, idx), idx]


def interp_index(ref: RefPathTables, s: torch.Tensor) -> torch.Tensor:
    """``np.argmax(ref_pos > s) - 1`` (reactive_planner.py:464, :835): the
    last vertex with s_vertex <= s, EXCEPT beyond the final vertex, where the
    reference's argmax over an all-False mask gives -1 (wrapping to the last
    vertex; use ``gather_wrap``).  For a batched table the final vertex is
    each problem's last (padded) row."""
    idx = searchsorted_right(ref.s, s) - 1
    last = per_problem(ref.s[..., -1], s)
    return torch.where(s >= last, torch.full_like(idx, -1), idx)


def gather_wrap(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] with numpy negative-index wrapping ([P] tables, or
    batched [F, P] tables with indices [F, ...])."""
    batched = table.dim() == 2
    return take_rows(table, torch.remainder(idx, table.shape[-1]), batched)


def interp_fraction(ref: RefPathTables, s: torch.Tensor,
                    idx: torch.Tensor) -> torch.Tensor:
    """Linear interpolation fraction s_lambda (reactive_planner.py:465-466)."""
    s_lo = gather_wrap(ref.s, idx)
    s_hi = gather_wrap(ref.s, idx + 1)
    return (s - s_lo) / (s_hi - s_lo)


def interp_table(ref_table: torch.Tensor, idx: torch.Tensor,
                 lam: torch.Tensor) -> torch.Tensor:
    """(table[idx+1] - table[idx]) * lambda + table[idx]
    (curvature interpolation form of reactive_planner.py:876-880)."""
    lo = gather_wrap(ref_table, idx)
    hi = gather_wrap(ref_table, idx + 1)
    return (hi - lo) * lam + lo


class InterpValues(NamedTuple):
    """Per-point reference-table values at idx and idx+1 (wrapped)."""

    s_lo: torch.Tensor
    s_hi: torch.Tensor
    theta_lo: torch.Tensor
    theta_hi: torch.Tensor
    curv_lo: torch.Tensor
    curv_hi: torch.Tensor
    curv_d_lo: torch.Tensor
    curv_d_hi: torch.Tensor


def lookup_interp_values(ref: RefPathTables,
                         idx: torch.Tensor) -> InterpValues:
    """All interpolation-table values at idx and idx+1 (numpy wrapping)."""
    batched = ref.s.dim() == 2
    P = ref.s.shape[-1]
    lo_i = torch.remainder(idx, P)
    hi_i = torch.remainder(lo_i + 1, P)
    packed = torch.stack([ref.s, ref.theta, ref.curv, ref.curv_d], dim=-1)
    lo = take_rows(packed, lo_i, batched)
    hi = take_rows(packed, hi_i, batched)
    return InterpValues(s_lo=lo[..., 0], s_hi=hi[..., 0],
                        theta_lo=lo[..., 1], theta_hi=hi[..., 1],
                        curv_lo=lo[..., 2], curv_hi=hi[..., 2],
                        curv_d_lo=lo[..., 3], curv_d_hi=hi[..., 3])


def wrap_two_pi(angle: torch.Tensor) -> torch.Tensor:
    """Wrap into [-2*pi, 2*pi] (make_valid_orientation semantics)."""
    two_pi = 2.0 * np.pi
    return angle - two_pi * torch.trunc(angle / two_pi)


def interpolate_angle_at(ref: RefPathTables, s: torch.Tensor,
                         idx: torch.Tensor) -> torch.Tensor:
    """Angle interpolation between vertices idx and idx+1 at arclength s
    over the unwrapped theta table (interpolate_angle,
    utils_coordinate_system.py:25-43, as the standstill states use it)."""
    x1 = gather_wrap(ref.s, idx)
    x2 = gather_wrap(ref.s, idx + 1)
    y1 = gather_wrap(ref.theta, idx)
    y2 = gather_wrap(ref.theta, idx + 1)
    return wrap_two_pi((y2 - y1) * (s - x1) / (x2 - x1) + y1)


def to_cartesian(ref: RefPathTables, s: torch.Tensor, d: torch.Tensor,
                 s_last=None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(s, d) -> (x, y, in_domain) over the segment containing s, with the
    segment index clipped to [0, P-2] (the CLCS linear-segment model).

    The domain ends at the table's last row, or at ``s_last`` where given:
    each problem's route end [F] when a fleet's tables are padded past it
    (``parallel.fleet.build_fleet_scene``, ``true_path_lengths``)."""
    batched = ref.s.dim() == 2
    P = ref.s.shape[-1]
    seg = torch.clamp(searchsorted_right(ref.s, s) - 1, 0, P - 2)
    geometry_rows = torch.cat([ref.points, ref.tangent, ref.normal,
                               ref.s[..., None]], dim=-1)         # [.., P, 7]
    rows = take_rows(geometry_rows, seg, batched)
    ds = s - rows[..., 6]
    x = rows[..., 0] + ds * rows[..., 2] + d * rows[..., 4]
    y = rows[..., 1] + ds * rows[..., 3] + d * rows[..., 5]
    end = ref.s[..., -1] if s_last is None else s_last
    in_domain = (s >= per_problem(ref.s[..., 0], s)) & \
        (s <= per_problem(end, s))
    return x, y, in_domain


def to_curvilinear(ref: RefPathTables, x: torch.Tensor, y: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Project Cartesian point(s) onto the reference path -> (s, d).

    Orthogonal projection onto the nearest polyline segment (pycrccosy
    convert_to_curvilinear_coords, utils_coordinate_system.py:176-178); d is
    the signed lateral offset (positive left of the path).  x, y of any
    (equal) shape against [P] tables; every point is measured against every
    segment.
    """
    p = torch.stack([x, y], dim=-1)[..., None, :]          # [..., 1, 2]
    a = ref.points[:-1]                                     # [P-1, 2]
    t_hat = ref.tangent[:-1]
    n_hat = ref.normal[:-1]
    seg_len = ref.s[1:] - ref.s[:-1]

    rel = p - a                                             # [..., P-1, 2]
    t_proj = torch.sum(rel * t_hat, dim=-1)                 # [..., P-1]
    t_clamped = torch.minimum(torch.clamp(t_proj, min=0.0), seg_len)
    closest = a + t_clamped[..., None] * t_hat
    dist2 = torch.sum((p - closest) ** 2, dim=-1)
    best = torch.argmin(dist2, dim=-1, keepdim=True)        # [..., 1]

    t_best = torch.gather(t_clamped, -1, best)[..., 0]
    s_out = ref.s[:-1][best[..., 0]] + t_best
    d_out = torch.gather(torch.sum(rel * n_hat, dim=-1), -1, best)[..., 0]
    return s_out, d_out
