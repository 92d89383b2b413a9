"""Fused candidate scorer: the counterpart of ``commonroad_rp_tpu/ops/pallas_cycle.py``.

One call scores a whole candidate bundle and returns three [K] float32 rows:
the masked selection cost (+inf where kinematically infeasible, out of the
projection domain, goal-filtered or colliding), the kinematic-feasible cost
(collision not applied: the statistics row) and the first-failure reason code
(``ops.kinematics.REASON_*``, -1 = feasible).  Per candidate and step it
computes what the TPU kernel ``pallas_cycle._scoring_body`` computes:
quartic/quintic rollout of s and d, reference-table lookup and interpolation,
Frenet->Cartesian, the Werling transform with the Cephes arctangent and the
standstill heading hold, the five kinematic checks plus the prefilter, the
domain and goal masks, the constant-acceleration extension of short
candidates, the DefaultCostFunction terms, the three-probe corridor band
check, OBB/disc SAT against the obstacle table and convex-polygon SAT.

``score_candidates`` is the public wrapper for one planning problem, with the
argument order and layout of ``pallas_cycle._score_candidates_pallas``;
``score_fleet`` scores F problems in one launch, with the layout of
``pallas_cycle._score_fleet_pallas`` (rows [F, K]).  For CUDA tensors they
launch the hand-written kernels of ``csrc/scoring.cu`` (built with nvcc on
first use, bound through ctypes); for CPU tensors they run the plain PyTorch
version of the kernel (``score_candidates_reference``,
``score_fleet_reference``: one function, batched over problems).
``prepare_inputs``/``prepare_fleet_inputs`` lay the operands out once and
``score_prepared`` scores them, so a scan builds its constant operands
before its loop.  The fleet scan passes ``FleetLatticeInputs`` instead:
each problem's carried state and the level's static grid, from which the
fleet kernel builds the candidates itself (``lattice_candidates`` gives the
chosen ones); the plain version expands them with ``ops.grid``.  Every
launch of the library's kernels, the probe kernel's included, goes through
one helper (``_launch``): it checks the operands, allocates the output,
calls the C function on the current stream and counts the launch.

Packed reference-table columns (``pack_ref_tables``):
    0: s      1: theta   2: curv   3: curv_d   4: d_lo   5: d_hi
    6: px     7: py      8: tx     9: ty      10: nx    11: ny
"""

from __future__ import annotations

import ctypes
import pathlib
from typing import NamedTuple

import numpy as np
import torch

from commonroad_rp_tpu_torch.ops import cuda_build
from commonroad_rp_tpu_torch.ops import frenet as frenet_ops
from commonroad_rp_tpu_torch.ops import grid as grid_ops
from commonroad_rp_tpu_torch.ops.collision import (CorridorArrays,
                                                   ObstacleArrays)
from commonroad_rp_tpu_torch.ops.kinematics import VehicleArrays, _EPS

_NUM_COLS = 12
_OBS_COLS = 7   # x, y, theta, half_len, half_wid, valid, radius
# sentinel arclength offset of the successor row past the path end
_SENTINEL_DS = 1e7

# scalar-parameter slots
_NUM_SCALARS = 17
(_S_WHEELBASE, _S_WB_REAR, _S_A_MAX, _S_V_SWITCH, _S_KAPPA_MAX,
 _S_V_DELTA_MAX, _S_HALF_LEN, _S_HALF_WID, _S_X0_THETA, _S_DT, _S_LOW_VEL,
 _S_DESIRED_V, _S_DESIRED_D, _S_W_A, _S_REF_S_LAST, _S_DESIRED_S,
 _S_TABLE_S0) = range(_NUM_SCALARS)

# kernel flag bits: the five constraint checks in _CONSTRAINT_ORDER
# (velocity, acceleration, kappa, kappa_dot, yaw_rate), then the cost terms
_F_VELOCITY, _F_ACCELERATION, _F_KAPPA, _F_KAPPA_DOT, _F_YAW_RATE = \
    (1 << i for i in range(5))
_F_HAS_DESIRED_S = 1 << 5
_F_HAS_DESIRED_V = 1 << 6

_PI_2 = float(np.float32(np.pi / 2))
_PI_4 = float(np.float32(np.pi / 4))
_TWO_PI = float(np.float32(2.0 * np.pi))


def pack_ref_tables(ref: frenet_ops.RefPathTables,
                    corridor: CorridorArrays) -> torch.Tensor:
    """[P + 1, 12] float32 interpolation + corridor + geometry table
    ([F, P + 1, 12] for a fleet's [F, P] tables, as ``jax.vmap`` gives).

    The extra final row is a successor sentinel: a copy of the last row with
    its arclength pushed ``1e7`` past the path end, so the interpolation at
    the final vertex has a next row.  Use ``true_path_length`` for the domain
    bound, not the packed table's last arclength.
    """
    packed = torch.cat([
        torch.stack([ref.s, ref.theta, ref.curv, ref.curv_d,
                     corridor.d_lo, corridor.d_hi], dim=-1),
        ref.points, ref.tangent, ref.normal], dim=-1).to(torch.float32)
    sentinel = packed[..., -1:, :].clone()
    sentinel[..., 0] += _SENTINEL_DS
    return torch.cat([packed, sentinel], dim=-2).contiguous()


def true_path_length(ref: frenet_ops.RefPathTables) -> torch.Tensor:
    """The real final arclength (float32 0-d tensor)."""
    return ref.s[-1].to(torch.float32)


def atan_cephes(x: torch.Tensor) -> torch.Tensor:
    """float32 arctan, the Cephes atanf construction of the TPU kernel
    (``pallas_cycle._atan``) term for term; ``csrc/scoring.cu`` computes the
    same expression."""
    sign = torch.sign(x)
    ax = torch.abs(x)
    hi = ax > 2.414213562373095
    mid = ax > 0.4142135623730950
    x_hi = -1.0 / torch.where(hi, ax, torch.ones_like(ax))
    x_mid = (ax - 1.0) / (ax + 1.0)
    xr = torch.where(hi, x_hi, torch.where(mid, x_mid, ax))
    y0 = torch.where(hi, torch.full_like(ax, _PI_2),
                     torch.where(mid, torch.full_like(ax, _PI_4),
                                 torch.zeros_like(ax)))
    z = xr * xr
    poly = (((8.05374449538e-2 * z - 1.38776856032e-1) * z
             + 1.99777106478e-1) * z - 3.33329491539e-1) * z * xr + xr
    return sign * (y0 + poly)


class ScorerInputs(NamedTuple):
    """Kernel operands, all float32, contiguous, on one device."""

    coeffs_lon: torch.Tensor   # [K, 6]
    coeffs_lat: torch.Tensor   # [K, 6]
    traj_len: torch.Tensor     # [K] valid steps
    goal_valid: torch.Tensor   # [K] 1.0 / 0.0
    table: torch.Tensor        # [P, 12] (pack_ref_tables)
    obs: torch.Tensor          # [M, T, 7]
    poly: torch.Tensor         # [Mp, T, 2V + 1] vertices (x, y)*V + valid
    scalars: torch.Tensor      # [17]
    n_steps: int
    n_poly_verts: int
    flags: int


def _float_operand(name, t, device, ndim, last=None, who="score_candidates"):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{who}: {name} must be a tensor")
    if t.device != device:
        raise ValueError(f"{who}: {name} is on {t.device}, "
                         f"the candidates on {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{who}: {name} must be float32, got {t.dtype}")
    if t.dim() != ndim or (last is not None and t.shape[-1] != last):
        raise ValueError(f"{who}: {name} has shape {tuple(t.shape)}")
    return t.contiguous()


def _as_f32(name, t, device, shape, who="score_candidates"):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{who}: {name} must be a tensor")
    if t.device != device:
        raise ValueError(f"{who}: {name} is on {t.device}, "
                         f"the candidates on {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{who}: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    return t.to(torch.float32).contiguous()


def _scalar_row(values, device) -> torch.Tensor:
    """[17] float32 scalars: one host->device copy of the Python numbers,
    then the values that already live on the device copied in place (no
    synchronisation)."""
    row = torch.tensor([0.0 if isinstance(v, torch.Tensor) else float(v)
                        for v in values], dtype=torch.float32, device=device)
    for slot, v in enumerate(values):
        if isinstance(v, torch.Tensor):
            row[slot] = v.to(device=device, dtype=torch.float32).reshape(())
    return row


def prepare_inputs(coeffs_lon, coeffs_lat, traj_len, goal_valid,
                   packed_table, obstacles: ObstacleArrays,
                   veh: VehicleArrays, x0_orientation, dt, low_vel,
                   desired_speed, desired_d, w_a, ref_s_last=None,
                   desired_s=None, *, n_steps: int,
                   check_flags: tuple = (True,) * 5,
                   has_desired_v: bool = True,
                   scalars=None) -> ScorerInputs:
    """Validate and lay out the scorer's operands (shared by the kernel and
    the plain version, so both see identical inputs).  ``scalars``: the
    [17] float32 scalar row when the caller keeps one on the device (a
    captured program, which cannot copy host numbers into a new row);
    None builds it from the arguments."""
    device = coeffs_lon.device
    T = n_steps + 1
    cl = _float_operand("coeffs_lon", coeffs_lon, device, 2, 6)
    K = cl.shape[0]
    ca = _float_operand("coeffs_lat", coeffs_lat, device, 2, 6)
    if ca.shape[0] != K:
        raise ValueError("score_candidates: coeffs_lat/coeffs_lon disagree")
    tl = _as_f32("traj_len", traj_len, device, (K,))
    gv = _as_f32("goal_valid", goal_valid, device, (K,))
    table = _float_operand("packed_table", packed_table, device, 2, _NUM_COLS)
    if table.shape[0] < 2:
        raise ValueError("score_candidates: the packed table needs >= 2 rows")

    M = obstacles.pose.shape[0]
    if M > 0:
        if tuple(obstacles.pose.shape) != (M, T, 3):
            raise ValueError(f"score_candidates: obstacle pose has shape "
                             f"{tuple(obstacles.pose.shape)}, horizon T={T}")
        radius = obstacles.radius if obstacles.radius is not None \
            else torch.zeros((M,), dtype=torch.float32, device=device)
        obs = obstacle_rows(
            _as_f32("obstacles.pose", obstacles.pose, device, (M, T, 3)),
            _as_f32("obstacles.half_ext", obstacles.half_ext, device, (M, 2)),
            _as_f32("obstacles.valid", obstacles.valid, device, (M, T)),
            _as_f32("obstacles.radius", radius, device, (M,)))
    else:
        obs = torch.zeros((0, T, _OBS_COLS), dtype=torch.float32,
                          device=device)
    if obstacles.poly_verts is not None:
        Mp, Tp, V = obstacles.poly_verts.shape[:3]
        if Tp != T:
            raise ValueError("score_candidates: polygon table horizon differs")
        poly = torch.cat([
            _as_f32("obstacles.poly_verts", obstacles.poly_verts, device,
                    (Mp, T, V, 2)).reshape(Mp, T, 2 * V),
            _as_f32("obstacles.poly_valid", obstacles.poly_valid, device,
                    (Mp, T))[..., None]], dim=-1)
    else:
        V = 1
        poly = torch.zeros((0, T, 3), dtype=torch.float32, device=device)

    if scalars is not None:
        if scalars.dtype != torch.float32 or scalars.device != device \
                or tuple(scalars.shape) != (_NUM_SCALARS,):
            raise ValueError("score_candidates: scalars must be a "
                             f"[{_NUM_SCALARS}] float32 tensor on {device}")
    else:
        if ref_s_last is None:
            # largest non-sentinel arclength
            s_col = table[:, 0]
            ref_s_last = torch.max(torch.where(
                s_col < s_col[0] + 9e6, s_col,
                torch.full_like(s_col, -np.inf)))
        values = [0.0] * _NUM_SCALARS
        for slot, value in (
                (_S_WHEELBASE, veh.wheelbase), (_S_WB_REAR, veh.wb_rear_axle),
                (_S_A_MAX, veh.a_max), (_S_V_SWITCH, veh.v_switch),
                (_S_KAPPA_MAX, veh.kappa_max),
                (_S_V_DELTA_MAX, veh.v_delta_max),
                (_S_HALF_LEN, veh.half_length),
                (_S_HALF_WID, veh.half_width),
                (_S_X0_THETA, x0_orientation), (_S_DT, dt),
                (_S_LOW_VEL, low_vel), (_S_DESIRED_V, desired_speed),
                (_S_DESIRED_D, desired_d), (_S_W_A, w_a),
                (_S_REF_S_LAST, ref_s_last),
                (_S_DESIRED_S, 0.0 if desired_s is None else desired_s),
                (_S_TABLE_S0, table[0, 0])):
            if isinstance(value, torch.Tensor) \
                    and value.device.type == "cpu":
                value = float(value)
            elif isinstance(value, (bool, np.bool_)):
                value = float(value)
            values[slot] = value
        scalars = _scalar_row(values, device)
    flags = _flags(check_flags, desired_s is not None, has_desired_v)
    return ScorerInputs(coeffs_lon=cl, coeffs_lat=ca, traj_len=tl,
                        goal_valid=gv, table=table, obs=obs.contiguous(),
                        poly=poly.contiguous(), scalars=scalars.contiguous(),
                        n_steps=n_steps, n_poly_verts=V, flags=flags)


# ---------------------------------------------------------------------------
# the fleet's operands: F problems stacked, padded to common P, M, Mp and V
# ---------------------------------------------------------------------------

class FleetScorerInputs(NamedTuple):
    """Fleet kernel operands, all float32, contiguous, on one device."""

    coeffs_lon: torch.Tensor   # [F, K, 6]
    coeffs_lat: torch.Tensor   # [F, K, 6]
    traj_len: torch.Tensor     # [F, K] valid steps
    goal_valid: torch.Tensor   # [F, K] 1.0 / 0.0
    tables: torch.Tensor       # [F, P, 12] (pack_ref_tables per problem)
    obs: torch.Tensor          # [F, M, T, 7]
    poly: torch.Tensor         # [F, Mp, T, 2V + 1]
    scalars: torch.Tensor      # [F, 17]
    n_steps: int
    n_poly_verts: int
    flags: int


def pack_veh_stack(veh: VehicleArrays) -> torch.Tensor:
    """[F, 8] vehicle-parameter stack for ``score_fleet`` from a
    VehicleArrays whose leaves are [F] (``parallel.fleet.FleetScene.veh``);
    counterpart of ``pallas_cycle.pack_veh_stack``."""
    return torch.stack([veh.wheelbase, veh.wb_rear_axle, veh.a_max,
                        veh.v_switch, veh.kappa_max, veh.v_delta_max,
                        veh.half_length, veh.half_width],
                       dim=-1).to(torch.float32)


def obstacle_rows(pose: torch.Tensor, half_ext: torch.Tensor,
                  valid: torch.Tensor, radius=None) -> torch.Tensor:
    """[..., M, T, 7] obstacle table (x, y, theta, half_len, half_wid, valid,
    radius) from pose [..., M, T, 3], half extents [..., M, 2], validity
    [..., M, T] and disc radii [..., M] (None: all OBB rows)."""
    f32 = torch.float32
    if radius is None:
        radius = torch.zeros(half_ext.shape[:-1], dtype=f32,
                             device=pose.device)
    shape = pose.shape[:-1]
    return torch.cat([
        pose.to(f32),
        half_ext.to(f32)[..., None, :].expand(shape + (2,)),
        valid.to(f32)[..., None],
        radius.to(f32)[..., None, None].expand(shape + (1,))],
        dim=-1).contiguous()


def fleet_scalar_rows(veh_stack: torch.Tensor, x0_orientation, dt, low_vel,
                      desired_speed, desired_d, w_a, ref_s_last,
                      desired_s, table_s0) -> torch.Tensor:
    """[F, 17] scalar rows, one per problem.  Every value is a [F] tensor or
    a Python number (written with a fill, never a host copy)."""
    F = veh_stack.shape[0]
    device = veh_stack.device
    col = lambda v: v.to(device=device, dtype=torch.float32).reshape(F) \
        if isinstance(v, torch.Tensor) \
        else torch.full((F,), float(v), dtype=torch.float32, device=device)
    values = [None] * _NUM_SCALARS
    for slot, i in ((_S_WHEELBASE, 0), (_S_WB_REAR, 1), (_S_A_MAX, 2),
                    (_S_V_SWITCH, 3), (_S_KAPPA_MAX, 4), (_S_V_DELTA_MAX, 5),
                    (_S_HALF_LEN, 6), (_S_HALF_WID, 7)):
        values[slot] = veh_stack[:, i].to(torch.float32)
    for slot, value in ((_S_X0_THETA, x0_orientation), (_S_DT, dt),
                        (_S_LOW_VEL, low_vel), (_S_DESIRED_V, desired_speed),
                        (_S_DESIRED_D, desired_d), (_S_W_A, w_a),
                        (_S_REF_S_LAST, ref_s_last),
                        (_S_DESIRED_S, 0.0 if desired_s is None
                         else desired_s),
                        (_S_TABLE_S0, table_s0)):
        values[slot] = col(value)
    return torch.stack(values, dim=1).contiguous()


def _flags(check_flags, has_desired_s: bool, has_desired_v: bool) -> int:
    flags = 0
    for bit, on in zip((_F_VELOCITY, _F_ACCELERATION, _F_KAPPA,
                        _F_KAPPA_DOT, _F_YAW_RATE), check_flags):
        flags |= bit if on else 0
    flags |= _F_HAS_DESIRED_S if has_desired_s else 0
    flags |= _F_HAS_DESIRED_V if has_desired_v else 0
    return flags


def prepare_fleet_inputs(coeffs_lon, coeffs_lat, traj_len, goal_valid,
                         packed_tables, obs_pose, obs_half_ext, obs_valid,
                         veh_stack, x0_orientation, dt, low_vel,
                         desired_speed, desired_d, w_a, ref_s_last,
                         desired_s=None, obs_radius=None, poly_table=None, *,
                         n_steps: int, check_flags: tuple = (True,) * 5,
                         has_desired_s: bool = False) -> FleetScorerInputs:
    """Validate and lay out the fleet scorer's operands (shared by the kernel
    and the plain version).  Arguments follow ``_score_fleet_pallas``; every
    per-problem value has a leading F axis and ``ref_s_last`` is per problem
    (the fleet's padded tables need it from the caller)."""
    who = "score_fleet"
    device = coeffs_lon.device
    T = n_steps + 1
    cl = _float_operand("coeffs_lon", coeffs_lon, device, 3, 6, who)
    F, K = cl.shape[:2]
    ca = _float_operand("coeffs_lat", coeffs_lat, device, 3, 6, who)
    if ca.shape[:2] != (F, K):
        raise ValueError(f"{who}: coeffs_lat/coeffs_lon disagree")
    tl = _as_f32("traj_len", traj_len, device, (F, K), who)
    gv = _as_f32("goal_valid", goal_valid, device, (F, K), who)
    tables = _float_operand("packed_tables", packed_tables, device, 3,
                            _NUM_COLS, who)
    if tables.shape[0] != F or tables.shape[1] < 2:
        raise ValueError(f"{who}: packed_tables has shape "
                         f"{tuple(tables.shape)}")
    M = obs_pose.shape[1]
    if tuple(obs_pose.shape) != (F, M, T, 3):
        raise ValueError(f"{who}: obs_pose has shape "
                         f"{tuple(obs_pose.shape)}, horizon T={T}")
    for name, t, shape in (("obs_half_ext", obs_half_ext, (F, M, 2)),
                           ("obs_valid", obs_valid, (F, M, T)),
                           ("obs_radius", obs_radius, (F, M))):
        if t is not None:
            _as_f32(name, t, device, shape, who)
    obs = obstacle_rows(obs_pose.to(device), obs_half_ext, obs_valid,
                        obs_radius)
    if poly_table is None:
        V = 1
        poly = torch.zeros((F, 0, T, 3), dtype=torch.float32, device=device)
    else:
        poly = _float_operand("poly_table", poly_table, device, 4, None, who)
        if poly.shape[0] != F or poly.shape[2] != T \
                or poly.shape[3] % 2 != 1:
            raise ValueError(f"{who}: poly_table has shape "
                             f"{tuple(poly.shape)}")
        V = (poly.shape[3] - 1) // 2
    if tuple(veh_stack.shape) != (F, 8):
        raise ValueError(f"{who}: veh_stack has shape "
                         f"{tuple(veh_stack.shape)}")
    scalars = fleet_scalar_rows(veh_stack, x0_orientation, dt, low_vel,
                                desired_speed, desired_d, w_a, ref_s_last,
                                desired_s, tables[:, 0, 0])
    return FleetScorerInputs(
        coeffs_lon=cl, coeffs_lat=ca, traj_len=tl, goal_valid=gv,
        tables=tables, obs=obs, poly=poly.contiguous(), scalars=scalars,
        n_steps=n_steps, n_poly_verts=V,
        flags=_flags(check_flags, has_desired_s, True))


class FleetLatticeInputs(NamedTuple):
    """Fleet kernel operands whose candidates are each problem's regular
    sampling lattice of one level around its carried state, the fleet
    scan's candidates: the kernel builds candidate k's coefficients from
    these as ``ops.grid`` builds them (``velocity_keeping_candidates``, or
    ``stopping_candidates`` when ``stopping``), bit for bit, and no
    [F, K, 6] tensor is made.  Candidate k is lattice point (it, iv, id),
    k = (it * grid.n_lon + iv) * (Nd + 1) + id (``grid._lattice``'s order;
    id = Nd is the problem's current lateral offset); K = ``grid.size``.
    The low-velocity mode is the scalar row's (``_S_LOW_VEL``)."""

    x0_lon: torch.Tensor       # [F, 3] carried (s, s_dot, s_ddot)
    x0_lat: torch.Tensor       # [F, 3] carried (d, d_dot, d_ddot)
    bounds: torch.Tensor       # [F, 2] velocity window, or stop positions
    grid: grid_ops.StaticGrid  # the level's static grid
    stopping: bool             # quintic stop lattice, goal-behind mask
    tables: torch.Tensor       # [F, P, 12] (pack_ref_tables per problem)
    obs: torch.Tensor          # [F, M, T, 7]
    poly: torch.Tensor         # [F, Mp, T, 2V + 1]
    scalars: torch.Tensor      # [F, 17]
    n_steps: int
    n_poly_verts: int
    flags: int


def lattice_scorer_inputs(inp: FleetLatticeInputs) -> FleetScorerInputs:
    """The lattice's candidates expanded by ``ops.grid`` into the operands
    of ``score_fleet``: what the plain version scores."""
    low_vel = inp.scalars[:, _S_LOW_VEL] > 0.5
    lo, hi = inp.bounds[:, 0], inp.bounds[:, 1]
    if inp.stopping:
        cl, ca, tl, gv = grid_ops.stopping_candidates(
            inp.x0_lon, inp.x0_lat, lo, hi, low_vel, inp.grid)
        gv = gv.to(torch.float32)
    else:
        cl, ca, tl = grid_ops.velocity_keeping_candidates(
            inp.x0_lon, inp.x0_lat, lo, hi, low_vel, inp.grid)
        gv = torch.ones(tl.shape, dtype=torch.float32, device=tl.device)
    return FleetScorerInputs(
        coeffs_lon=cl, coeffs_lat=ca, traj_len=tl.to(torch.float32),
        goal_valid=gv, tables=inp.tables, obs=inp.obs, poly=inp.poly,
        scalars=inp.scalars, n_steps=inp.n_steps,
        n_poly_verts=inp.n_poly_verts, flags=inp.flags)


def _as_fleet(inp: ScorerInputs) -> FleetScorerInputs:
    """One problem as a fleet of one."""
    return FleetScorerInputs(
        coeffs_lon=inp.coeffs_lon[None], coeffs_lat=inp.coeffs_lat[None],
        traj_len=inp.traj_len[None], goal_valid=inp.goal_valid[None],
        tables=inp.table[None], obs=inp.obs[None], poly=inp.poly[None],
        scalars=inp.scalars[None], n_steps=inp.n_steps,
        n_poly_verts=inp.n_poly_verts, flags=inp.flags)


# ---------------------------------------------------------------------------
# plain PyTorch version of the kernel: vectorized over [T, F, K]
# ---------------------------------------------------------------------------

def _score_plain_fleet(inp: FleetScorerInputs):
    """The kernel's function for F problems at once: (masked, kin, reason)
    rows [F, K].  Step-major [T, F, K] arrays; per-problem scalars [F, 1]."""
    f32 = torch.float32
    cl, ca, table, sc = inp.coeffs_lon, inp.coeffs_lat, inp.tables, inp.scalars
    device = cl.device
    T = inp.n_steps + 1
    F, K = cl.shape[:2]
    P = table.shape[1]
    flags = inp.flags
    zero = torch.zeros((), dtype=f32, device=device)
    one = torch.ones((), dtype=f32, device=device)
    inf = torch.full((), np.inf, dtype=f32, device=device)
    par = lambda slot: sc[:, slot:slot + 1]                  # [F, 1]

    dt = par(_S_DT)
    low_vel = par(_S_LOW_VEL) > 0.5
    wheelbase = par(_S_WHEELBASE)
    a_max = par(_S_A_MAX)
    v_switch = par(_S_V_SWITCH)
    kappa_max = par(_S_KAPPA_MAX)
    v_delta_max = par(_S_V_DELTA_MAX)
    x0_theta = par(_S_X0_THETA)
    ref_s_last = par(_S_REF_S_LAST)

    traj_len = inp.traj_len[None]                            # [1, F, K]
    step = torch.arange(T, dtype=f32, device=device)[:, None, None]
    active = step < traj_len                                 # [T, F, K]
    t = step * dt

    def poly_eval(c, tau):
        tau2 = tau * tau
        tau3 = tau2 * tau
        tau4 = tau2 * tau2
        tau5 = tau4 * tau
        c = [c[..., i][None] for i in range(6)]
        p = (c[0] + c[1] * tau + c[2] * tau2 + c[3] * tau3 + c[4] * tau4
             + c[5] * tau5)
        v = (c[1] + 2.0 * c[2] * tau + 3.0 * c[3] * tau2 + 4.0 * c[4] * tau3
             + 5.0 * c[5] * tau4)
        a = (2.0 * c[2] + 6.0 * c[3] * tau + 12.0 * c[4] * tau2
             + 20.0 * c[5] * tau3)
        return p, v, a

    s, s_dot, s_ddot = poly_eval(cl, t)
    s = torch.where(active, s, zero)
    s_dot = torch.where(active, s_dot, zero)
    s_ddot = torch.where(active, s_ddot, zero)
    tau_lat = torch.where(active, torch.where(low_vel, s - s[:1], t), zero)
    d, d_dot, d_ddot = poly_eval(ca, tau_lat)
    d = torch.where(active, d, zero)
    d_dot = torch.where(active, d_dot, zero)
    d_ddot = torch.where(active, d_ddot, zero)
    s_dot = torch.where(torch.abs(s_dot) < _EPS, zero, s_dot)
    d_dot = torch.where(torch.abs(d_dot) < _EPS, zero, d_dot)

    pre_acc = torch.any(torch.abs(s_ddot) > a_max, dim=0)
    pre_vel = torch.any(s_dot < -_EPS, dim=0)
    prefiltered = pre_acc | pre_vel

    # table rows idx = count(s_row <= q) - 1 and idx + 1, per problem
    s_col = table[:, :, 0].contiguous()                      # [F, P]

    def row_index(q):
        idx = frenet_ops.searchsorted_right(
            s_col, q.transpose(0, 1)).transpose(0, 1) - 1
        return torch.where(torch.isnan(q), torch.full_like(idx, -1), idx)

    def rows(idx):                                           # [T, F, K, 12]
        return frenet_ops.take_rows(table, idx.transpose(0, 1),
                                    True).transpose(0, 1)

    q = torch.where(active, s, par(_S_TABLE_S0))
    idx = torch.clamp(row_index(q), 0, P - 2)
    lo = rows(idx)
    hi = rows(idx + 1)
    lam = (s - lo[..., 0]) / (hi[..., 0] - lo[..., 0])
    raw = (hi[..., 1] - lo[..., 1]) * lam + lo[..., 1]
    interp_theta = raw - _TWO_PI * torch.trunc(raw / _TWO_PI)
    k_r = (hi[..., 2] - lo[..., 2]) * lam + lo[..., 2]
    k_r_d = (hi[..., 3] - lo[..., 3]) * lam + lo[..., 3]
    ds = s - lo[..., 0]
    ego_x = lo[..., 6] + ds * lo[..., 8] + d * lo[..., 10]
    ego_y = lo[..., 7] + ds * lo[..., 9] + d * lo[..., 11]

    # Werling transform
    moving = s_dot > 0.001
    sv_safe = torch.where(moving, s_dot, one)
    dp_high = torch.where(moving, d_dot / sv_safe, zero)
    ddot_w = d_ddot - dp_high * s_ddot
    dpp_high = torch.where(moving, ddot_w / (sv_safe * sv_safe), zero)
    dp = torch.where(low_vel, d_dot, dp_high)
    dpp = torch.where(low_vel, d_ddot, dpp_high)
    theta_cl_move = atan_cephes(dp)
    theta_gl_move = theta_cl_move + interp_theta
    use_move = moving | low_vel
    # standstill hold: the heading of the last moving step, else x0
    held = []
    carry = x0_theta.expand(F, K)
    for c in range(T):
        carry = torch.where(use_move[c], theta_gl_move[c], carry)
        held.append(carry)
    theta_gl = torch.stack(held)
    theta_cl = torch.where(use_move, theta_cl_move, theta_gl - interp_theta)

    one_krd = 1.0 - k_r * d
    cos_t = torch.cos(theta_cl)
    tan_t = torch.tan(theta_cl)
    q_c = cos_t / one_krd
    kappa_gl = ((dpp + (k_r * dp + k_r_d * d) * tan_t) * cos_t * (q_c * q_c)
                + q_c * k_r)
    v = s_dot * (one_krd / cos_t)
    a = (s_ddot * one_krd / cos_t + ((s_dot * s_dot) / cos_t) *
         (one_krd * tan_t * (kappa_gl * one_krd / cos_t - k_r) -
          (k_r_d * d + k_r * dp)))

    # first (step, rank) violation; rank = reason code 0..4
    first_row = step < 1.0
    big = 1e9
    min_flat = torch.full((F, K), big, dtype=f32, device=device)

    def track(viol, rank):
        flat = step * 5.0 + float(rank)
        return torch.min(torch.where(viol & active, flat,
                                     torch.full_like(flat, big)), dim=0).values

    if flags & _F_VELOCITY:
        min_flat = torch.minimum(min_flat, track(v < -_EPS, 0))
    if flags & _F_KAPPA:
        min_flat = torch.minimum(min_flat,
                                 track(torch.abs(kappa_gl) > kappa_max, 1))
    if flags & _F_YAW_RATE:
        prev_theta = torch.cat([theta_gl[:1], theta_gl[:-1]], dim=0)
        yaw = torch.where(first_row, zero, (theta_gl - prev_theta) / dt)
        yaw_r = torch.round(yaw * 1e5) / 1e5
        min_flat = torch.minimum(min_flat,
                                 track(torch.abs(yaw_r) > kappa_max * v, 2))
    if flags & _F_KAPPA_DOT:
        steer = atan_cephes(wheelbase * kappa_gl)
        c_st = torch.cos(steer)
        kd_max = v_delta_max / (wheelbase * (c_st * c_st))
        prev_k = torch.cat([kappa_gl[:1], kappa_gl[:-1]], dim=0)
        kd = torch.where(first_row, zero, (kappa_gl - prev_k) / dt)
        min_flat = torch.minimum(min_flat, track(torch.abs(kd) > kd_max, 3))
    if flags & _F_ACCELERATION:
        fast = v > v_switch
        v_safe = torch.where(fast, v, one)
        a_hi = torch.where(fast, a_max * v_switch / v_safe, a_max)
        min_flat = torch.minimum(min_flat,
                                 track((a < -a_max) | (a > a_hi), 4))

    any_viol = min_flat < big
    kin_feasible = ~prefiltered & ~any_viol
    lat_ok = (one_krd > 0.0) & (torch.abs(d) < 19.9)
    domain_ok = torch.all(((s >= 0.0) & (s <= ref_s_last) & lat_ok)
                          | ~active, dim=0)
    feasible = kin_feasible & domain_ok & (inp.goal_valid > 0.5)
    scan_rank = min_flat - 5.0 * torch.floor(min_flat / 5.0)
    reason = torch.where(any_viol, scan_rank, torch.full_like(min_flat, -1.0))
    pre_reason = torch.where(pre_acc, torch.full_like(min_flat, 4.0),
                             torch.zeros_like(min_flat))
    reason = torch.where(prefiltered, pre_reason, reason)
    reason = torch.where(kin_feasible & ~domain_ok,
                         torch.full_like(min_flat, 5.0), reason)

    # constant-acceleration extension past the last valid step
    ext = ~active
    last = traj_len - 1.0                                    # [1, F, K]
    last_i = last.to(torch.int64)
    has_last = (last >= 0.0) & (last <= T - 1.0)
    last_idx = torch.clamp(last_i, 0, T - 1)

    def take_last(arr):
        return torch.where(has_last, torch.gather(arr, 0, last_idx), zero)

    t_rel = (step - last) * dt
    a_last = take_last(a)
    v_temp = take_last(v) + t_rel * a_last
    v_temp = v_temp * (v_temp >= 0).to(f32)
    theta_last = take_last(theta_gl)
    incr_x = torch.where(ext, dt * v_temp * torch.cos(theta_last), zero)
    incr_y = torch.where(ext, dt * v_temp * torch.sin(theta_last), zero)
    acc_x = torch.zeros((F, K), dtype=f32, device=device)
    acc_y = torch.zeros((F, K), dtype=f32, device=device)
    cum_x, cum_y = [], []
    for c in range(T):                  # sequential, as the kernel sums
        acc_x = acc_x + incr_x[c]
        acc_y = acc_y + incr_y[c]
        cum_x.append(acc_x)
        cum_y.append(acc_y)
    ego_x = torch.where(ext, take_last(ego_x) + torch.stack(cum_x), ego_x)
    ego_y = torch.where(ext, take_last(ego_y) + torch.stack(cum_y), ego_y)
    v = torch.where(ext, v_temp, v)
    a = torch.where(ext, a_last, a)
    theta_gl = torch.where(ext, theta_last, theta_gl)
    theta_cl = torch.where(ext, take_last(theta_cl), theta_cl)
    s = torch.where(ext, take_last(s) + t_rel * take_last(s_dot), s)
    d = torch.where(ext, take_last(d) + t_rel * take_last(d_dot), d)

    # DefaultCostFunction terms
    w_a = par(_S_W_A)
    desired_v = par(_S_DESIRED_V)
    desired_d = par(_S_DESIRED_D)
    sq = lambda x: x * x
    costs = torch.sum(sq(w_a * a), dim=0)
    if flags & _F_HAS_DESIRED_V:
        costs = costs + (torch.sum(sq(5.0 * (v - desired_v)), dim=0)
                         + 50.0 * sq(v[T - 1] - desired_v)
                         + 100.0 * sq(v[T // 2] - desired_v))
    if flags & _F_HAS_DESIRED_S:
        desired_s = par(_S_DESIRED_S)
        costs = costs + (torch.sum(sq(0.25 * (desired_s - s)), dim=0)
                         + sq(20.0 * (desired_s - s[T - 1])))
    costs = costs + (torch.sum(sq(0.25 * (desired_d - d)), dim=0)
                     + sq(20.0 * (desired_d - d[T - 1])))
    costs = costs + (torch.sum(sq(0.25 * torch.abs(theta_cl)), dim=0)
                     + sq(5.0 * torch.abs(theta_cl[T - 1])))

    # corridor road-boundary check: three probes along the ego box
    half_len = par(_S_HALF_LEN)
    half_wid = par(_S_HALF_WID)
    wb_rear = par(_S_WB_REAR)
    cos_cl = torch.cos(theta_cl)
    sin_cl = torch.sin(theta_cl)
    s_center = s + wb_rear * cos_cl
    d_center = d + wb_rear * sin_cl
    lat_ext = half_wid * torch.abs(cos_cl) + half_len * torch.abs(sin_cl)
    lon_ext = half_len * torch.abs(cos_cl) + half_wid * torch.abs(sin_cl)
    d_plus = d_center + lat_ext
    d_minus = d_center - lat_ext
    collides = torch.zeros((F, K), dtype=torch.bool, device=device)
    for probe in (s_center - lon_ext, s_center, s_center + lon_ext):
        q = torch.clamp(probe, min=0.0)
        q = torch.minimum(q, ref_s_last)
        bidx = row_index(q)
        band = rows(torch.clamp(bidx, min=0))
        band_ok = bidx >= 0
        band_lo = torch.where(band_ok, band[..., 4], zero)
        band_hi = torch.where(band_ok, band[..., 5], zero)
        collides = collides | torch.any((d_plus > band_hi)
                                        | (d_minus < band_lo), dim=0)

    # obstacle OBB / disc SAT at the ego box center
    e_cos = torch.cos(theta_gl)
    e_sin = torch.sin(theta_gl)
    ecx = ego_x + wb_rear * e_cos
    ecy = ego_y + wb_rear * e_sin
    step_col = lambda o, i: o[..., i].transpose(0, 1)[..., None]  # [T, F, 1]
    for m in range(inp.obs.shape[1]):
        o = inp.obs[:, m]                                    # [F, T, 7]
        ox, oy, otheta, ohl, ohw = (step_col(o, i) for i in range(5))
        valid = step_col(o, 5) > 0.5
        radius = step_col(o, 6)
        o_cos = torch.cos(otheta)
        o_sin = torch.sin(otheta)
        dx = ox - ecx
        dy = oy - ecy
        rel_cos = torch.abs(e_cos * o_cos + e_sin * o_sin)
        rel_sin = torch.abs(o_sin * e_cos - o_cos * e_sin)
        lx = torch.abs(dx * e_cos + dy * e_sin)
        ly = torch.abs(-dx * e_sin + dy * e_cos)
        sep = lx > half_len + ohl * rel_cos + ohw * rel_sin
        sep = sep | (ly > half_wid + ohl * rel_sin + ohw * rel_cos)
        sep = sep | (torch.abs(dx * o_cos + dy * o_sin) >
                     ohl + half_len * rel_cos + half_wid * rel_sin)
        sep = sep | (torch.abs(-dx * o_sin + dy * o_cos) >
                     ohw + half_len * rel_sin + half_wid * rel_cos)
        qx = torch.clamp(lx - half_len, min=0.0)
        qy = torch.clamp(ly - half_wid, min=0.0)
        disc_hit = qx * qx + qy * qy <= radius * radius
        is_disc = radius > 0.0
        hit = (is_disc & disc_hit) | (~is_disc & ~sep)
        collides = collides | torch.any(valid & hit, dim=0)

    # convex-polygon SAT: ego box axes + the piece's edge normals
    V = inp.n_poly_verts
    for m in range(inp.poly.shape[1]):
        pc = inp.poly[:, m]                                  # [F, T, 2V + 1]
        vxs = [step_col(pc, 2 * i) for i in range(V)]
        vys = [step_col(pc, 2 * i + 1) for i in range(V)]
        pvalid = step_col(pc, 2 * V) > 0.5
        pm_min = pm_max = pn_min = pn_max = None
        for i in range(V):
            rx = vxs[i] - ecx
            ry = vys[i] - ecy
            pm = rx * e_cos + ry * e_sin
            pn = -rx * e_sin + ry * e_cos
            pm_min = pm if i == 0 else torch.minimum(pm_min, pm)
            pm_max = pm if i == 0 else torch.maximum(pm_max, pm)
            pn_min = pn if i == 0 else torch.minimum(pn_min, pn)
            pn_max = pn if i == 0 else torch.maximum(pn_max, pn)
        sep_p = (pm_min > half_len) | (pm_max < -half_len) | \
            (pn_min > half_wid) | (pn_max < -half_wid)
        for e in range(V):
            e2 = (e + 1) % V
            nx = -(vys[e2] - vys[e])
            ny = vxs[e2] - vxs[e]
            lo_p = hi_p = None
            for i in range(V):
                pv = nx * vxs[i] + ny * vys[i]
                lo_p = pv if i == 0 else torch.minimum(lo_p, pv)
                hi_p = pv if i == 0 else torch.maximum(hi_p, pv)
            c_proj = nx * ecx + ny * ecy
            r_ego = (half_len * torch.abs(nx * e_cos + ny * e_sin) +
                     half_wid * torch.abs(-nx * e_sin + ny * e_cos))
            sep_p = sep_p | (c_proj - r_ego > hi_p) | (c_proj + r_ego < lo_p)
        collides = collides | torch.any(pvalid & ~sep_p, dim=0)

    return (torch.where(feasible & ~collides, costs, inf),
            torch.where(feasible, costs, inf),
            reason)


def _score_plain(inp: ScorerInputs):
    """The plain version for one problem: rows [K]."""
    return tuple(x[0] for x in _score_plain_fleet(_as_fleet(inp)))


def score_prepared_reference(inp):
    """Plain PyTorch version of the kernel on prepared operands
    (``ScorerInputs``, ``FleetScorerInputs`` or ``FleetLatticeInputs``), on
    whatever device they are."""
    if isinstance(inp, FleetLatticeInputs):
        inp = lattice_scorer_inputs(inp)
    if isinstance(inp, FleetScorerInputs):
        return _score_plain_fleet(inp)
    return _score_plain(inp)


def score_candidates_reference(*args, **kwargs):
    """Plain PyTorch version of the scoring kernel (same arguments and
    outputs as :func:`score_candidates`), on whatever device the inputs
    are."""
    return _score_plain(prepare_inputs(*args, **kwargs))


def score_fleet_reference(*args, **kwargs):
    """Plain PyTorch version of the fleet kernel (same arguments and outputs
    as :func:`score_fleet`), on whatever device the inputs are."""
    return _score_plain_fleet(prepare_fleet_inputs(*args, **kwargs))


# ---------------------------------------------------------------------------
# the CUDA kernels: build (nvcc, plain C interface), bind (ctypes), launch
# ---------------------------------------------------------------------------

KERNEL_SOURCE = cuda_build.CSRC_DIR / "scoring.cu"

# floats a scorer block stages in shared memory: the scalar row (17, padded
# to 20); per obstacle (row, step) x, y, cos, sin, half_len, half_wid, valid,
# radius; the table's arclength column
_STAGED_SCALARS = 20
_STAGED_OBS_COLS = 8
# the most dynamic shared memory a block may ask for: sm_90 gives a block
# 227 KB, of which the fleet kernel's queue of 1024 candidates and its
# counter are static (4100 bytes, counted as 5 KB)
SHARED_BLOCK_LIMIT = (227 - 5) * 1024


def shared_bytes(P: int, M: int, T: int) -> int:
    """Dynamic shared memory (bytes) of a scorer block for a table of P rows
    and M obstacle rows over T steps, from the shapes alone;
    ``csrc/scoring.cu::staged_floats`` computes the same."""
    return 4 * (_STAGED_SCALARS + M * T * _STAGED_OBS_COLS + P)


def build_library() -> pathlib.Path:
    """Compile ``csrc/scoring.cu`` (once per source and flag set, see
    ``ops.cuda_build``) and return the shared library's path."""
    return cuda_build.build(KERNEL_SOURCE)


def _bind(lib: ctypes.CDLL):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.crp_score_candidates.argtypes = [
        p, p, p, p, p, i, p, i, p, i, i, p, i, i, i, p, p]
    lib.crp_score_fleet.argtypes = [
        p, p, p, p, p, i, p, i, p, i, i, p, i, i, i, i, p, p]
    lib.crp_score_fleet_lattice.argtypes = lib.crp_score_fleet.argtypes
    lib.crp_lattice_candidates.argtypes = [p, p, p, p, p, p, i, i, i, i, p,
                                           p]
    lib.crp_trivial.argtypes = [p, p, p, i, p, i, p, p]
    lib.crp_empty.argtypes = lib.crp_trivial.argtypes
    lib.crp_score_shared_bytes.argtypes = [i, i, i]
    lib.crp_score_shared_limit.argtypes = []
    for fn in (lib.crp_score_candidates, lib.crp_score_fleet,
               lib.crp_score_fleet_lattice, lib.crp_lattice_candidates,
               lib.crp_trivial, lib.crp_empty):
        fn.restype = ctypes.c_int
    for fn in (lib.crp_score_shared_bytes, lib.crp_score_shared_limit):
        fn.restype = ctypes.c_long


def _library() -> ctypes.CDLL:
    return cuda_build.load(KERNEL_SOURCE, _bind)


def _check_kernel_operands(inp, who):
    device = inp[0].device
    for name, t in zip(inp._fields, inp):
        if not isinstance(t, torch.Tensor):
            continue
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{who}: kernel operand {name} must be "
                             "contiguous float32")
        if t.device != device:
            raise ValueError(f"{who}: kernel operand {name} is on "
                             f"{t.device}, the candidates on {device}")
    if device.type != "cuda":
        raise ValueError(f"{who}: unsupported device {device}")


def _launch(wrapper, entry, what, inp, args, out_shape):
    """One launch of a kernel of the scorer's library on the current stream:
    checks the operands ``inp`` (raises on what the kernels do not take),
    allocates the float32 output, calls the library's ``entry`` with
    ``args``, the output and the stream, checks the return code and counts
    the launch on ``wrapper``.  Under a CUDA graph capture (a scan's first
    call on the card) the launch is recorded, not run, and counts once;
    the graph's replays run the kernel without this function and count
    nothing: a captured scan's kernel executions come from the profiler."""
    _check_kernel_operands(inp, wrapper.__name__)
    out = inp.scalars.new_empty(out_shape)
    # the stream's handle without a torch.cuda.Stream object around it
    stream = torch._C._cuda_getCurrentRawStream(out.device.index)
    rc = getattr(_library(), entry)(*args, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc}")
    wrapper.launches += 1
    return out


def lattice_table(grid: grid_ops.StaticGrid, device) -> torch.Tensor:
    """A level's lattice as the kernels read it, float32 on ``device``:
    [t_values [n_t], valid steps [n_t], d_values [n_d]] (``ops.grid``'s
    cache of constants: uploaded once; a captured scan holds it for as long
    as its graph reads it)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return grid_ops.constant(
        (*grid.t_values, *grid.traj_len, *grid.d_values), torch.float32,
        device)


def lattice_flags(grid: grid_ops.StaticGrid, stopping: bool) -> int:
    """A level's sizes in the bits of the kernels' flags above the checks'
    (``_flags``): bit 7 stopping, bits 8-15 n_t, 16-23 n_lon, 24-30 n_d."""
    n_t, n_d = len(grid.t_values), len(grid.d_values)
    if n_t > 255 or grid.n_lon > 255 or n_d > 127:
        raise ValueError(f"a lattice of {n_t} x {grid.n_lon} x {n_d} samples "
                         "is larger than the kernels' flags hold")
    return int(stopping) << 7 | n_t << 8 | grid.n_lon << 16 | n_d << 24


def _lattice_args(inp: FleetLatticeInputs, who):
    """The lattice's operands of ``crp_score_fleet_lattice`` and
    ``crp_lattice_candidates``: the pointers of x0_lon, x0_lat, bounds and
    the level's ``lattice_table``, their shapes checked (``_launch`` checks
    the rest)."""
    F = inp.tables.shape[0]
    for name, shape in (("x0_lon", (F, 3)), ("x0_lat", (F, 3)),
                        ("bounds", (F, 2)), ("scalars", (F, _NUM_SCALARS))):
        if tuple(getattr(inp, name).shape) != shape:
            raise ValueError(f"{who}: {name} has shape "
                             f"{tuple(getattr(inp, name).shape)}, expected "
                             f"{shape}")
    level = lattice_table(inp.grid, inp.x0_lon.device)
    return (inp.x0_lon.data_ptr(), inp.x0_lat.data_ptr(),
            inp.bounds.data_ptr(), level.data_ptr())


def score_prepared(inp):
    """Score prepared operands: ``ScorerInputs`` (rows [K], ``score_kernel``)
    or ``FleetScorerInputs`` / ``FleetLatticeInputs`` (rows [F, K],
    ``fleet_score_kernel`` with the candidates loaded or built from the
    lattice).  CUDA operands launch the kernel and raise if it cannot be
    built or launched; CPU operands run the plain version."""
    if inp[0].device.type == "cpu":
        return score_prepared_reference(inp)
    lattice = isinstance(inp, FleetLatticeInputs)
    fleet = lattice or isinstance(inp, FleetScorerInputs)
    wrapper = score_fleet if fleet else score_candidates
    table = inp.tables if fleet else inp.table
    lead = (inp.tables.shape[0], inp.grid.size) if lattice \
        else inp.coeffs_lon.shape[:-1]          # (F, K) or (K,)
    P, V = table.shape[-2], inp.n_poly_verts
    M, T = inp.obs.shape[-3:-1]
    Mp = inp.poly.shape[-3]
    if T != inp.n_steps + 1 or inp.poly.shape[-2:] != (T, 2 * V + 1):
        raise ValueError(f"{wrapper.__name__}: obstacle or polygon table "
                         f"does not match the horizon T={inp.n_steps + 1}")
    nbytes = shared_bytes(P, M, T)
    if nbytes > SHARED_BLOCK_LIMIT:
        raise ValueError(f"{wrapper.__name__}: a table of {P} rows with {M} "
                         f"obstacle rows over {T} steps needs {nbytes} bytes "
                         f"of shared memory per block, above "
                         f"{SHARED_BLOCK_LIMIT}")
    problem = (table.data_ptr(), P, inp.obs.data_ptr(), M,
               inp.poly.data_ptr(), Mp, V, inp.scalars.data_ptr())
    if lattice:
        candidates = _lattice_args(inp, wrapper.__name__)
        flags = inp.flags | lattice_flags(inp.grid, inp.stopping)
        entry = "crp_score_fleet_lattice"
    else:
        candidates = (inp.coeffs_lon.data_ptr(), inp.coeffs_lat.data_ptr(),
                      inp.traj_len.data_ptr(), inp.goal_valid.data_ptr())
        flags = inp.flags
        entry = "crp_score_fleet" if fleet else "crp_score_candidates"
    args = (*candidates, *problem, *lead, T, flags)
    return _launch(wrapper, entry,
                   "fleet scoring kernel" if fleet else "scoring kernel",
                   inp, args, (3, *lead)).unbind(0)


def score_candidates(coeffs_lon, coeffs_lat, traj_len, goal_valid,
                     packed_table, obstacles: ObstacleArrays,
                     veh: VehicleArrays, x0_orientation, dt, low_vel,
                     desired_speed, desired_d, w_a, ref_s_last=None,
                     desired_s=None, *, n_steps: int,
                     check_flags: tuple = (True,) * 5,
                     has_desired_v: bool = True, scalars=None):
    """(masked [K], kin [K], reason [K]) float32 rows for a candidate bundle.

    Arguments follow ``pallas_cycle._score_candidates_pallas``: coefficient
    rows [K, 6] float32, ``traj_len``/``goal_valid`` [K], the packed table
    from :func:`pack_ref_tables`, the obstacle tables, vehicle scalars, the
    initial heading, ``dt``, the low-velocity flag, the cost targets and
    weight, the true path length and the optional stopping target.
    ``check_flags`` are the (velocity, acceleration, kappa, kappa_dot,
    yaw_rate) checks; ``has_desired_v`` switches the velocity cost terms off
    for the fail-safe cost.  ``scalars``: a prebuilt [17] scalar row (see
    :func:`prepare_inputs`).

    CUDA inputs launch the kernel (``score_candidates.launches`` counts the
    wrapper's launches, eager or captured, not the replays of a captured
    scan) and raise if it cannot be built or launched; CPU inputs run
    :func:`score_candidates_reference`.
    """
    return score_prepared(prepare_inputs(
        coeffs_lon, coeffs_lat, traj_len, goal_valid, packed_table,
        obstacles, veh, x0_orientation, dt, low_vel, desired_speed,
        desired_d, w_a, ref_s_last, desired_s, n_steps=n_steps,
        check_flags=check_flags, has_desired_v=has_desired_v,
        scalars=scalars))


def score_fleet(coeffs_lon, coeffs_lat, traj_len, goal_valid, packed_tables,
                obs_pose, obs_half_ext, obs_valid, veh_stack, x0_orientation,
                dt, low_vel, desired_speed, desired_d, w_a, ref_s_last,
                desired_s=None, obs_radius=None, poly_table=None, *,
                n_steps: int, check_flags: tuple = (True,) * 5,
                has_desired_s: bool = False):
    """(masked, kin, reason) rows [F, K] for F planning problems in one
    launch; the arguments of ``pallas_cycle._score_fleet_pallas`` (its TPU
    window operands ``span``/``pre`` have no counterpart): coefficients
    [F, K, 6], ``traj_len``/``goal_valid`` [F, K], packed tables [F, P, 12],
    windowed obstacles [F, M, T, ...], ``veh_stack`` [F, 8]
    (:func:`pack_veh_stack`), per-problem scalars [F], optional
    ``desired_s`` [F], disc radii [F, M] and polygon table
    [F, Mp, T, 2V + 1].  The velocity cost terms are always on; there is no
    fail-safe cost in the fleet.

    CUDA inputs launch the fleet kernel (``score_fleet.launches`` counts the
    wrapper's launches, eager or captured, not the replays of a captured
    scan) and raise if it cannot be built or launched; CPU inputs run
    :func:`score_fleet_reference`.
    """
    return score_prepared(prepare_fleet_inputs(
        coeffs_lon, coeffs_lat, traj_len, goal_valid, packed_tables,
        obs_pose, obs_half_ext, obs_valid, veh_stack, x0_orientation, dt,
        low_vel, desired_speed, desired_d, w_a, ref_s_last, desired_s,
        obs_radius, poly_table, n_steps=n_steps, check_flags=check_flags,
        has_desired_s=has_desired_s))


def lattice_candidates_reference(inp: FleetLatticeInputs,
                                 index: torch.Tensor):
    """Plain version of :func:`lattice_candidates`: the lattice expanded by
    ``ops.grid`` and the chosen candidates gathered."""
    full = lattice_scorer_inputs(inp)
    take = lambda a: torch.gather(a, 1, index[..., None].expand(
        *index.shape, a.shape[-1]))
    return (take(full.coeffs_lon), take(full.coeffs_lat),
            torch.gather(full.traj_len, 1, index))


def lattice_candidates(inp: FleetLatticeInputs, index: torch.Tensor):
    """(coeffs_lon [F, J, 6], coeffs_lat [F, J, 6], traj_len [F, J])
    float32 of the lattice candidates ``index`` [F, J] (int64, each in
    [0, K)): what ``lattice_scorer_inputs`` holds at those candidates, bit
    for bit.  The fleet scan takes its winners' coefficients from here.

    CUDA operands launch ``lattice_candidates_kernel`` of
    ``csrc/scoring.cu``, which builds them with the fleet kernel's lattice
    function (``lattice_candidates.launches`` counts the wrapper's launches;
    an index outside [0, K) gives NaN rows and 0 steps); CPU operands run
    :func:`lattice_candidates_reference`."""
    if inp.x0_lon.device.type == "cpu":
        return lattice_candidates_reference(inp, index)
    who = "lattice_candidates"
    F = inp.tables.shape[0]
    if index.dtype != torch.int64 or index.device != inp.x0_lon.device \
            or index.dim() != 2 or index.shape[0] != F:
        raise ValueError(f"{who}: index must be [F={F}, J] int64 on "
                         f"{inp.x0_lon.device}")
    index = index.contiguous()
    args = (*_lattice_args(inp, who), inp.scalars.data_ptr(),
            index.data_ptr(), F, index.shape[1], inp.grid.size,
            lattice_flags(inp.grid, inp.stopping))
    out = _launch(lattice_candidates, "crp_lattice_candidates",
                  "lattice candidates kernel", inp, args,
                  (F, index.shape[1], 13))
    return out[..., :6], out[..., 6:12], out[..., 12]


# ---------------------------------------------------------------------------
# the launch-overhead probe: a kernel with the scorer's operands, no compute
# ---------------------------------------------------------------------------

def trivial_probe_reference(inp: ScorerInputs, v) -> torch.Tensor:
    """Plain PyTorch version of the probe kernel (same arguments and output
    as :func:`trivial_probe`): (coeffs_lon[:, 0] + v) + table[0, 0] + obs0,
    obs0 = obs[0, 0, 0] or 0 without obstacles -- the function of the TPU
    probe's ``trivial_kernel`` (scripts/t61_overhead_probe.py:200) on the
    port's operands."""
    cl0 = inp.coeffs_lon[:, 0]
    obs0 = inp.obs[0, 0, 0] if inp.obs.shape[0] else cl0.new_zeros(())
    return (cl0 + v) + inp.table[0, 0] + obs0


def trivial_probe(inp: ScorerInputs, v: torch.Tensor) -> torch.Tensor:
    """[K] float32 from prepared scorer operands and a float32 scalar ``v``
    (a 0-d or [1] tensor on the operands' device): the launch-overhead
    probe of ``probes.t61_overhead``.

    CUDA operands launch ``trivial_kernel`` of ``csrc/scoring.cu`` through
    the scorer's library and launch path (``trivial_probe.launches`` counts
    the wrapper's launches) and raise if it cannot be built or launched;
    CPU operands run :func:`trivial_probe_reference`."""
    if inp.coeffs_lon.device.type == "cpu":
        return trivial_probe_reference(inp, v)
    if v.dtype != torch.float32 or v.device != inp.coeffs_lon.device \
            or v.numel() != 1:
        raise ValueError("trivial_probe: v must be one float32 value on "
                         f"{inp.coeffs_lon.device}")
    K = inp.coeffs_lon.shape[0]
    args = (inp.coeffs_lon.data_ptr(), inp.table.data_ptr(),
            inp.obs.data_ptr(), inp.obs.shape[0], v.data_ptr(), K)
    return _launch(trivial_probe, "crp_trivial", "probe kernel", inp, args,
                   (K,))


score_candidates.launches = 0
score_fleet.launches = 0
lattice_candidates.launches = 0
trivial_probe.launches = 0
