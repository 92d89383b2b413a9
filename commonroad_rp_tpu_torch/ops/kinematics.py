"""Batched kinematic rollout, feasibility masks, and candidate extension.

Counterpart of ``commonroad_rp_tpu/ops/kinematics.py::rollout`` (reference:
commonroad_rp/reactive_planner.py:715-969 ``_check_kinematics``): the whole
bundle as one dense [T, K] tensor program — polynomial rollout, Werling
transform, the five constraint checks with first-failure reasons, the
projection-domain mask, Frenet->Cartesian conversion and the
constant-acceleration extension (``enlarge``) of short candidates.  The main
path runs it once per cycle for the K=1 winner re-roll (the fleet scan for
every problem's winner at once, with a leading problem axis); the fused
scorer (``ops.scoring``) covers the candidate bundle.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from commonroad_rp_tpu_torch.ops import frenet as frenet_ops
from commonroad_rp_tpu_torch.ops import polynomial as poly

# precision value (reactive_planner.py:49)
_EPS = 1e-5

# pycrccosy CurvilinearCoordinateSystem constructor defaults: lateral
# projection-domain limit and the eps the C++ subtracts from it
PROJECTION_DOMAIN_LIMIT = 20.0
_CLCS_EPS = 0.1

# infeasibility reason codes (check order of reactive_planner.py:971-1017;
# DOMAIN is the out-of-projection-domain rejection at :910-917)
REASON_FEASIBLE = -1
REASON_VELOCITY = 0
REASON_KAPPA = 1
REASON_YAW_RATE = 2
REASON_KAPPA_DOT = 3
REASON_ACCELERATION = 4
REASON_DOMAIN = 5

REASON_NAMES = {
    REASON_VELOCITY: "velocity",
    REASON_KAPPA: "kappa",
    REASON_YAW_RATE: "yaw_rate",
    REASON_KAPPA_DOT: "kappa_dot",
    REASON_ACCELERATION: "acceleration",
}


class VehicleArrays(NamedTuple):
    """Vehicle constraint scalars (0-d tensors or floats)."""

    wheelbase: torch.Tensor
    wb_rear_axle: torch.Tensor
    a_max: torch.Tensor
    v_switch: torch.Tensor
    kappa_max: torch.Tensor       # tan(delta_max) / wheelbase
    v_delta_max: torch.Tensor
    half_length: torch.Tensor
    half_width: torch.Tensor


class RolloutResult(NamedTuple):
    """Dense per-candidate trajectory arrays after rollout + enlarge:
    state arrays [K, T], masks [K]."""

    s: torch.Tensor
    s_dot: torch.Tensor
    s_ddot: torch.Tensor
    d: torch.Tensor
    d_dot: torch.Tensor
    d_ddot: torch.Tensor
    theta_cl: torch.Tensor
    x: torch.Tensor
    y: torch.Tensor
    theta_gl: torch.Tensor
    v: torch.Tensor
    a: torch.Tensor
    kappa_gl: torch.Tensor
    kappa_dot: torch.Tensor
    feasible: torch.Tensor        # [K] bool: kinematics + projection domain
    reason: torch.Tensor          # [K] int32 reason code (REASON_*)


def _diff0(arr: torch.Tensor) -> torch.Tensor:
    """[0, arr[1:] - arr[:-1]] along the step axis."""
    return torch.cat([torch.zeros_like(arr[:1]), arr[1:] - arr[:-1]], dim=0)


def _select(cond, a, b):
    """``a`` where ``cond`` else ``b``: a Python bool picks one side, a
    tensor selects elementwise (the mode is a device value per cycle, or per
    problem, in the scans)."""
    if isinstance(cond, (bool, np.bool_)):
        return a if cond else b
    return torch.where(cond, a, b)


def rollout(coeffs_lon: torch.Tensor,
            coeffs_lat: torch.Tensor,
            traj_len: torch.Tensor,
            ref: frenet_ops.RefPathTables,
            veh: VehicleArrays,
            x0_orientation,
            dt: float,
            n_steps: int,
            low_vel_mode,
            check_velocity: bool = True,
            check_acceleration: bool = True,
            check_kappa: bool = True,
            check_kappa_dot: bool = True,
            check_yaw_rate: bool = True,
            s_last=None) -> RolloutResult:
    """Evaluate, transform, constraint-check, and extend a candidate batch.

    coeffs_lon/coeffs_lat [K, 6]; traj_len [K] valid steps; arrays span
    T = n_steps + 1 steps of ``dt``; everything runs in ``coeffs_lon``'s
    dtype on its device.  ``low_vel_mode`` parameterizes the lateral
    polynomials by travelled arclength (reactive_planner.py:755-772): a
    Python bool, or a bool tensor selected elementwise so that a scan never
    reads it back.

    With a leading problem axis -- coefficients [F, K, 6], ``traj_len``
    [F, K], reference tables [F, P, ...], vehicle leaves, orientation and
    ``low_vel_mode`` [F] -- each problem rolls out against its own tables
    and vehicle (``jax.vmap`` of the JAX function); results are [F, K, T].
    ``s_last`` [F], each problem's route end, then bounds the projection
    domain in place of the tables' padded last row
    (``frenet_ops.to_cartesian``).
    """
    dtype = coeffs_lon.dtype
    device = coeffs_lon.device
    batch_shape = tuple(coeffs_lon.shape[:-1])          # (K,) or (F, K)
    batched = len(batch_shape) == 2
    T = n_steps + 1

    def as_t(x):
        """A scalar, or per-problem [F] values shaped [F, 1]; a Python
        number becomes a fill, not a host->device copy (a captured program
        cannot copy from the host)."""
        t = torch.as_tensor(x, dtype=dtype, device=device) \
            if isinstance(x, torch.Tensor) or np.ndim(x) \
            else torch.full((), float(x), dtype=dtype, device=device)
        return t[:, None] if batched and t.dim() == 1 else t

    low_vel = low_vel_mode
    if isinstance(low_vel, torch.Tensor):
        low_vel = low_vel.to(device=device, dtype=torch.bool)
        if batched and low_vel.dim() == 1:
            low_vel = low_vel[:, None]
    else:
        low_vel = bool(low_vel)
    # the reference-table lookups take problem-major queries [F, T, K]
    to_q = (lambda a: a.transpose(0, 1)) if batched else (lambda a: a)

    col = (T,) + (1,) * len(batch_shape)
    shape = (T,) + batch_shape
    t_vec = torch.arange(T, dtype=dtype, device=device) * dt
    step_idx = torch.arange(T, dtype=torch.int64, device=device).reshape(col)
    traj_len = traj_len.to(device=device, dtype=torch.int64)
    # all internal math is step-major [T, (F,) K]; public arrays [(F,) K, T]
    active = step_idx < traj_len[None]
    zero = torch.zeros((), dtype=dtype, device=device)

    cl = coeffs_lon[None]
    tau_lon = t_vec.reshape(col)
    s = torch.where(active, poly.eval_position(cl, tau_lon), zero)
    s_dot = torch.where(active, poly.eval_velocity(cl, tau_lon), zero)
    s_ddot = torch.where(active, poly.eval_acceleration(cl, tau_lon), zero)

    tau_lat = torch.where(active,
                          _select(low_vel, s - s[:1], tau_lon.expand(shape)),
                          zero)
    ca = coeffs_lat[None]
    d = torch.where(active, poly.eval_position(ca, tau_lat), zero)
    d_dot = torch.where(active, poly.eval_velocity(ca, tau_lat), zero)
    d_ddot = torch.where(active, poly.eval_acceleration(ca, tau_lat), zero)

    # near-zero velocity clamp (reactive_planner.py:776-777)
    s_dot = torch.where(torch.abs(s_dot) < _EPS, zero, s_dot)
    d_dot = torch.where(torch.abs(d_dot) < _EPS, zero, d_dot)

    # under-approximative pre-filter (:796-805); acceleration wins the reason
    pre_acc = torch.any(torch.abs(s_ddot) > as_t(veh.a_max), dim=0)
    pre_vel = torch.any(s_dot < -_EPS, dim=0)
    prefiltered = pre_acc | pre_vel
    pre_reason = torch.where(pre_acc, REASON_ACCELERATION, REASON_VELOCITY)

    moving = s_dot > 0.001
    one = torch.ones((), dtype=dtype, device=device)
    sv_safe = torch.where(moving, s_dot, one)
    dp_high = torch.where(moving, d_dot / sv_safe, zero)
    ddot = d_ddot - dp_high * s_ddot                        # Werling Eq. (A.8)
    dpp_high = torch.where(moving, ddot / (sv_safe * sv_safe), zero)
    dp = _select(low_vel, d_dot, dp_high)
    dpp = _select(low_vel, d_ddot, dpp_high)

    idx = frenet_ops.interp_index(ref, to_q(s))
    tv = frenet_ops.InterpValues(*(to_q(v) for v in
                                   frenet_ops.lookup_interp_values(ref, idx)))
    lam = (s - tv.s_lo) / (tv.s_hi - tv.s_lo)
    interp_theta = frenet_ops.wrap_two_pi(
        (tv.theta_hi - tv.theta_lo) * (s - tv.s_lo) / (tv.s_hi - tv.s_lo)
        + tv.theta_lo)

    # orientations (:841-873); standstill hold = theta_gl_move at the last
    # moving step <= i, else the initial orientation
    theta_cl_move = torch.atan2(dp, one.expand_as(dp))
    theta_gl_move = theta_cl_move + interp_theta
    use_move = moving | low_vel
    last_move = torch.cummax(
        torch.where(use_move, step_idx.expand(shape),
                    torch.full(shape, -1, dtype=torch.int64,
                               device=device)), dim=0).values
    held = torch.gather(theta_gl_move, 0, torch.clamp(last_move, min=0))
    theta_gl = torch.where(last_move >= 0, held, as_t(x0_orientation))
    theta_cl = torch.where(use_move, theta_cl_move, theta_gl - interp_theta)

    k_r = (tv.curv_hi - tv.curv_lo) * lam + tv.curv_lo
    k_r_d = (tv.curv_d_hi - tv.curv_d_lo) * lam + tv.curv_d_lo

    # global curvature, velocity, acceleration (Werling App. A; :883-896)
    one_krd = 1.0 - k_r * d
    cos_t = torch.cos(theta_cl)
    tan_t = torch.tan(theta_cl)
    q = cos_t / one_krd
    kappa_gl = ((dpp + (k_r * dp + k_r_d * d) * tan_t) * cos_t * (q * q)
                + q * k_r)
    v = s_dot * (one_krd / cos_t)
    a = (s_ddot * one_krd / cos_t + ((s_dot * s_dot) / cos_t) *
         (one_krd * tan_t * (kappa_gl * one_krd / cos_t - k_r) -
          (k_r_d * d + k_r * dp)))

    # constraint violations [T, (F,) K] in reference check order (:971-1017)
    false_tk = torch.zeros(shape, dtype=torch.bool, device=device)
    kappa_max = as_t(veh.kappa_max)
    vel_viol = v < -_EPS if check_velocity else false_tk
    kappa_viol = torch.abs(kappa_gl) > kappa_max if check_kappa else false_tk
    if check_yaw_rate:
        yaw_rate = _diff0(theta_gl) / dt
        yaw_r = torch.round(yaw_rate * 1e5) / 1e5
        yaw_viol = torch.abs(yaw_r) > kappa_max * v
    else:
        yaw_viol = false_tk
    if check_kappa_dot:
        wheelbase = as_t(veh.wheelbase)
        steering_angle = torch.atan2(wheelbase * kappa_gl,
                                     one.expand_as(kappa_gl))
        c = torch.cos(steering_angle)
        kappa_dot_max = as_t(veh.v_delta_max) / (wheelbase * (c * c))
        kd_viol = torch.abs(_diff0(kappa_gl) / dt) > kappa_dot_max
    else:
        kd_viol = false_tk
    if check_acceleration:
        a_max = as_t(veh.a_max)
        v_switch = as_t(veh.v_switch)
        fast = v > v_switch
        v_safe = torch.where(fast, v, one)
        a_hi = torch.where(fast, a_max * v_switch / v_safe, a_max)
        acc_viol = (a < -a_max) | (a > a_hi)
    else:
        acc_viol = false_tk

    # first failing (step, constraint): step-major, then the fixed order
    viol = torch.stack([vel_viol, kappa_viol, yaw_viol, kd_viol, acc_viol],
                       dim=1) & active[:, None]                # [T, 5, ...]
    viol_flat = viol.reshape((T * 5,) + batch_shape)
    any_viol = torch.any(viol_flat, dim=0)
    first_flat = torch.argmax(viol_flat.to(torch.uint8), dim=0)
    scan_reason = torch.where(any_viol, first_flat % 5, REASON_FEASIBLE)

    pad = lambda arr: torch.where(active, arr, zero)
    theta_cl, theta_gl, kappa_gl, v, a = (pad(arr) for arr in
                                          (theta_cl, theta_gl, kappa_gl, v, a))

    # Frenet -> Cartesian + lateral projection-domain limits (:908-917)
    x, y_pos, in_domain = (to_q(arr) for arr in
                           frenet_ops.to_cartesian(ref, to_q(s), to_q(d),
                                                   s_last))
    x = pad(x)
    y_pos = pad(y_pos)
    in_domain = in_domain & (one_krd > 0.0) & \
        (torch.abs(d) < PROJECTION_DOMAIN_LIMIT - _CLCS_EPS)
    domain_ok = torch.all(in_domain | ~active, dim=0)

    reason = torch.where(prefiltered, pre_reason, scan_reason)
    kin_feasible = ~prefiltered & ~any_viol
    reason = torch.where(kin_feasible & ~domain_ok, REASON_DOMAIN, reason)
    feasible = kin_feasible & domain_ok

    # kappa_dot = [0, diff(kappa_gl)] over the padded array, before enlarge
    kappa_dot = _diff0(kappa_gl)

    # ---- enlarge short candidates to N+1 steps (trajectories.py:168-332)
    ext = ~active
    last = torch.clamp(traj_len - 1, 0, T - 1)[None]
    take_last = lambda arr: torch.gather(arr, 0, last)       # [1, (F,) K]
    t_rel = (step_idx - (traj_len - 1)[None]).to(dtype) * dt

    a_last = take_last(a)
    v_temp = take_last(v) + t_rel * a_last
    v_temp = v_temp * (v_temp >= 0)
    theta_last = take_last(theta_gl)
    incr_x = torch.where(ext, dt * v_temp * torch.cos(theta_last), zero)
    incr_y = torch.where(ext, dt * v_temp * torch.sin(theta_last), zero)
    x = torch.where(ext, take_last(x) + torch.cumsum(incr_x, dim=0), x)
    y_pos = torch.where(ext, take_last(y_pos) + torch.cumsum(incr_y, dim=0),
                        y_pos)
    v = torch.where(ext, v_temp, v)
    a = torch.where(ext, a_last, a)
    theta_gl = torch.where(ext, theta_last, theta_gl)
    kappa_gl = torch.where(ext, take_last(kappa_gl), kappa_gl)
    kappa_dot = torch.where(ext, take_last(kappa_dot), kappa_dot)

    # curvilinear extension: constant velocities (zero-padded terminal
    # accelerations), s_dot clamped at zero
    s_dot_last = take_last(s_dot)
    s_dot_ext = s_dot_last * (s_dot_last >= 0)
    d_dot_last = take_last(d_dot)
    s = torch.where(ext, take_last(s) + t_rel * s_dot_last, s)
    d = torch.where(ext, take_last(d) + t_rel * d_dot_last, d)
    s_dot = torch.where(ext, s_dot_ext, s_dot)
    d_dot = torch.where(ext, d_dot_last, d_dot)
    s_ddot = torch.where(ext, take_last(s_ddot), s_ddot)
    d_ddot = torch.where(ext, take_last(d_ddot), d_ddot)
    theta_cl = torch.where(ext, take_last(theta_cl), theta_cl)

    out = [arr.movedim(0, -1) for arr in (s, s_dot, s_ddot, d, d_dot, d_ddot,
                                          theta_cl, x, y_pos, theta_gl, v, a,
                                          kappa_gl, kappa_dot)]
    return RolloutResult(*out, feasible=feasible,
                         reason=reason.to(torch.int32))
