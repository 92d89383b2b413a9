"""Pure-numpy conformance oracle: the reference algorithm, per candidate.

Counterpart of ``commonroad_rp_tpu/baseline/oracle.py``: the SEMANTICS of the
reference's planning cycle (reference:
commonroad_rp/reactive_planner.py:715-1063) as straight-line numpy with
per-candidate Python loops -- the same computational shape as the reference
(scalar per-step hot loop, per-candidate polynomial evaluation).  The
correctness oracle of the port's rollout and cost: the batched float64
``ops.kinematics.rollout`` and default cost must give the same feasibility
decisions and reasons, matching state arrays and costs, and the same argmin.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from commonroad_rp_tpu_torch.models.sampling import CandidateBatch
from commonroad_rp_tpu_torch.utils.geometry import interpolate_angle

_EPS = 1e-5


@dataclass
class OracleRefPath:
    """Numpy float64 reference-path tables (mirror of
    ops.frenet.RefPathTables)."""

    points: np.ndarray
    s: np.ndarray
    theta: np.ndarray
    curv: np.ndarray
    curv_d: np.ndarray
    tangent: np.ndarray
    normal: np.ndarray

    @classmethod
    def from_tables(cls, tables) -> "OracleRefPath":
        """From the port's ``RefPathTables`` (tensors on any device)."""
        host = lambda t: t.detach().cpu().to(torch.float64).numpy()
        return cls(points=host(tables.points), s=host(tables.s),
                   theta=host(tables.theta), curv=host(tables.curv),
                   curv_d=host(tables.curv_d), tangent=host(tables.tangent),
                   normal=host(tables.normal))

    def to_cartesian(self, s: float, d: float):
        """Segment-interpolated (s, d) -> (x, y); None outside the domain
        (mirror of ops.frenet.to_cartesian / the C++ conversion failure)."""
        if s < self.s[0] or s > self.s[-1]:
            return None
        seg = min(max(int(np.searchsorted(self.s, s, side="right")) - 1, 0),
                  len(self.s) - 2)
        ds = s - self.s[seg]
        return (self.points[seg] + ds * self.tangent[seg] + d * self.normal[seg])


@dataclass
class OracleVehicle:
    wheelbase: float
    wb_rear_axle: float
    a_max: float
    v_switch: float
    kappa_max: float
    v_delta_max: float
    half_length: float
    half_width: float


@dataclass
class OracleCandidate:
    """Evaluated candidate (feasible ones carry full state arrays)."""

    index: int
    feasible: bool
    reason: Optional[str]                 # constraint name, "domain", or None
    arrays: Optional[Dict[str, np.ndarray]] = None
    cost: float = np.inf


def _eval_poly(c, t, t2, t3, t4, t5):
    return c[0] + c[1] * t + c[2] * t2 + c[3] * t3 + c[4] * t4 + c[5] * t5


def _eval_vel(c, t, t2, t3, t4):
    return c[1] + 2.0 * c[2] * t + 3.0 * c[3] * t2 + 4.0 * c[4] * t3 + 5.0 * c[5] * t4


def _eval_acc(c, t, t2, t3):
    return 2.0 * c[2] + 6.0 * c[3] * t + 12.0 * c[4] * t2 + 20.0 * c[5] * t3


def check_kinematics_one(c_lon: np.ndarray, c_lat: np.ndarray, traj_len: int,
                         ref: OracleRefPath, veh: OracleVehicle,
                         x0_orientation: float, dt: float, n_steps: int,
                         low_vel_mode: bool,
                         constraints: List[str]) -> OracleCandidate:
    """One candidate through the reference's kinematic pipeline
    (reactive_planner.py:731-960), returning arrays matching CartesianSample/
    CurviLinearSample after ``enlarge``."""
    T = n_steps + 1
    t = np.arange(traj_len) * dt
    t2, t3 = t * t, t**3
    t4, t5 = t2 * t2, t2 * t3

    s = np.zeros(T)
    s_dot = np.zeros(T)
    s_ddot = np.zeros(T)
    d = np.zeros(T)
    d_dot = np.zeros(T)
    d_ddot = np.zeros(T)

    s[:traj_len] = _eval_poly(c_lon, t, t2, t3, t4, t5)
    s_dot[:traj_len] = _eval_vel(c_lon, t, t2, t3, t4)
    s_ddot[:traj_len] = _eval_acc(c_lon, t, t2, t3)

    if not low_vel_mode:
        d[:traj_len] = _eval_poly(c_lat, t, t2, t3, t4, t5)
        d_dot[:traj_len] = _eval_vel(c_lat, t, t2, t3, t4)
        d_ddot[:traj_len] = _eval_acc(c_lat, t, t2, t3)
    else:
        s1 = s[:traj_len] - s[0]
        s2, s3 = s1 * s1, s1**3
        s4, s5 = s2 * s2, s2 * s3
        d[:traj_len] = _eval_poly(c_lat, s1, s2, s3, s4, s5)
        d_dot[:traj_len] = _eval_vel(c_lat, s1, s2, s3, s4)
        d_ddot[:traj_len] = _eval_acc(c_lat, s1, s2, s3)

    s_dot[np.abs(s_dot) < _EPS] = 0.0
    d_dot[np.abs(d_dot) < _EPS] = 0.0

    # pre-filter (reactive_planner.py:796-805)
    if np.any(np.abs(s_ddot) > veh.a_max):
        return OracleCandidate(-1, False, "acceleration")
    if np.any(s_dot < -_EPS):
        return OracleCandidate(-1, False, "velocity")

    x = np.zeros(T)
    y = np.zeros(T)
    v = np.zeros(T)
    a = np.zeros(T)
    theta_gl = np.zeros(T)
    theta_cl = np.zeros(T)
    kappa_gl = np.zeros(T)
    k_r_steps = np.zeros(T)

    ref_pos, ref_theta = ref.s, ref.theta
    ref_curv, ref_curv_d = ref.curv, ref.curv_d

    for i in range(traj_len):
        if not low_vel_mode:
            dp = d_dot[i] / s_dot[i] if s_dot[i] > 0.001 else 0.0
            ddot = d_ddot[i] - dp * s_ddot[i]
            dpp = ddot / (s_dot[i] ** 2) if s_dot[i] > 0.001 else 0.0
        else:
            dp = d_dot[i]
            dpp = d_ddot[i]

        s_idx = int(np.argmax(ref_pos > s[i])) - 1
        s_lambda = (s[i] - ref_pos[s_idx]) / (ref_pos[s_idx + 1] - ref_pos[s_idx])

        if s_dot[i] > 0.001:
            theta_cl[i] = np.arctan2(dp, 1.0)
            theta_gl[i] = theta_cl[i] + interpolate_angle(
                s[i], ref_pos[s_idx], ref_pos[s_idx + 1],
                ref_theta[s_idx], ref_theta[s_idx + 1])
        else:
            if low_vel_mode:
                theta_cl[i] = np.arctan2(dp, 1.0)
                theta_gl[i] = theta_cl[i] + interpolate_angle(
                    s[i], ref_pos[s_idx], ref_pos[s_idx + 1],
                    ref_theta[s_idx], ref_theta[s_idx + 1])
            else:
                theta_gl[i] = x0_orientation if i == 0 else theta_gl[i - 1]
                theta_cl[i] = theta_gl[i] - interpolate_angle(
                    s[i], ref_pos[s_idx], ref_pos[s_idx + 1],
                    ref_theta[s_idx], ref_theta[s_idx + 1])

        k_r = (ref_curv[s_idx + 1] - ref_curv[s_idx]) * s_lambda + ref_curv[s_idx]
        k_r_d = (ref_curv_d[s_idx + 1] - ref_curv_d[s_idx]) * s_lambda + ref_curv_d[s_idx]
        k_r_steps[i] = k_r

        one_krd = 1.0 - k_r * d[i]
        cos_t = np.cos(theta_cl[i])
        tan_t = np.tan(theta_cl[i])
        kappa_gl[i] = ((dpp + (k_r * dp + k_r_d * d[i]) * tan_t) * cos_t *
                       (cos_t / one_krd) ** 2 + (cos_t / one_krd) * k_r)
        v[i] = s_dot[i] * (one_krd / cos_t)
        a[i] = (s_ddot[i] * one_krd / cos_t + ((s_dot[i] ** 2) / cos_t) *
                (one_krd * tan_t * (kappa_gl[i] * one_krd / cos_t - k_r) -
                 (k_r_d * d[i] + k_r * dp)))

        # constraints in reference order (reactive_planner.py:971-1017)
        if "velocity" in constraints and v[i] < -_EPS:
            return OracleCandidate(-1, False, "velocity")
        if "kappa" in constraints and abs(kappa_gl[i]) > veh.kappa_max:
            return OracleCandidate(-1, False, "kappa")
        if "yaw_rate" in constraints:
            yaw_rate = (theta_gl[i] - theta_gl[i - 1]) / dt if i > 0 else 0.0
            if abs(round(yaw_rate, 5)) > veh.kappa_max * v[i]:
                return OracleCandidate(-1, False, "yaw_rate")
        if "kappa_dot" in constraints:
            steering = np.arctan2(veh.wheelbase * kappa_gl[i], 1.0)
            kd_max = veh.v_delta_max / (veh.wheelbase * np.cos(steering) ** 2)
            kd = (kappa_gl[i] - kappa_gl[i - 1]) / dt if i > 0 else 0.0
            if abs(kd) > kd_max:
                return OracleCandidate(-1, False, "kappa_dot")
        if "acceleration" in constraints:
            a_hi = (veh.a_max * veh.v_switch / v[i] if v[i] > veh.v_switch
                    else veh.a_max)
            if not (-veh.a_max <= a[i] <= a_hi):
                return OracleCandidate(-1, False, "acceleration")

    for i in range(traj_len):
        # lateral projection-domain limits of the C++ CLCS (normals crossing
        # at 1 - kappa_r*d <= 0, default 20 m cap minus eps): conversion
        # throws there -> candidate domain-infeasible (:908-917)
        if 1.0 - k_r_steps[i] * d[i] <= 0.0 or abs(d[i]) >= 19.9:
            return OracleCandidate(-1, False, "domain")
        pos = ref.to_cartesian(s[i], d[i])
        if pos is None:
            return OracleCandidate(-1, False, "domain")
        x[i], y[i] = pos

    kappa_dot = np.append([0], np.diff(kappa_gl))

    # enlarge (trajectories.py:168-197 Cartesian, :302-332 curvilinear)
    if traj_len < T:
        last = traj_len - 1
        steps = T - traj_len
        te = np.arange(1, steps + 1) * dt
        a[traj_len:] = a[last]
        v_temp = v[last] + te * a[-1]
        v_temp = v_temp * (v_temp >= 0)
        v[traj_len:] = v_temp
        theta_gl[traj_len:] = theta_gl[last]
        kappa_gl[traj_len:] = kappa_gl[last]
        kappa_dot[traj_len:] = kappa_dot[last]
        x[traj_len:] = x[last] + np.cumsum(dt * v_temp * np.cos(theta_gl[last]))
        y[traj_len:] = y[last] + np.cumsum(dt * v_temp * np.sin(theta_gl[last]))

        s_dot_temp = s_dot[last] + te * s_ddot[-1]
        s_dot_temp = s_dot_temp * (s_dot_temp >= 0)
        d_dot_temp = d_dot[last] + te * d_ddot[-1]
        s[traj_len:] = s[last] + te * s_dot[last]
        d[traj_len:] = d[last] + te * d_dot[last]
        s_dot[traj_len:] = s_dot_temp
        d_dot[traj_len:] = d_dot_temp
        s_ddot[traj_len:] = s_ddot[last]
        d_ddot[traj_len:] = d_ddot[last]
        theta_cl[traj_len:] = theta_cl[last]

    arrays = dict(x=x, y=y, theta_gl=theta_gl, theta_cl=theta_cl, v=v, a=a,
                  kappa_gl=kappa_gl, kappa_dot=kappa_dot, s=s, s_dot=s_dot,
                  s_ddot=s_ddot, d=d, d_dot=d_dot, d_ddot=d_ddot)
    return OracleCandidate(-1, True, None, arrays=arrays)


def default_cost_one(arr: Dict[str, np.ndarray], w_a: float, desired_d: float,
                     desired_speed: Optional[float],
                     desired_s: Optional[float]) -> float:
    """Per-candidate DefaultCostFunction (cost_function.py:51-71)."""
    v, a = arr["v"], arr["a"]
    costs = float(np.sum((w_a * a) ** 2))
    if desired_speed is not None:
        costs += float(np.sum((5 * (v - desired_speed)) ** 2) +
                       50 * (v[-1] - desired_speed) ** 2 +
                       100 * (v[int(len(v) / 2)] - desired_speed) ** 2)
    if desired_s is not None:
        costs += float(np.sum((0.25 * (desired_s - arr["s"])) ** 2) +
                       (20 * (desired_s - arr["s"][-1])) ** 2)
    costs += float(np.sum((0.25 * (desired_d - arr["d"])) ** 2) +
                   (20 * (desired_d - arr["d"][-1])) ** 2)
    costs += float(np.sum((0.25 * np.abs(arr["theta_cl"])) ** 2) +
                   (5 * np.abs(arr["theta_cl"][-1])) ** 2)
    return costs


def evaluate_batch(batch: CandidateBatch, ref: OracleRefPath, veh: OracleVehicle,
                   x0_orientation: float, dt: float, n_steps: int,
                   low_vel_mode: bool, constraints: List[str],
                   w_a: float = 5.0, desired_d: float = 0.0,
                   desired_speed: Optional[float] = None,
                   desired_s: Optional[float] = None) -> List[OracleCandidate]:
    """Run every candidate through kinematics + cost (no collision)."""
    out: List[OracleCandidate] = []
    for k in range(batch.size):
        cand = check_kinematics_one(batch.coeffs_lon[k], batch.coeffs_lat[k],
                                    int(batch.traj_len[k]), ref, veh,
                                    x0_orientation, dt, n_steps, low_vel_mode,
                                    constraints)
        cand.index = k
        if cand.feasible:
            cand.cost = default_cost_one(cand.arrays, w_a, desired_d,
                                         desired_speed, desired_s)
        out.append(cand)
    return out
