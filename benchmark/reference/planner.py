"""The planning cycle in plain PyTorch: candidate grid, evaluation, choice.

For B problems at once (each with its own reference path, corridor,
obstacles and vehicle), in the dtype and on the device of the tensors it
is given:

* ``grid``: the fixed-interval terminal manifold of one sampling level
  (upstream ``sampling.py``): time samples from ``t_min`` to the horizon,
  target velocities on a 3, 5, 9, ... point ladder over ``[v_min, v_max]``,
  lateral targets on the same ladder over ``[d_min, d_max]`` together with
  the current offset; quartic longitudinal and quintic lateral polynomials
  (the lateral one over the travelled arclength in low-velocity mode);
* ``evaluate``: every candidate's states over the horizon (Frenet to
  Cartesian on the path tables, the Werling transform, the extension past
  the candidate's duration), the kinematic checks in the upstream order,
  the projection domain, the default cost, the corridor, and the
  rectangle and disc obstacles (separating axes at the ego box centre);
* ``select``: the first sampling level with a feasible, collision-free
  candidate, its cheapest candidate, and the rejection counts of that
  level.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

EPS = 1e-5
DOMAIN_D = 19.9


class Batch(NamedTuple):
    """B problems' scenes as tensors (tables padded to a common length with
    arclength sentinels 1e6 apart)."""

    s: torch.Tensor          # [B, P]
    theta: torch.Tensor      # [B, P]
    curv: torch.Tensor       # [B, P]
    curv_d: torch.Tensor     # [B, P]
    points: torch.Tensor     # [B, P, 2]
    tangent: torch.Tensor    # [B, P, 2]
    normal: torch.Tensor     # [B, P, 2]
    band_lo: torch.Tensor    # [B, P]
    band_hi: torch.Tensor    # [B, P]
    s_last: torch.Tensor     # [B] true path length
    obs_pose: torch.Tensor   # [B, M, S, 3]
    obs_half: torch.Tensor   # [B, M, 2]
    obs_valid: torch.Tensor  # [B, M, S] bool
    obs_radius: torch.Tensor  # [B, M]
    veh: torch.Tensor        # [B, 8]: wheelbase, wb_rear, a_max, v_switch,
    #                          kappa_max, v_delta_max, half_len, half_wid


def make_batch(scenes, dtype, device) -> Batch:
    """Stack host scenes (dicts of ``tables``, ``band``, ``obstacles``,
    ``veh``) into a :class:`Batch`."""
    P = max(len(sc["tables"].s) for sc in scenes)
    M = max(max(len(sc["obstacles"].radius), 1) for sc in scenes)
    S = max(sc["obstacles"].valid.shape[1] for sc in scenes)
    cols = {k: [] for k in Batch._fields}
    for sc in scenes:
        tab = sc["tables"]
        n, pad = len(tab.s), P - len(tab.s)
        rep = lambda a: np.concatenate([a, np.repeat(a[-1:], pad, axis=0)])
        cols["s"].append(np.concatenate(
            [tab.s, tab.s[-1] + np.arange(1, pad + 1) * 1e6]))
        cols["points"].append(np.concatenate([tab.points, tab.points[-1] + np.outer(
            np.arange(1, pad + 1) * 1e6, tab.tangent[-1])]))
        for k in ("theta", "curv", "curv_d", "tangent", "normal"):
            cols[k].append(rep(getattr(tab, k)))
        lo, hi = sc["band"]
        cols["band_lo"].append(np.concatenate([lo, np.full(pad, -1e4)]))
        cols["band_hi"].append(np.concatenate([hi, np.full(pad, 1e4)]))
        cols["s_last"].append(tab.s[n - 1])
        ob = sc["obstacles"]
        m, s_ = len(ob.radius), ob.valid.shape[1]
        pose = np.zeros((M, S, 3))
        half = np.ones((M, 2))
        valid = np.zeros((M, S), dtype=bool)
        radius = np.zeros(M)
        pose[:m, :s_], half[:m], valid[:m, :s_], radius[:m] = \
            ob.pose, ob.half, ob.valid, ob.radius
        cols["obs_pose"].append(pose)
        cols["obs_half"].append(half)
        cols["obs_valid"].append(valid)
        cols["obs_radius"].append(radius)
        cols["veh"].append(np.asarray(sc["veh"], dtype=np.float64))
    up = lambda k: torch.as_tensor(np.stack(cols[k]), device=device,
                                   dtype=torch.bool if k == "obs_valid"
                                   else dtype)
    return Batch(*(up(k) for k in Batch._fields))


def vehicle_row(vehicle: dict):
    """The [8] vehicle row from a configuration's vehicle parameters."""
    wheelbase = vehicle["a"] + vehicle["b"]
    return [wheelbase, vehicle["b"], vehicle["a_max"], vehicle["v_switch"],
            np.tan(vehicle["delta_max"]) / wheelbase, vehicle["v_delta_max"],
            0.5 * vehicle["l"], 0.5 * vehicle["w"]]


# ---------------------------------------------------------------------------
# the candidate grid
# ---------------------------------------------------------------------------

def time_samples(t_min: float, horizon: float, dt: float, level: int):
    step = int((1 / (level + 1)) / dt)
    limit = round(horizon + dt, 2)
    samples = np.arange(t_min, limit, step * dt)
    return np.unique(samples[samples != limit])


def ladder(n_level: int) -> int:
    n = 3
    for _ in range(n_level):
        n = 2 * n - 1
    return n


def traj_len(t: np.ndarray, dt: float) -> np.ndarray:
    return np.ceil(np.round(t + dt, 5) / dt).astype(np.int64)


def _poly(c, tau):
    t2 = tau * tau
    t3 = t2 * tau
    t4 = t2 * t2
    t5 = t4 * tau
    p = c[..., 0] + c[..., 1] * tau + c[..., 2] * t2 + c[..., 3] * t3 + \
        c[..., 4] * t4 + c[..., 5] * t5
    v = c[..., 1] + 2.0 * c[..., 2] * tau + 3.0 * c[..., 3] * t2 + \
        4.0 * c[..., 4] * t3 + 5.0 * c[..., 5] * t4
    a = 2.0 * c[..., 2] + 6.0 * c[..., 3] * tau + 12.0 * c[..., 4] * t2 + \
        20.0 * c[..., 5] * t3
    return p, v, a


def grid(x0_lon, x0_lat, v_min, v_max, low_vel, sampling: dict, level: int,
         dt: float, horizon: float, unique_d: bool):
    """One level's candidates for B problems: (coeffs_lon [B, K, 6],
    coeffs_lat [B, K, 6], traj_len [B, K]).  ``x0_lon``/``x0_lat`` [B, 3],
    ``v_min``/``v_max``/``low_vel`` [B] tensors.  ``unique_d`` merges the
    current offset into the lateral samples (one problem only, B = 1);
    otherwise it is appended to every problem's samples."""
    dtype, device = x0_lon.dtype, x0_lon.device
    B = x0_lon.shape[0]
    ts = time_samples(sampling["t_min"], horizon, dt, level)
    n = ladder(level)
    d_base = np.unique(np.linspace(sampling["d_min"], sampling["d_max"], n))
    if unique_d:
        if B != 1:
            raise ValueError("unique_d takes one problem")
        d_vals = torch.as_tensor(np.unique(np.concatenate(
            [d_base, [float(x0_lat[0, 0])]])), dtype=dtype,
            device=device)[None]
    else:
        d_vals = torch.cat([torch.as_tensor(d_base, dtype=dtype,
                                            device=device).expand(B, -1),
                            x0_lat[:, :1]], dim=1)
    frac = torch.arange(n, dtype=dtype, device=device) / (n - 1)
    v_vals = v_min[:, None] * (1 - frac) + v_max[:, None] * frac
    v_vals[:, -1] = v_max
    Nt, Nv, Nd = len(ts), n, d_vals.shape[1]
    shape = (B, Nt, Nv, Nd)
    T = torch.as_tensor(ts, dtype=dtype, device=device)[None, :, None, None] \
        .expand(shape)
    V = v_vals[:, None, :, None].expand(shape)
    D = d_vals[:, None, None, :].expand(shape)
    bc = lambda x: x.reshape(B, 1, 1, 1)
    p0, v0, a0 = (bc(x0_lon[:, i]) for i in range(3))
    T2, T3 = T * T, T * T * T
    dv = V - v0 - a0 * T
    c3 = dv / T2 + a0 / (3.0 * T)
    c4 = -a0 / (4.0 * T2) - dv / (2.0 * T3)
    zero = torch.zeros_like(c3)
    cl = torch.stack([p0.expand(shape), v0.expand(shape),
                      (0.5 * a0).expand(shape), c3, c4, zero], dim=-1)
    s_goal = _poly(cl, T)[0] - p0
    tau = torch.where(bc(low_vel) & (s_goal > 0), s_goal, T)
    q0, q1, q2 = (bc(x0_lat[:, i]) for i in range(3))
    t2, t3 = tau * tau, tau * tau * tau
    dp = D - (q0 + q1 * tau + 0.5 * q2 * t2)
    dvl = -(q1 + q2 * tau) * tau
    da = -q2 * t2
    ca = torch.stack([q0.expand(shape), q1.expand(shape),
                      (0.5 * q2).expand(shape),
                      (10.0 * dp - 4.0 * dvl + 0.5 * da) / t3,
                      (-15.0 * dp + 7.0 * dvl - da) / (t3 * tau),
                      (6.0 * dp - 3.0 * dvl + 0.5 * da) / (t3 * t2)], dim=-1)
    tl = torch.as_tensor(traj_len(ts, dt), device=device)[None, :, None, None]
    K = Nt * Nv * Nd
    return (cl.reshape(B, K, 6), ca.reshape(B, K, 6),
            tl.expand(shape).reshape(B, K))


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------

def _rows(table, idx):
    """table [B, P, ...] at per-problem indices idx [T, B, K]."""
    b = torch.arange(table.shape[0], device=idx.device)[None, :, None]
    return table[b, idx]


def evaluate(batch: Batch, cl, ca, tl, x0_theta, low_vel, time_step,
             desired_v, dt: float, n_steps: int, w_a: float = 5.0,
             desired_d: float = 0.0):
    """(masked [B, K], kin [B, K], states {field: [B, K, T]}): the cost of
    each feasible, collision-free candidate (+inf otherwise), the cost of
    each kinematically feasible, in-domain candidate (+inf otherwise), and
    every candidate's states, with ``states['cost']`` [B, K] every
    candidate's cost whatever its feasibility.  ``x0_theta``, ``low_vel``, ``time_step``
    (int), ``desired_v``: [B]."""
    dtype, device = cl.dtype, cl.device
    B, K = cl.shape[:2]
    T = n_steps + 1
    P = batch.s.shape[1]
    zero = torch.zeros((), dtype=dtype, device=device)
    one = torch.ones((), dtype=dtype, device=device)
    inf = torch.full((), np.inf, dtype=dtype, device=device)
    col = lambda x: x.reshape(1, B, 1)                       # [1, B, 1]
    veh = [col(batch.veh[:, i]) for i in range(8)]
    wheelbase, wb_rear, a_max, v_switch, kappa_max, v_delta_max, hl, hw = veh
    step = torch.arange(T, device=device).reshape(T, 1, 1)
    active = step < tl[None]
    t = step.to(dtype) * dt
    lv = col(low_vel)

    s, s_dot, s_ddot = (torch.where(active, x, zero)
                        for x in _poly(cl[None], t))
    tau = torch.where(active, torch.where(lv, s - s[:1], t), zero)
    d, d_dot, d_ddot = (torch.where(active, x, zero)
                        for x in _poly(ca[None], tau))
    s_dot = torch.where(torch.abs(s_dot) < EPS, zero, s_dot)
    d_dot = torch.where(torch.abs(d_dot) < EPS, zero, d_dot)
    pre_filtered = torch.any(torch.abs(s_ddot) > a_max, dim=0) | \
        torch.any(s_dot < -EPS, dim=0)

    s_col = batch.s.contiguous()

    def row_index(q):
        flat = q.permute(1, 0, 2).reshape(B, -1).contiguous()
        idx = torch.searchsorted(s_col, flat, right=True) - 1
        return idx.reshape(B, T, K).permute(1, 0, 2)

    q = torch.where(active, s, batch.s[:, :1].reshape(1, B, 1))
    idx = torch.clamp(row_index(q), 0, P - 2)
    s_lo, s_hi = _rows(batch.s, idx), _rows(batch.s, idx + 1)
    lam = (s - s_lo) / (s_hi - s_lo)
    th_lo, th_hi = _rows(batch.theta, idx), _rows(batch.theta, idx + 1)
    raw = (th_hi - th_lo) * lam + th_lo
    two_pi = 2.0 * np.pi
    interp_theta = raw - two_pi * torch.trunc(raw / two_pi)
    k_r = (_rows(batch.curv, idx + 1) - _rows(batch.curv, idx)) * lam + \
        _rows(batch.curv, idx)
    k_r_d = (_rows(batch.curv_d, idx + 1) - _rows(batch.curv_d, idx)) * \
        lam + _rows(batch.curv_d, idx)
    pt, tg, nm = (_rows(batch.points, idx), _rows(batch.tangent, idx),
                  _rows(batch.normal, idx))
    ds = s - s_lo
    x = pt[..., 0] + ds * tg[..., 0] + d * nm[..., 0]
    y = pt[..., 1] + ds * tg[..., 1] + d * nm[..., 1]

    moving = s_dot > 0.001
    sv = torch.where(moving, s_dot, one)
    dp_high = torch.where(moving, d_dot / sv, zero)
    dpp_high = torch.where(moving, (d_ddot - dp_high * s_ddot) / (sv * sv),
                           zero)
    dp = torch.where(lv, d_dot, dp_high)
    dpp = torch.where(lv, d_ddot, dpp_high)
    theta_cl_move = torch.atan2(dp, one.expand_as(dp))
    theta_gl_move = theta_cl_move + interp_theta
    use_move = moving | lv
    held, last = [], col(x0_theta).expand(1, B, K)[0]
    for c in range(T):
        last = torch.where(use_move[c], theta_gl_move[c], last)
        held.append(last)
    theta_gl = torch.stack(held)
    theta_cl = torch.where(use_move, theta_cl_move, theta_gl - interp_theta)

    one_krd = 1.0 - k_r * d
    cos_t, tan_t = torch.cos(theta_cl), torch.tan(theta_cl)
    qc = cos_t / one_krd
    kappa_gl = (dpp + (k_r * dp + k_r_d * d) * tan_t) * cos_t * (qc * qc) + \
        qc * k_r
    v = s_dot * (one_krd / cos_t)
    a = (s_ddot * one_krd / cos_t + ((s_dot * s_dot) / cos_t) *
         (one_krd * tan_t * (kappa_gl * one_krd / cos_t - k_r) -
          (k_r_d * d + k_r * dp)))

    first = step == 0
    prev = lambda arr: torch.cat([arr[:1], arr[:-1]], dim=0)
    yaw = torch.where(first, zero, (theta_gl - prev(theta_gl)) / dt)
    yaw = torch.round(yaw * 1e5) / 1e5
    steer = torch.atan2(wheelbase * kappa_gl, one.expand_as(kappa_gl))
    kd_max = v_delta_max / (wheelbase * torch.cos(steer) ** 2)
    kd = torch.where(first, zero, (kappa_gl - prev(kappa_gl)) / dt)
    fast = v > v_switch
    a_hi = torch.where(fast, a_max * v_switch / torch.where(fast, v, one),
                       a_max)
    violation = ((v < -EPS) | (torch.abs(kappa_gl) > kappa_max)
                 | (torch.abs(yaw) > kappa_max * v) | (torch.abs(kd) > kd_max)
                 | (a < -a_max) | (a > a_hi)) & active
    s_last = col(batch.s_last)
    in_domain = (s >= 0.0) & (s <= s_last) & (one_krd > 0.0) & \
        (torch.abs(d) < DOMAIN_D)
    feasible = ~pre_filtered & ~torch.any(violation, dim=0) & \
        torch.all(in_domain | ~active, dim=0)

    # constant acceleration past the candidate's duration
    ext = ~active
    last_i = (tl - 1)[None]
    take_last = lambda arr: torch.gather(arr, 0, last_i)
    t_rel = (step - last_i).to(dtype) * dt
    a_last = take_last(a)
    v_ext = take_last(v) + t_rel * a_last
    v_ext = v_ext * (v_ext >= 0)
    th_last = take_last(theta_gl)
    inc_x = torch.where(ext, dt * v_ext * torch.cos(th_last), zero)
    inc_y = torch.where(ext, dt * v_ext * torch.sin(th_last), zero)
    x = torch.where(ext, take_last(x) + torch.cumsum(inc_x, 0), x)
    y = torch.where(ext, take_last(y) + torch.cumsum(inc_y, 0), y)
    v = torch.where(ext, v_ext, v)
    a = torch.where(ext, a_last, a)
    theta_gl = torch.where(ext, th_last, theta_gl)
    theta_cl = torch.where(ext, take_last(theta_cl), theta_cl)
    kappa_gl = torch.where(ext, take_last(kappa_gl), kappa_gl)
    sd_last, dd_last = take_last(s_dot), take_last(d_dot)
    s = torch.where(ext, take_last(s) + t_rel * sd_last, s)
    d = torch.where(ext, take_last(d) + t_rel * dd_last, d)
    s_dot = torch.where(ext, sd_last * (sd_last >= 0), s_dot)
    d_dot = torch.where(ext, dd_last, d_dot)
    s_ddot = torch.where(ext, take_last(s_ddot), s_ddot)
    d_ddot = torch.where(ext, take_last(d_ddot), d_ddot)

    # the default cost (upstream cost_function.py)
    dv_ = col(desired_v)
    cost = torch.sum((w_a * a) ** 2, dim=0) + \
        torch.sum((5.0 * (v - dv_)) ** 2, dim=0) + \
        50.0 * (v[T - 1] - dv_[0]) ** 2 + 100.0 * (v[T // 2] - dv_[0]) ** 2 + \
        torch.sum((0.25 * (desired_d - d)) ** 2, dim=0) + \
        (20.0 * (desired_d - d[T - 1])) ** 2 + \
        torch.sum((0.25 * torch.abs(theta_cl)) ** 2, dim=0) + \
        (5.0 * torch.abs(theta_cl[T - 1])) ** 2

    # corridor: the ego box's lateral extent at three stations
    cos_cl, sin_cl = torch.cos(theta_cl), torch.sin(theta_cl)
    s_c = s + wb_rear * cos_cl
    d_c = d + wb_rear * sin_cl
    lat = hw * torch.abs(cos_cl) + hl * torch.abs(sin_cl)
    lon = hl * torch.abs(cos_cl) + hw * torch.abs(sin_cl)
    collides = torch.zeros((B, K), dtype=torch.bool, device=device)
    for probe in (s_c - lon, s_c, s_c + lon):
        bi = row_index(torch.minimum(torch.clamp(probe, min=0.0), s_last))
        ok = bi >= 0
        lo = torch.where(ok, _rows(batch.band_lo, torch.clamp(bi, min=0)),
                         zero)
        hi = torch.where(ok, _rows(batch.band_hi, torch.clamp(bi, min=0)),
                         zero)
        collides |= torch.any((d_c + lat > hi) | (d_c - lat < lo), dim=0)

    # obstacles at scenario steps time_step + i
    e_cos, e_sin = torch.cos(theta_gl), torch.sin(theta_gl)
    ecx, ecy = x + wb_rear * e_cos, y + wb_rear * e_sin
    S = batch.obs_valid.shape[2]
    steps = time_step.reshape(B, 1).to(torch.int64) + \
        torch.arange(T, device=device)[None]                 # [B, T]
    in_span = steps < S
    steps = torch.clamp(steps, max=S - 1)
    b_idx = torch.arange(B, device=device)[:, None]
    for m in range(batch.obs_pose.shape[1]):
        pose = batch.obs_pose[b_idx, m, steps].permute(1, 0, 2)  # [T, B, 3]
        valid = (batch.obs_valid[b_idx, m, steps] & in_span).T[..., None]
        ox, oy, oth = (pose[..., i:i + 1] for i in range(3))
        ohl = batch.obs_half[:, m, 0].reshape(1, B, 1)
        ohw = batch.obs_half[:, m, 1].reshape(1, B, 1)
        radius = batch.obs_radius[:, m].reshape(1, B, 1)
        o_cos, o_sin = torch.cos(oth), torch.sin(oth)
        dx, dy = ox - ecx, oy - ecy
        rc = torch.abs(e_cos * o_cos + e_sin * o_sin)
        rs = torch.abs(o_sin * e_cos - o_cos * e_sin)
        lx = torch.abs(dx * e_cos + dy * e_sin)
        ly = torch.abs(-dx * e_sin + dy * e_cos)
        sep = (lx > hl + ohl * rc + ohw * rs) | \
            (ly > hw + ohl * rs + ohw * rc) | \
            (torch.abs(dx * o_cos + dy * o_sin) > ohl + hl * rc + hw * rs) | \
            (torch.abs(-dx * o_sin + dy * o_cos) > ohw + hl * rs + hw * rc)
        qx = torch.clamp(lx - hl, min=0.0)
        qy = torch.clamp(ly - hw, min=0.0)
        disc = radius > 0.0
        hit = torch.where(disc, qx * qx + qy * qy <= radius * radius, ~sep)
        collides |= torch.any(valid & hit, dim=0)

    kin = torch.where(feasible, cost, inf)
    masked = torch.where(collides, inf, kin)
    states = dict(s=s, s_dot=s_dot, s_ddot=s_ddot, d=d, d_dot=d_dot,
                  d_ddot=d_ddot, x=x, y=y, theta_gl=theta_gl,
                  theta_cl=theta_cl, v=v, a=a, kappa_gl=kappa_gl)
    states = {k: arr.permute(1, 2, 0) for k, arr in states.items()}
    states["cost"] = cost
    return masked, kin, states


def select(masked, kin, level_ids, n_levels: int):
    """Level escalation over a union of levels, per problem: (found [B],
    best index [B], best cost [B], selected level [B], kinematically
    infeasible count [B], colliding count [B]).  Counts are of the selected
    level (the last one when nothing is found); the colliding count takes
    only candidates cheaper than the winner when one is found."""
    inf = torch.full((), np.inf, dtype=masked.dtype, device=masked.device)
    B = masked.shape[0]
    found_lv, best_lv = [], []
    for level in range(n_levels):
        cost, idx = torch.min(torch.where(level_ids[None] == level, masked,
                                          inf), dim=1)
        found_lv.append(torch.isfinite(cost))
        best_lv.append(idx)
    found_lv = torch.stack(found_lv, dim=1)                  # [B, L]
    found = torch.any(found_lv, dim=1)
    level = torch.where(found, torch.argmax(found_lv.to(torch.uint8), dim=1),
                        torch.full((B,), n_levels - 1, device=masked.device))
    best = torch.gather(torch.stack(best_lv, dim=1), 1, level[:, None])[:, 0]
    best_cost = torch.where(found, torch.gather(masked, 1, best[:, None])[:, 0],
                            inf)
    in_level = level_ids[None] == level[:, None]
    kin_inf = torch.isinf(kin)
    n_kin = torch.sum(kin_inf & in_level, dim=1)
    colliding = ~kin_inf & torch.isinf(masked) & in_level
    n_coll = torch.where(found, torch.sum(colliding & (kin < best_cost[:, None]),
                                          dim=1), torch.sum(colliding, dim=1))
    return found, best, best_cost, level, n_kin, n_coll
