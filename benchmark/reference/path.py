"""Reference-path preparation and Frenet tables (host NumPy, float64).

The curvilinear frame of the upstream planner
(``utility/utils_coordinate_system.py``): duplicate vertices dropped, a
cubic B-spline through the vertices sampled at 200 points and resampled at
1 m, duplicates dropped again, the path extended 5 m behind its start; then
arclength, unwrapped heading, curvature and its derivative, unit tangents
and left normals per vertex.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np


class Tables(NamedTuple):
    points: np.ndarray      # [P, 2]
    s: np.ndarray           # [P]
    theta: np.ndarray       # [P] unwrapped
    curv: np.ndarray        # [P]
    curv_d: np.ndarray      # [P]
    tangent: np.ndarray     # [P, 2]
    normal: np.ndarray      # [P, 2]


def _dedup(poly: np.ndarray) -> np.ndarray:
    _, idx = np.unique(poly, axis=0, return_index=True)
    return poly[np.sort(idx)]


def _pathlength(poly: np.ndarray) -> np.ndarray:
    seg = np.linalg.norm(np.diff(poly, axis=0), axis=1)
    return np.concatenate(([0.0], np.cumsum(seg)))


def _resample(poly: np.ndarray, step: float) -> np.ndarray:
    s = _pathlength(poly)
    total = s[-1]
    if total <= step:
        return poly.copy()
    targets = np.arange(0.0, total, step)
    if total - targets[-1] > 1e-9:
        targets = np.concatenate((targets, [total]))
    return np.stack((np.interp(targets, s, poly[:, 0]),
                     np.interp(targets, s, poly[:, 1])), axis=1)


def _smooth(poly: np.ndarray) -> np.ndarray:
    from scipy.interpolate import splev, splprep

    tck, u = splprep(np.asarray(poly, dtype=float).T, u=None, k=3, s=0.0)
    u_new = np.linspace(np.min(u), np.max(u), 200)
    x_new, y_new = splev(u_new, tck, der=0)
    return _resample(np.stack((x_new, y_new), axis=1), 1.0)


def _extend_front(poly: np.ndarray, length: float = 5.0) -> np.ndarray:
    seg = poly[1] - poly[0]
    step = float(np.hypot(*seg))
    tangent = seg / step
    n = max(int(np.ceil(length / step)), 1)
    pre = poly[0] - np.outer(np.arange(n, 0, -1) * step, tangent)
    return np.concatenate([pre, poly], axis=0)


def prepare(route_polyline: np.ndarray) -> np.ndarray:
    """The polyline the curvilinear frame is built on."""
    poly = _dedup(np.asarray(route_polyline, dtype=np.float64))
    poly = _dedup(_smooth(poly))
    return _extend_front(poly)


def tables(poly: np.ndarray) -> Tables:
    poly = np.asarray(poly, dtype=np.float64)
    s = _pathlength(poly)
    d = np.diff(poly, axis=0)
    heading = np.arctan2(d[:, 1], d[:, 0])
    theta = np.unwrap(np.concatenate((heading, heading[-1:])))
    x_d = np.gradient(poly[:, 0])
    x_dd = np.gradient(x_d)
    y_d = np.gradient(poly[:, 1])
    y_dd = np.gradient(y_d)
    curv = (x_d * y_dd - y_d * x_dd) / (x_d ** 2 + y_d ** 2) ** 1.5
    curv_d = np.gradient(curv, s)
    tangent = d / np.linalg.norm(d, axis=1, keepdims=True)
    tangent = np.concatenate((tangent, tangent[-1:]), axis=0)
    normal = np.stack((-tangent[:, 1], tangent[:, 0]), axis=1)
    return Tables(poly, s, theta, curv, curv_d, tangent, normal)


def project(tab: Tables, x: float, y: float):
    """(s, d) of a point by orthogonal projection onto the polyline."""
    p = np.array([x, y])
    a = tab.points[:-1]
    rel = p[None, :] - a
    seg_len = np.diff(tab.s)
    t_proj = np.clip(np.sum(rel * tab.tangent[:-1], axis=1), 0.0, seg_len)
    closest = a + t_proj[:, None] * tab.tangent[:-1]
    best = int(np.argmin(np.sum((p[None, :] - closest) ** 2, axis=1)))
    return (tab.s[best] + t_proj[best],
            float(np.dot(rel[best], tab.normal[best])))


def _wrap(angle: float) -> float:
    two_pi = 2.0 * np.pi
    while angle > two_pi:
        angle -= two_pi
    while angle < -two_pi:
        angle += two_pi
    return angle


def initial_states(tab: Tables, position, orientation: float,
                   velocity: float, acceleration: float,
                   steering_angle: float, wheelbase: float, low_vel: bool):
    """Cartesian rear-axle state -> ([s, s_dot, s_ddot], [d, d_dot, d_ddot])
    (Werling et al., Eqs. A.3 and A.5; the upstream
    ``_compute_initial_states``)."""
    s, d = project(tab, position[0], position[1])
    i = int(np.argmax(tab.s > s)) - 1
    lam = (s - tab.s[i]) / (tab.s[i + 1] - tab.s[i])
    theta_ref = _wrap((tab.theta[i + 1] - tab.theta[i]) * (s - tab.s[i])
                      / (tab.s[i + 1] - tab.s[i]) + tab.theta[i])
    theta_cl = orientation - theta_ref
    kr = (tab.curv[i + 1] - tab.curv[i]) * lam + tab.curv[i]
    kr_d = (tab.curv_d[i + 1] - tab.curv_d[i]) * lam + tab.curv_d[i]
    kappa_0 = np.tan(steering_angle) / wheelbase
    one_krd = 1 - kr * d
    cos_t = math.cos(theta_cl)
    d_p = one_krd * np.tan(theta_cl)
    d_pp = -(kr_d * d + kr * d_p) * np.tan(theta_cl) + \
        (one_krd / cos_t ** 2) * (kappa_0 * one_krd / cos_t - kr)
    s_vel = velocity * cos_t / one_krd
    s_acc = acceleration - (s_vel ** 2 / cos_t) * (
        one_krd * np.tan(theta_cl) * (kappa_0 * one_krd / cos_t - kr)
        - (kr_d * d + kr * d_p))
    s_acc /= one_krd / cos_t
    if low_vel:
        d_vel, d_acc = d_p, d_pp
    else:
        d_vel = velocity * math.sin(theta_cl)
        d_acc = s_acc * d_p + s_vel ** 2 * d_pp
    return [s, s_vel, s_acc], [d, d_vel, d_acc]
