"""Host-side polyline differential geometry.

Equivalents of the commonroad_dc.geometry.util helpers used by the reference's
coordinate-system wrapper (reference: commonroad_rp/utility/utils_coordinate_system.py:14-16,
:60-83, :114-118).  These run once per reference path on the host (numpy,
float64); their outputs are the dense state tables consumed by the device
kernels in ``ops.frenet``.
"""

from __future__ import annotations

import numpy as np


def polyline_lengths(polyline: np.ndarray) -> np.ndarray:
    """Per-segment Euclidean lengths of an [N, 2] polyline ([N-1] array)."""
    return np.linalg.norm(np.diff(polyline, axis=0), axis=1)


def compute_pathlength(polyline: np.ndarray) -> np.ndarray:
    """Cumulative arclength s_i of each vertex, s_0 = 0.

    Mirrors commonroad_dc.geometry.util.compute_pathlength_from_polyline
    (used at utils_coordinate_system.py:114).
    """
    assert polyline.ndim == 2 and polyline.shape[1] == 2 and len(polyline) > 1, \
        f"polyline must be [N>=2, 2], got {polyline.shape}"
    return np.concatenate(([0.0], np.cumsum(polyline_lengths(polyline))))


def compute_orientation(polyline: np.ndarray) -> np.ndarray:
    """Heading angle (rad) at each vertex of a polyline.

    Vertex i < N-1 takes the direction of its outgoing segment; the final
    vertex repeats the last segment direction.  Mirrors the semantics of
    commonroad_dc.geometry.util.compute_orientation_from_polyline (used at
    utils_coordinate_system.py:116); the reference wraps the result in
    np.unwrap, which callers here do as well.
    """
    assert len(polyline) > 1
    d = np.diff(polyline, axis=0)
    theta = np.arctan2(d[:, 1], d[:, 0])
    return np.concatenate((theta, theta[-1:]))


def compute_curvature(polyline: np.ndarray) -> np.ndarray:
    """Signed curvature at each vertex via central differences.

    kappa = (x' y'' - y' x'') / (x'^2 + y'^2)^(3/2) with derivatives taken by
    np.gradient over the vertex index, mirroring
    commonroad_dc.geometry.util.compute_curvature_from_polyline (used at
    utils_coordinate_system.py:115, preprocess_ref_path :69).
    """
    x_d = np.gradient(polyline[:, 0])
    x_dd = np.gradient(x_d)
    y_d = np.gradient(polyline[:, 1])
    y_dd = np.gradient(y_d)
    denom = (x_d ** 2 + y_d ** 2) ** 1.5
    return (x_d * y_dd - y_d * x_dd) / denom


def resample_polyline(polyline: np.ndarray, step: float = 2.0) -> np.ndarray:
    """Resample a polyline at (approximately) fixed arclength intervals.

    Produces vertices at s = 0, step, 2*step, ... plus the original endpoint
    (if not within half a step of the last sample).  Mirrors the role of
    commonroad_dc.geometry.util.resample_polyline (utils_coordinate_system.py:68,:82).
    """
    s = compute_pathlength(polyline)
    total = s[-1]
    if total <= step:
        return polyline.copy()
    targets = np.arange(0.0, total, step)
    if total - targets[-1] > 1e-9:
        targets = np.concatenate((targets, [total]))
    x = np.interp(targets, s, polyline[:, 0])
    y = np.interp(targets, s, polyline[:, 1])
    return np.stack((x, y), axis=1)


def chaikins_corner_cutting(polyline: np.ndarray, refinements: int = 1) -> np.ndarray:
    """One (or more) rounds of Chaikin's 1/4-3/4 corner-cutting subdivision.

    Endpoint-preserving variant; mirrors the role of
    commonroad_dc.geometry.util.chaikins_corner_cutting used by
    preprocess_ref_path (utils_coordinate_system.py:67).
    """
    pts = np.asarray(polyline, dtype=float)
    for _ in range(refinements):
        q = 0.75 * pts[:-1] + 0.25 * pts[1:]
        r = 0.25 * pts[:-1] + 0.75 * pts[1:]
        mid = np.empty((2 * (len(pts) - 1), 2))
        mid[0::2] = q
        mid[1::2] = r
        pts = np.concatenate((pts[:1], mid, pts[-1:]))
    return pts


def preprocess_ref_path(ref_path: np.ndarray, resample_step: float = 1.0,
                        max_curv_desired: float = 0.01) -> np.ndarray:
    """Iterative corner cutting + resampling until curvature is bounded.

    Mirrors utils_coordinate_system.py:60-71 (preprocess_ref_path): repeat
    Chaikin subdivision followed by resampling until the maximum absolute
    curvature drops below the threshold.
    """
    path = np.array(ref_path, dtype=float)
    max_curv = max_curv_desired + 0.2
    iterations = 0
    while max_curv > max_curv_desired and iterations < 100:
        path = chaikins_corner_cutting(path)
        path = resample_polyline(path, resample_step)
        max_curv = float(np.max(np.abs(compute_curvature(path))))
        iterations += 1
    return path


def extend_ref_path_front(ref_path: np.ndarray, length: float = 5.0
                          ) -> np.ndarray:
    """Linearly extend a reference path BEHIND its first vertex.

    The C++ CLCS extends the reference polyline beyond both ends when
    building the coordinate system, so initial states slightly before the
    route start (e.g. a rear-axle position when the planning problem's
    vehicle center sits exactly at the first lanelet vertex, as in
    ZAM-Ramp) project to a proper negative offset instead of clamping to
    s = 0 — a clamp there teleports the first planned state to the path
    start (measured: a 1.37 m KS-infeasible first transition).  Points are
    prepended along the reversed first-segment tangent at that segment's
    spacing.
    """
    p0, p1 = ref_path[0], ref_path[1]
    seg = p1 - p0
    step = float(np.hypot(*seg))
    tangent = seg / step
    n = max(int(np.ceil(length / step)), 1)
    pre = p0 - np.outer(np.arange(n, 0, -1) * step, tangent)
    return np.concatenate([pre, ref_path], axis=0)


def extrapolate_ref_path(ref_path: np.ndarray, resample_step: float = 2.0) -> np.ndarray:
    """Linearly extend the final segment of a reference path.

    Mirrors utils_coordinate_system.py:46-57 (extrapolate_ref_path): fit a line
    through the last two vertices, append a far extrapolated point, resample.
    """
    (x1, y1), (x2, y2) = ref_path[-2], ref_path[-1]
    x_new = 2.3 * x2 - x1
    if abs(x2 - x1) < 1e-12:
        y_new = 2.3 * y2 - y1
    else:
        slope = (y2 - y1) / (x2 - x1)
        y_new = y2 + slope * (x_new - x2)
    extended = np.concatenate((ref_path, [[x_new, y_new]]), axis=0)
    return resample_polyline(extended, step=resample_step)


def smooth_ref_path(ref_path: np.ndarray, smoothing_factor: float = 0.0,
                    resample_step: float = 1.0) -> np.ndarray:
    """Cubic-spline smoothing of the reference path.

    Mirrors utils_coordinate_system.py:74-83 (smooth_ref_path): fit a cubic
    B-spline through the vertices (scipy splprep, smoothing s), evaluate 200
    samples, then resample at ``resample_step``.  Host-side, once per path.
    """
    from scipy.interpolate import splev, splprep

    tck, u = splprep(np.asarray(ref_path, dtype=float).T, u=None, k=3, s=smoothing_factor)
    u_new = np.linspace(np.min(u), np.max(u), 200)
    x_new, y_new = splev(u_new, tck, der=0)
    return resample_polyline(np.stack((x_new, y_new), axis=1), resample_step)


def remove_duplicate_vertices(polyline: np.ndarray) -> np.ndarray:
    """Drop repeated vertices while preserving order.

    Mirrors the np.unique + sort-index dedup at utils_coordinate_system.py:95-96.
    """
    _, idx = np.unique(polyline, axis=0, return_index=True)
    return polyline[np.sort(idx)]


def make_valid_orientation(angle: float) -> float:
    """Wrap an angle into the interval [-2*pi, 2*pi].

    Mirrors commonroad.common.util.make_valid_orientation, used by
    interpolate_angle (utils_coordinate_system.py:43).
    """
    two_pi = 2.0 * np.pi
    while angle > two_pi:
        angle -= two_pi
    while angle < -two_pi:
        angle += two_pi
    return angle


def interpolate_angle(x: float, x1: float, x2: float, y1: float, y2: float) -> float:
    """Linear interpolation between two angles, wrapped to [-2*pi, 2*pi].

    Mirrors utils_coordinate_system.py:25-43 (interpolate_angle): plain linear
    interpolation of the (already unwrapped) angle values, then
    make_valid_orientation on the result.
    """
    delta = y2 - y1
    return make_valid_orientation(delta * (x - x1) / (x2 - x1) + y1)


def polygon_signed_area(points: np.ndarray) -> float:
    """Shoelace signed area (positive = counter-clockwise)."""
    x, y = points[:, 0], points[:, 1]
    return 0.5 * float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))


def polygon_is_convex(points: np.ndarray, tol: float = 1e-9) -> bool:
    """True if the (non-self-intersecting) polygon is convex.

    Cross products of consecutive edges must not change sign; collinear
    vertices (zero cross) are allowed.
    """
    pts = np.asarray(points, dtype=np.float64)
    n = len(pts)
    if n < 4:
        return True
    edges = np.roll(pts, -1, axis=0) - pts
    cross = edges[:, 0] * np.roll(edges, -1, axis=0)[:, 1] - \
        edges[:, 1] * np.roll(edges, -1, axis=0)[:, 0]
    scale = max(float(np.abs(cross).max()), 1.0)
    cross = cross / scale
    return bool(np.all(cross >= -tol) or np.all(cross <= tol))


def decompose_polygon(points: np.ndarray) -> list:
    """Split a simple polygon into convex pieces (numpy [V, 2] arrays).

    Convex input passes through unchanged (one piece); concave polygons are
    ear-clipped into triangles.  Plays the role of the exact C++ polygon
    primitives behind pycrcc's create_collision_object dispatch
    (reference: commonroad_rp/reactive_planner.py:236-239) — the union of
    the convex pieces is exactly the input polygon, so SAT per piece is an
    exact containment/overlap test for the whole shape.
    """
    pts = np.asarray(points, dtype=np.float64)
    # drop a closing duplicate vertex if present
    if len(pts) > 1 and np.allclose(pts[0], pts[-1]):
        pts = pts[:-1]
    if len(pts) < 3:
        raise ValueError("polygon needs at least 3 distinct vertices")
    if polygon_is_convex(pts):
        return [pts]

    # ear clipping (O(n^2)) on a counter-clockwise vertex ring
    if polygon_signed_area(pts) < 0:
        pts = pts[::-1].copy()
    idx = list(range(len(pts)))
    triangles = []

    def cross(o, a, b):
        return ((a[0] - o[0]) * (b[1] - o[1]) -
                (a[1] - o[1]) * (b[0] - o[0]))

    def point_in_triangle(p, a, b, c, eps=1e-12):
        d1, d2, d3 = cross(a, b, p), cross(b, c, p), cross(c, a, p)
        return d1 >= -eps and d2 >= -eps and d3 >= -eps

    guard = 0
    while len(idx) > 3 and guard < 10000:
        guard += 1
        n = len(idx)
        clipped = False
        for k in range(n):
            i_prev, i_cur, i_next = idx[k - 1], idx[k], idx[(k + 1) % n]
            a, b, c = pts[i_prev], pts[i_cur], pts[i_next]
            if cross(a, b, c) <= 1e-12:       # reflex or collinear: not an ear
                continue
            if any(point_in_triangle(pts[j], a, b, c)
                   for j in idx if j not in (i_prev, i_cur, i_next)):
                continue
            triangles.append(np.stack([a, b, c]))
            idx.pop(k)
            clipped = True
            break
        if not clipped:      # degenerate ring (collinear runs): drop a vertex
            idx.pop(0)
    if len(idx) == 3:
        triangles.append(np.stack([pts[idx[0]], pts[idx[1]], pts[idx[2]]]))
    return triangles
