"""ctypes bindings for the C++ host-geometry module.

Counterpart of ``commonroad_rp_tpu/native/__init__.py``.  The port keeps its
own copy of the source, ``csrc/crp_native.cpp``, and builds it with ``g++``
on first use into ``build/native/`` (gitignored), named by a hash of the
source, the flags and the host CPU, so an edit rebuilds and a library built
for another CPU is never loaded.  The flags are the JAX package's Makefile's,
so on one host the two libraries are the same machine code and give the
same bits.  The build is atomic (a temporary name, then a rename): several
processes may build at once.

This is host scene compilation, not the device path: where no compiler is
found or the build fails, ``available()`` is false and the callers
(``utils.coordinate_system.CoordinateSystem.convert_to_curvilinear_coords``,
``ops.collision.compile_corridor``) take their numpy route, as the JAX
package does.  Force a rebuild with ``build(force=True)`` or by deleting
``build/native/``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import platform
import shutil
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "crp_native.cpp"
BUILD_DIR = SOURCE.parent.parent.parent / "build" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-shared")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed = False
# the compiler's command line and output of this process's last build
build_log: Optional[str] = None

_f64p = ctypes.POINTER(ctypes.c_double)
_u8p = ctypes.POINTER(ctypes.c_uint8)


def _cxx() -> Optional[str]:
    return os.environ.get("CXX") or shutil.which("g++")


def _host_cpu() -> str:
    """The CPU the library is built for (``-march=native``)."""
    try:
        lines = pathlib.Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        return platform.processor()
    keep = [ln for ln in lines if ln.startswith(("model name", "flags"))]
    return "\n".join(sorted(set(keep))) or platform.processor()


def library_path() -> pathlib.Path:
    tag = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()
                         + _host_cpu().encode()).hexdigest()
    return BUILD_DIR / f"libcrp_native_{tag[:16]}.so"


def build(force: bool = False) -> Optional[pathlib.Path]:
    """Compile the library (once per source, flags and CPU); returns its
    path, or None when no compiler is found or the build fails."""
    global build_log
    out = library_path()
    if out.exists() and not force:
        return out
    cxx = _cxx()
    if cxx is None:
        build_log = "no C++ compiler (g++ or $CXX) found"
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired) as exc:
        build_log = f"{' '.join(cmd)}\n{exc}"
        return None
    build_log = " ".join(cmd) + "\n" + proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, out)
    return out


def _bind(lib: ctypes.CDLL):
    lib.clcs_build_tables.argtypes = [_f64p, ctypes.c_int64, _f64p, _f64p,
                                      _f64p, _f64p]
    lib.clcs_project.argtypes = [_f64p, _f64p, _f64p, _f64p, ctypes.c_int64,
                                 _f64p, ctypes.c_int64, _f64p, _f64p]
    lib.clcs_project.restype = ctypes.c_int64
    lib.clcs_to_cartesian.argtypes = [_f64p, _f64p, _f64p, _f64p,
                                      ctypes.c_int64, _f64p, _f64p,
                                      ctypes.c_int64, _f64p]
    lib.scene_points_in_polygon.argtypes = [_f64p, ctypes.c_int64, _f64p,
                                            ctypes.c_int64, _u8p]
    lib.scene_corridor_sweep.argtypes = [_f64p, _f64p, ctypes.c_int64, _f64p,
                                         ctypes.c_int64, ctypes.c_double,
                                         _f64p, _f64p]
    lib.scene_obb_sum.argtypes = [_f64p, _f64p, ctypes.c_int64,
                                  ctypes.c_double, ctypes.c_double,
                                  _f64p, _f64p, _f64p]


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _failed
    with _lock:
        if _lib is None and not _failed:
            path = build()
            if path is None:
                _failed = True
            else:
                lib = ctypes.CDLL(str(path))
                _bind(lib)
                _lib = lib
    return _lib


def available() -> bool:
    """True when the library is built (building it on the first call)."""
    return _load() is not None


def _library() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native library unavailable:\n{build_log}")
    return lib


def _f64(arr) -> np.ndarray:
    return np.ascontiguousarray(arr, dtype=np.float64)


def _ptr(arr: np.ndarray):
    return arr.ctypes.data_as(_f64p)


def clcs_build_tables(points: np.ndarray):
    """(s, theta_unwrapped, tangent, normal) tables for an [n, 2] polyline."""
    lib = _library()
    points = _f64(points)
    n = len(points)
    s = np.empty(n)
    theta = np.empty(n)
    tangent = np.empty((n, 2))
    normal = np.empty((n, 2))
    lib.clcs_build_tables(_ptr(points), n, _ptr(s), _ptr(theta),
                          _ptr(tangent), _ptr(normal))
    return s, theta, tangent, normal


def clcs_project(points, s, tangent, normal,
                 query: np.ndarray) -> Tuple[np.ndarray, np.ndarray, int]:
    """Project [m, 2] Cartesian points -> (s[m], d[m], n_inside_domain)."""
    lib = _library()
    points, s, tangent, normal = map(_f64, (points, s, tangent, normal))
    query = _f64(np.atleast_2d(query))
    m = len(query)
    s_out = np.empty(m)
    d_out = np.empty(m)
    inside = lib.clcs_project(_ptr(points), _ptr(s), _ptr(tangent),
                              _ptr(normal), len(points), _ptr(query), m,
                              _ptr(s_out), _ptr(d_out))
    return s_out, d_out, int(inside)


def clcs_to_cartesian(points, s, tangent, normal, s_in, d_in) -> np.ndarray:
    """Convert (s[m], d[m]) -> [m, 2] Cartesian; NaN outside the domain."""
    lib = _library()
    points, s, tangent, normal = map(_f64, (points, s, tangent, normal))
    s_in = _f64(np.atleast_1d(s_in))
    d_in = _f64(np.atleast_1d(d_in))
    out = np.empty((len(s_in), 2))
    lib.clcs_to_cartesian(_ptr(points), _ptr(s), _ptr(tangent), _ptr(normal),
                          len(points), _ptr(s_in), _ptr(d_in), len(s_in),
                          _ptr(out))
    return out


def points_in_polygon(polygon: np.ndarray, points: np.ndarray) -> np.ndarray:
    """[m] bool: each point inside the polygon (even-odd rule)."""
    lib = _library()
    polygon = _f64(polygon)
    points = _f64(np.atleast_2d(points))
    out = np.empty(len(points), dtype=np.uint8)
    lib.scene_points_in_polygon(_ptr(polygon), len(polygon), _ptr(points),
                                len(points), out.ctypes.data_as(_u8p))
    return out.astype(bool)


def corridor_sweep(path_points: np.ndarray, normals: np.ndarray,
                   segments: np.ndarray, d_default: float = 1e4):
    """(d_lo[P], d_hi[P]) drivable band via normal/segment intersections."""
    lib = _library()
    path_points, normals, segments = map(_f64, (path_points, normals,
                                                segments))
    P = len(path_points)
    d_lo = np.empty(P)
    d_hi = np.empty(P)
    lib.scene_corridor_sweep(_ptr(path_points), _ptr(normals), P,
                             _ptr(segments), len(segments),
                             ctypes.c_double(d_default), _ptr(d_lo), _ptr(d_hi))
    return d_lo, d_hi


def obb_sum(centers: np.ndarray, thetas: np.ndarray, half_l: float,
            half_w: float):
    """Swept OBB covers of consecutive pose pairs
    (trajectory_preprocess_obb_sum equivalent)."""
    lib = _library()
    centers, thetas = _f64(centers), _f64(thetas)
    t_len = len(thetas)
    out_c = np.empty((t_len - 1, 2))
    out_t = np.empty(t_len - 1)
    out_h = np.empty((t_len - 1, 2))
    lib.scene_obb_sum(_ptr(centers), _ptr(thetas), t_len,
                      ctypes.c_double(half_l), ctypes.c_double(half_w),
                      _ptr(out_c), _ptr(out_t), _ptr(out_h))
    return out_c, out_t, out_h
