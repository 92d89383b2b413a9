"""The port's C++ host module (``commonroad_rp_tpu_torch.native``).

* The cases of ``tests/test_native.py`` on the port's library, against the
  port's numpy and torch code.
* The port's library and the JAX package's library give bit-identical
  outputs on the same inputs (the port compiles its own copy of the source
  with the JAX package's Makefile flags).
* ``CoordinateSystem.convert_to_curvilinear_coords`` and
  ``ops.collision.compile_corridor`` agree with their numpy route to 1e-9
  on the four bundled scenarios.
* Builds from several processes at once all succeed (the build writes a
  temporary file and renames it).

Skipped only where no C++ compiler is found.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

from commonroad_rp_tpu_torch import native
from commonroad_rp_tpu_torch.ops import collision as port_collision
from commonroad_rp_tpu_torch.ops import frenet as port_frenet
from commonroad_rp_tpu_torch.utils.coordinate_system import CoordinateSystem

pytestmark = pytest.mark.skipif(native._cxx() is None,
                                reason="no C++ compiler (g++) found")

SCENARIOS = ("ZAM_Over-1_1", "DEU_Test-1_1_T-1", "ZAM-Ramp-1_1-T-1",
             "ZAM_Tjunction-1_42_T-1")


def _arc(radius=40.0, n=120):
    ang = np.linspace(0, np.pi / 2, n)
    return np.stack([radius * np.sin(ang), radius * (1 - np.cos(ang))], axis=1)


def test_library_builds():
    assert native.available(), native.build_log
    assert native.library_path().exists()


def test_tables_match_python():
    poly = _arc()
    s, theta, tangent, normal = native.clcs_build_tables(poly)
    tables = port_frenet.from_polyline(poly, dtype=torch.float64)
    np.testing.assert_allclose(s, tables.s.numpy(), atol=1e-12)
    np.testing.assert_allclose(theta, tables.theta.numpy(), atol=1e-9)
    np.testing.assert_allclose(tangent, tables.tangent.numpy(), atol=1e-12)
    np.testing.assert_allclose(normal, tables.normal.numpy(), atol=1e-12)


def test_projection_roundtrip():
    poly = _arc()
    s, theta, tangent, normal = native.clcs_build_tables(poly)
    queries = np.array([[20.0, 7.0], [30.0, 15.0]])
    s_out, d_out, inside = native.clcs_project(poly, s, tangent, normal,
                                               queries)
    assert inside == 2
    back = native.clcs_to_cartesian(poly, s, tangent, normal, s_out, d_out)
    np.testing.assert_allclose(back, queries, atol=1e-6)


def test_projection_matches_coordinate_system(monkeypatch):
    poly = _arc()
    co = CoordinateSystem(poly, smooth_reference=False)
    s, theta, tangent, normal = native.clcs_build_tables(co.reference)
    q = np.array([[25.0, 9.0]])
    s_n, d_n, _ = native.clcs_project(co.reference, s, tangent, normal, q)
    monkeypatch.setattr(native, "available", lambda: False)
    sd = co.convert_to_curvilinear_coords(25.0, 9.0)
    np.testing.assert_allclose([s_n[0], d_n[0]], sd, atol=1e-9)


def test_points_in_polygon():
    square = np.array([[0, 0], [4, 0], [4, 4], [0, 4]], dtype=float)
    pts = np.array([[2, 2], [5, 2], [-1, -1], [3.9, 3.9]])
    got = native.points_in_polygon(square, pts)
    np.testing.assert_array_equal(got, [True, False, False, True])


def _two_boundaries():
    line = np.stack([np.linspace(0, 50, 51), np.zeros(51)], axis=1)
    tables = port_frenet.from_polyline(line, dtype=torch.float64)
    xs = np.linspace(-5, 55, 61)
    segs = []
    for yv in (3.5, -2.5):
        pts = np.stack([xs, np.full_like(xs, yv)], axis=1)
        segs.extend(np.stack([pts[:-1], pts[1:]], axis=1))
    return tables, np.stack(segs)


def test_corridor_sweep_matches_python(monkeypatch):
    tables, segments = _two_boundaries()
    d_lo, d_hi = native.corridor_sweep(tables.points.numpy(),
                                       tables.normal.numpy(), segments)
    boundary = port_collision.BoundaryArrays(
        segments=torch.as_tensor(segments),
        valid=torch.ones(len(segments), dtype=torch.bool))
    monkeypatch.setattr(native, "available", lambda: False)
    corridor = port_collision.compile_corridor(boundary, tables)
    np.testing.assert_allclose(d_lo, corridor.d_lo.numpy(), atol=1e-9)
    np.testing.assert_allclose(d_hi, corridor.d_hi.numpy(), atol=1e-9)


def test_obb_sum_matches_device_merge():
    centers = np.array([[0.0, 0.0], [2.0, 0.5], [4.0, 1.5]])
    thetas = np.array([0.0, 0.3, 0.6])
    c_n, t_n, h_n = native.obb_sum(centers, thetas, 2.25, 0.8)
    c_d, t_d, h_d = port_collision.merge_obb_pairs(
        torch.as_tensor(centers[None]), torch.as_tensor(thetas[None]),
        torch.tensor([[2.25, 0.8]], dtype=torch.float64))
    np.testing.assert_allclose(c_n, c_d[0].numpy(), atol=1e-9)
    np.testing.assert_allclose(t_n, t_d[0].numpy(), atol=1e-9)
    np.testing.assert_allclose(h_n, h_d[0].numpy(), atol=1e-9)


def _run_all(lib, seed):
    """Every entry point of ``lib`` on inputs made from ``seed``."""
    rng = np.random.default_rng(seed)
    ang = np.linspace(0, np.pi / 2, 300)
    poly = np.stack([40 * np.sin(ang), 40 * (1 - np.cos(ang))], axis=1) + \
        rng.normal(0.0, 0.05, (300, 2))
    query = rng.uniform(0.0, 40.0, (500, 2))
    segments = rng.uniform(-10.0, 50.0, (200, 2, 2))
    centers = np.cumsum(rng.normal(0.0, 1.0, (50, 2)), axis=0)
    thetas = np.cumsum(rng.normal(0.0, 0.1, 50))
    polygon = rng.uniform(0.0, 10.0, (12, 2))
    s, theta, tangent, normal = lib.clcs_build_tables(poly)
    s_out, d_out, inside = lib.clcs_project(poly, s, tangent, normal, query)
    back = lib.clcs_to_cartesian(poly, s, tangent, normal, s_out, d_out)
    pip = lib.points_in_polygon(polygon, query / 4.0)
    d_lo, d_hi = lib.corridor_sweep(poly, normal, segments)
    obb = lib.obb_sum(centers, thetas, 2.25, 0.8)
    return [s, theta, tangent, normal, s_out, d_out, np.asarray([inside]),
            back, pip, d_lo, d_hi, *obb]


@pytest.mark.parametrize("seed", [0, 1])
def test_bit_identical_to_jax_library(seed):
    jax_native = pytest.importorskip("commonroad_rp_tpu.native")
    if not jax_native.available():
        pytest.skip("the JAX package's native library is not built")
    got = _run_all(native, seed)
    want = _run_all(jax_native, seed)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8))


@pytest.mark.parametrize("name", SCENARIOS)
def test_routes_agree_on_scenarios(repo_root, name, monkeypatch):
    """The native and numpy routes of the planner's two host uses, on each
    scenario's reference path and road boundary."""
    from commonroad_rp_tpu_torch.run_planner import load_config
    from commonroad_rp_tpu_torch.utils.route import RoutePlanner

    config = load_config(name, repo_root)
    route = RoutePlanner(config.scenario, config.planning_problem) \
        .plan_routes().retrieve_first_route()
    co = CoordinateSystem(route.reference_path)
    boundary = port_collision.compile_road_boundary(config.scenario,
                                                    dtype=torch.float64)
    rng = np.random.default_rng(7)
    idx = rng.integers(5, len(co.reference) - 5, 24)
    pts = co.reference[idx] + rng.uniform(-3.0, 3.0, (24, 2))
    pts = np.concatenate([pts, config.planning_problem.initial_state
                          .position[None]])

    def both():
        sd = np.array([co.convert_to_curvilinear_coords(*p) for p in pts])
        corridor = port_collision.compile_corridor(boundary, co.tables)
        return sd, corridor.d_lo.numpy(), corridor.d_hi.numpy()

    assert native.available()
    got = both()
    monkeypatch.setattr(native, "available", lambda: False)
    want = both()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-9)


def test_concurrent_builds(tmp_path):
    """Three processes force a build into one empty directory at once:
    each gets a loadable library."""
    code = ("import sys, pathlib; sys.path.insert(0, sys.argv[1]); "
            "from commonroad_rp_tpu_torch import native; "
            "native.BUILD_DIR = pathlib.Path(sys.argv[2]); "
            "assert native.build(force=True) is not None, native.build_log; "
            "assert native.available(); "
            "print(native.points_in_polygon([[0, 0], [1, 0], [1, 1]], "
            "[[0.7, 0.2]])[0])")
    root = str(native.SOURCE.parent.parent.parent)
    procs = [subprocess.Popen([sys.executable, "-c", code, root,
                               str(tmp_path)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(3)]
    for proc in procs:
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err
        assert out.strip() == "True"
    assert [p.name for p in tmp_path.iterdir()] == \
        [native.library_path().name]


def test_source_is_the_ports_own_copy():
    """The port compiles its own copy of the C++ source, unchanged from the
    JAX package's, and names no file of the JAX package."""
    import pathlib

    port_pkg = pathlib.Path(native.__file__).resolve().parent
    assert native.SOURCE.parent == port_pkg / "csrc"
    assert native.BUILD_DIR.parent.name == "build"
    jax_source = port_pkg.parent / "commonroad_rp_tpu" / "native" / "src" / \
        "crp_native.cpp"
    if jax_source.exists():
        assert native.SOURCE.read_bytes() == jax_source.read_bytes()
    assert "commonroad_rp_tpu/" not in pathlib.Path(native.__file__) \
        .read_text().replace("commonroad_rp_tpu/native/__init__.py", "")
