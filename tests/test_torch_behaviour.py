"""The JAX package's behaviour tests that no other port test holds, on the
port (``device="cpu"``). The scan's standstill fallback and
``planning.factor`` 2 are in ``tests/test_torch_scan_modes.py``.

* The disc and triangle scene (``tests/test_circle_obstacle_e2e.py:101,
  :146``): the fused ``plan()`` drive reaches the goal collision-free
  against the exact disc, swerves and stays below the triangle's apex;
  ``plan_scan(24)`` records the JAX package's ``plan_scan(24)`` states;
  the conformance drive (``fast_scoring: False``, ``kernel_dtype:
  float64`` named in both packages) against the JAX package's.
* The projection domain (``tests/test_projection_domain.py``): the normal
  crossing at 1/kappa and the 20 m cap reject as domain, with the JAX
  package's feasibility, reasons and positions; the oracle agrees with the
  rollout on the curved path.
* The scenario reader on ``tests/test_scenario_edge_cases.py``'s XML
  strings (circles, polygons, goal shape groups, rotated rectangles): the
  same obstacles, goals and initial states as the JAX package's reader.
"""

import ast
import logging
import pathlib
import textwrap

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from commonroad_rp_tpu.models.planner import ReactivePlanner
from commonroad_rp_tpu.ops import collision as jax_co
from commonroad_rp_tpu.ops import kinematics as jax_kin
from commonroad_rp_tpu.utils import scenario as jax_scenario
from commonroad_rp_tpu.utils.route import RoutePlanner

from commonroad_rp_tpu_torch.baseline import oracle
from commonroad_rp_tpu_torch.ops import collision as co
from commonroad_rp_tpu_torch.ops import kinematics as kin_ops
from commonroad_rp_tpu_torch.ops.polynomial import (quartic_coeffs,
                                                    quintic_coeffs)
from commonroad_rp_tpu_torch.run_planner import drive_to_goal, make_planner
from commonroad_rp_tpu_torch.utils import scenario as port_scenario
from commonroad_rp_tpu_torch.utils.config import \
    ReactivePlannerConfiguration
from commonroad_rp_tpu_torch.utils.coordinate_system import CoordinateSystem
from commonroad_rp_tpu_torch.utils.evaluation import (
    create_full_solution_trajectory, solution_collision_report)

from tests import test_projection_domain as jax_domain
from tests import test_scenario_edge_cases as jax_edge
from tests.test_circle_obstacle_e2e import _SCENARIO
from tests.test_circle_obstacle_e2e import _config as jax_disc_config
from tests.test_circle_obstacle_e2e import _drive as jax_disc_drive

logging.getLogger("RP_LOGGER").setLevel(logging.CRITICAL)


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _assert_states_close(got, want, atol, n=None, fields=("position",)):
    n = min(len(got), len(want)) if n is None else n
    for a, b in zip(want[:n], got[:n]):
        assert a.time_step == b.time_step
        for field in fields:
            np.testing.assert_allclose(getattr(b, field), getattr(a, field),
                                       atol=atol, rtol=0)


# ---------------------------------------------------------------------------
# the disc and triangle scene
# ---------------------------------------------------------------------------

def _disc_config(tmp_path, fast, dtype):
    path = tmp_path / "SYN_Disc-1_1.xml"
    path.write_text(textwrap.dedent(_SCENARIO))
    config = ReactivePlannerConfiguration()
    config.general.path_scenarios = str(tmp_path) + "/"
    config.general.set_path_scenario("SYN_Disc-1_1.xml")
    config.planning.time_steps_computation = 20
    config.sampling.t_min = 0.4
    config.update()
    config.debug.fast_scoring = fast
    config.debug.kernel_dtype = dtype
    return config


def _disc_drive(tmp_path, fast=True, dtype="float32"):
    planner = make_planner(_disc_config(tmp_path, fast, dtype), device="cpu")
    result = drive_to_goal(planner, max_steps=100)
    assert result["goal_reached"]
    return planner


def test_disc_and_triangle_drive(tmp_path):
    """The fused plan() drive: collision-free against the exact disc, which
    it passes closely after a swerve, and below the triangle's apex."""
    planner = _disc_drive(tmp_path)
    config = planner.config
    states = create_full_solution_trajectory(
        config, planner.record_state_list).state_list
    report = solution_collision_report(config.scenario, states,
                                       config.vehicle.length,
                                       config.vehicle.width)
    assert report["collision_free"], report["collision_steps"]
    assert report["boundary_ok"], report["boundary_steps"]
    center, r = np.array([45.0, -0.6]), 1.8
    hl, hw = 0.5 * config.vehicle.length, 0.5 * config.vehicle.width
    clearance = []
    for s in states:
        rel = np.asarray(s.position) - center
        c, sn = np.cos(s.orientation), np.sin(s.orientation)
        qx = max(abs(rel[0] * c + rel[1] * sn) - hl, 0.0)
        qy = max(abs(-rel[0] * sn + rel[1] * c) - hw, 0.0)
        clearance.append(float(np.hypot(qx, qy)) - r)
    assert 0.0 < min(clearance) < 1.5
    assert max(abs(float(s.position[1])) for s in states) > 1.0
    near = [s.position[1] for s in states if 70 < s.position[0] < 80]
    assert near and max(near) < 1.6


def _scan_to_goal(planner, n_cycles):
    planner.set_desired_velocity(current_speed=planner.x_0.velocity)
    planner.record_state_and_input(planner.x_0)
    info = planner.plan_scan(n_cycles)
    assert info["goal_reached"]
    return planner.record_state_list


def test_disc_and_triangle_plan_scan_matches_jax(tmp_path):
    """plan_scan windows the disc and the polygon groups per cycle: the
    same recorded states as the JAX package's plan_scan(24) (both float32
    fused scans; measured apart by at most 3.6e-7 m and 1.9e-6 m/s)."""
    got = _scan_to_goal(make_planner(_disc_config(tmp_path, True, "float32"),
                                     device="cpu"), 24)
    config = jax_disc_config(tmp_path, fast=True)
    route = RoutePlanner(config.scenario, config.planning_problem) \
        .plan_routes().retrieve_first_route()
    jax_planner = ReactivePlanner(config)
    jax_planner.set_reference_path(route.reference_path)
    want = _scan_to_goal(jax_planner, 24)
    assert len(got) == len(want)
    _assert_states_close(got, want, 1e-4, fields=("position", "velocity",
                                                  "orientation"))


def test_disc_and_triangle_conformance_drive_matches_jax(tmp_path):
    """``fast_scoring: False`` with ``kernel_dtype: float64`` named: the
    port's conformance drive against the JAX package's XLA drive."""
    got = _disc_drive(tmp_path, fast=False,
                      dtype="float64").record_state_list
    jax_planner = jax_disc_drive(tmp_path, False)
    assert jax_planner.goal_reached()
    want = jax_planner.record_state_list
    assert len(got) == len(want)
    _assert_states_close(got, want, 1e-6, fields=("position", "velocity",
                                                   "orientation"))


# ---------------------------------------------------------------------------
# the projection domain
# ---------------------------------------------------------------------------

VEH = dict(wheelbase=2.5, wb_rear_axle=1.4, a_max=8.0, v_switch=7.3,
           kappa_max=0.35, v_delta_max=0.4, half_length=2.2, half_width=0.9)
NO_CHECKS = dict(check_velocity=False, check_acceleration=False,
                 check_kappa=False, check_kappa_dot=False,
                 check_yaw_rate=False)


def _arc_points(radius=6.0):
    """A left-turning arc (kappa ~ 1/radius), tests/test_projection_domain."""
    phi = np.linspace(-0.2, np.pi, 160)
    return np.stack([radius * np.sin(phi), radius * (1 - np.cos(phi))],
                    axis=1)


def _straight_points():
    return np.stack([np.linspace(0, 100, 200), np.zeros(200)], axis=1)


def _port_candidates(d_ends, v=4.0, horizon=1.0):
    K = len(d_ends)
    f64 = lambda a: torch.as_tensor(np.asarray(a, np.float64))
    c_lon = quartic_coeffs(f64([[2.0, v, 0.0]]), f64([v]),
                           f64([horizon])).repeat(K, 1)
    xd = np.stack([np.asarray(d_ends), np.zeros(K), np.zeros(K)], axis=1)
    c_lat = quintic_coeffs(f64(np.zeros((K, 3))), f64(xd),
                           f64(np.full(K, horizon)))
    return c_lon, c_lat


def _both_rollouts(points, d_ends, x0_orientation, checks):
    """(port rollout, JAX rollout) of the same candidates on ``points``."""
    n_steps, dt = 10, 0.1
    K = len(d_ends)
    c_lon, c_lat = _port_candidates(d_ends, horizon=n_steps * dt)
    cosys = CoordinateSystem(points, smooth_reference=False,
                             dtype=torch.float64)
    port = kin_ops.rollout(
        c_lon, c_lat, torch.full((K,), n_steps + 1, dtype=torch.int32),
        cosys.tables,
        kin_ops.VehicleArrays(**{k: torch.tensor(v, dtype=torch.float64)
                                 for k, v in VEH.items()}),
        torch.tensor(x0_orientation, dtype=torch.float64), dt, n_steps,
        False, **checks)
    jc_lon, jc_lat = jax_domain._candidates(d_ends, horizon=n_steps * dt)
    jax_cosys = jax_domain.CoordinateSystem(points, smooth_reference=False,
                                            dtype=jnp.float64)
    want = jax_kin.rollout(
        jnp.asarray(jc_lon), jnp.asarray(jc_lat),
        jnp.full(K, n_steps + 1, jnp.int32), jax_cosys.tables,
        jax_domain._veh(), jnp.asarray(x0_orientation, jnp.float64), dt,
        n_steps, False, **checks)
    np.testing.assert_allclose(c_lon.numpy(), jc_lon, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(c_lat.numpy(), jc_lat, rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(port.feasible.numpy(),
                                  np.asarray(want.feasible))
    np.testing.assert_array_equal(port.reason.numpy(),
                                  np.asarray(want.reason))
    np.testing.assert_allclose(port.x.numpy(), np.asarray(want.x),
                               rtol=1e-12, atol=1e-9)
    return port, cosys, (c_lon.numpy(), c_lat.numpy())


def test_normal_crossing_rejected_as_domain():
    """|d| beyond the normal-crossing distance 1/kappa on the concave side
    of the arc is domain-infeasible; the convex side at the same |d| is
    not."""
    port, _, _ = _both_rollouts(_arc_points(), [0.0, 3.0, 7.5, -7.5], 0.2,
                                NO_CHECKS)
    assert port.feasible.tolist() == [True, True, False, True]
    assert int(port.reason[2]) == kin_ops.REASON_DOMAIN


def test_clcs_default_20m_cap():
    port, _, _ = _both_rollouts(_straight_points(), [19.0, 21.0], 0.0,
                                NO_CHECKS)
    assert port.feasible.tolist() == [True, False]
    assert int(port.reason[1]) == kin_ops.REASON_DOMAIN


def test_oracle_matches_rollout_on_curved_path():
    """The oracle and the rollout agree on the domain partition of a fan
    of lateral targets over the tight curve, with every check on."""
    d_ends = np.linspace(-8.0, 8.0, 17)
    port, cosys, (c_lon, c_lat) = _both_rollouts(_arc_points(), d_ends, 0.2,
                                                 {})
    ref = oracle.OracleRefPath.from_tables(cosys.tables)
    veh = oracle.OracleVehicle(**VEH)
    for k in range(len(d_ends)):
        cand = oracle.check_kinematics_one(
            c_lon[k], c_lat[k], 11, ref, veh, 0.2, 0.1, 10, False,
            ["velocity", "acceleration", "kappa", "kappa_dot", "yaw_rate"])
        assert cand.feasible == bool(port.feasible[k]), (k, cand.reason)
        if not cand.feasible and cand.reason == "domain":
            assert int(port.reason[k]) == kin_ops.REASON_DOMAIN


# ---------------------------------------------------------------------------
# the scenario reader on the edge-case XML strings
# ---------------------------------------------------------------------------

def _edge_case_bodies():
    """{test name: the XML body} of tests/test_scenario_edge_cases.py."""
    tree = ast.parse(pathlib.Path(jax_edge.__file__).read_text())
    return {fn.name: node.value.value
            for fn in tree.body if isinstance(fn, ast.FunctionDef)
            for node in fn.body
            if isinstance(node, ast.Assign)
            and getattr(node.targets[0], "id", None) == "body"}


@pytest.mark.parametrize("name", ["test_circle_and_polygon_obstacles",
                                  "test_goal_shape_group",
                                  "test_rotated_rectangle_obstacle_offsets"])
def test_edge_case_scenarios_parse_as_in_jax(tmp_path, name):
    path = jax_edge._write_scenario(tmp_path, _edge_case_bodies()[name])
    scenario, pp_set = port_scenario.read_scenario_xml(path)
    jax_scn, jax_pp_set = jax_scenario.read_scenario_xml(path)
    assert len(scenario.static_obstacles) == len(jax_scn.static_obstacles)
    if scenario.static_obstacles:
        got = co.compile_obstacles(scenario, 0, 5, dtype=torch.float64)
        want = jax_co.compile_obstacles(jax_scn, 0, 5, dtype=jnp.float64)
        for field in co.ObstacleArrays._fields:
            g, w = getattr(got, field), getattr(want, field)
            assert (g is None) == (w is None), field
            if g is not None:
                np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                              err_msg=field)
    pp = list(pp_set.planning_problem_dict.values())[0]
    jax_pp = list(jax_pp_set.planning_problem_dict.values())[0]
    np.testing.assert_array_equal(pp.initial_state.position,
                                  jax_pp.initial_state.position)
    assert pp.initial_state.velocity == jax_pp.initial_state.velocity
    goal, jax_goal = pp.goal.state_list[0], jax_pp.goal.state_list[0]
    assert len(goal.position_shapes) == len(jax_goal.position_shapes)
    for a, b in zip(goal.position_shapes, jax_goal.position_shapes):
        np.testing.assert_array_equal(a.center, b.center)
        assert (a.length, a.width) == (b.length, b.width)
