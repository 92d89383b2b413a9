"""Trajectory-set capture (``draw_traj_set``): the port against the JAX
package.

* The port's fused path captures the selected level's bundle with one
  float32 conformance ``evaluate_level`` after the selection; the JAX
  package's fast capture reproduces its conformance path's bundle
  (``commonroad_rp_tpu/models/planner.py:1083-1121``), so both are held
  against the JAX conformance path's float32 bundle on ZAM_Over's first
  cycle at the bar of ``tests/test_fast_scoring.py:501-507``: identical
  feasible and colliding labels, x and y within 1e-3, feasible costs within
  rtol 1e-4.  The port's own conformance-path bundle meets the same bar.
* Capture on and off give identical selected states and counters over the
  first cycles of the drive.
* ``convert_state_list_to_commonroad_object`` gives the JAX positions and
  shape to 1e-9.
"""

import functools
import logging

import numpy as np
import pytest
import torch

from commonroad_rp_tpu.models.planner import ReactivePlanner as JaxPlanner
from commonroad_rp_tpu.utils.config import \
    ReactivePlannerConfiguration as JaxConfig
from commonroad_rp_tpu.utils.route import RoutePlanner as JaxRoutePlanner

from commonroad_rp_tpu_torch.models.trajectories import FeasibilityStatus
from commonroad_rp_tpu_torch.run_planner import (drive_to_goal, load_config,
                                                 make_planner)

logging.getLogger("RP_LOGGER").setLevel(logging.CRITICAL)

SCENARIO = "ZAM_Over-1_1"


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_planner(repo_root, capture=True):
    config = JaxConfig.load(repo_root / "configurations" / f"{SCENARIO}.yaml",
                            f"{SCENARIO}.xml")
    config.general.path_scenarios = str(repo_root / "example_scenarios") + "/"
    config.general.set_path_scenario(f"{SCENARIO}.xml")
    config.update()
    config.debug.fast_scoring = False
    config.debug.kernel_dtype = "float32"
    config.debug.draw_traj_set = capture
    config.debug.save_plots = capture
    route = JaxRoutePlanner(config.scenario, config.planning_problem) \
        .plan_routes().retrieve_first_route()
    planner = JaxPlanner(config)
    planner.set_reference_path(route.reference_path)
    planner.set_desired_velocity(current_speed=planner.x_0.velocity)
    return planner


def _port_planner(repo_root, fast=True, capture=True):
    config = load_config(SCENARIO, repo_root)
    config.debug.fast_scoring = fast
    config.debug.kernel_dtype = "float32"
    config.debug.draw_traj_set = capture
    config.debug.save_plots = capture
    return make_planner(config, device="cpu")


@functools.lru_cache(maxsize=None)
def _jax_first_cycle(repo_root):
    planner = _jax_planner(repo_root)
    result = planner.plan()
    assert result is not None
    return planner, result


def assert_bundle_matches(got, want):
    """The bar of tests/test_fast_scoring.py:501-507."""
    assert got.x.shape == want.x.shape
    np.testing.assert_array_equal(got.feasible, want.feasible)
    np.testing.assert_array_equal(got.collides, want.collides)
    np.testing.assert_allclose(got.x, want.x, atol=1e-3)
    np.testing.assert_allclose(got.y, want.y, atol=1e-3)
    feasible = want.feasible
    np.testing.assert_allclose(got.costs[feasible], want.costs[feasible],
                               rtol=1e-4)
    assert [lbl.value for lbl in got.labels] == \
        [lbl.value for lbl in want.labels]


@pytest.mark.parametrize("fast", [True, False], ids=["fused", "conformance"])
def test_captured_bundle_matches_jax(repo_root, fast):
    jax_planner, _ = _jax_first_cycle(repo_root)
    want = jax_planner.stored_trajectories
    planner = _port_planner(repo_root, fast=fast)
    planner.set_desired_velocity(current_speed=planner.x_0.velocity)
    assert planner.plan() is not None
    got = planner.stored_trajectories
    assert_bundle_matches(got, want)
    labels = set(got.labels)
    assert FeasibilityStatus.FEASIBLE in labels
    assert FeasibilityStatus.INFEASIBLE_COLLISION in labels
    assert got.x.dtype == np.float32


def test_capture_changes_no_selection(repo_root):
    """Capture on and off: identical driven states, counters and reason
    dicts over the first four cycles of the drive."""
    runs = {}
    for capture in (False, True):
        planner = _port_planner(repo_root, capture=capture)
        counters = []
        drive_to_goal(planner, max_steps=12, on_step=lambda _: counters.append(
            (planner.infeasible_count_kinematics,
             planner.infeasible_count_collision,
             dict(planner.infeasible_reason_dict), planner.optimal_cost)))
        states = np.array([[s.position[0], s.position[1], s.velocity,
                            s.orientation] for s in planner.record_state_list])
        runs[capture] = (states, counters, planner.stored_trajectories)
    np.testing.assert_array_equal(runs[True][0], runs[False][0])
    assert runs[True][1] == runs[False][1]
    assert runs[False][2] is None and runs[True][2] is not None


def test_convert_state_list_matches_jax(repo_root):
    jax_planner, jax_result = _jax_first_cycle(repo_root)
    planner = _port_planner(repo_root)
    planner.set_desired_velocity(current_speed=planner.x_0.velocity)
    result = planner.plan()
    want = jax_planner.convert_state_list_to_commonroad_object(
        jax_result[0].state_list)
    # the port's own states through both packages' conversion: the same
    # shifted positions, shape and id
    got = planner.convert_state_list_to_commonroad_object(result[0].state_list)
    ref = jax_planner.convert_state_list_to_commonroad_object(
        result[0].state_list)
    assert got.obstacle_id == want.obstacle_id == 42
    assert (got.shape.length, got.shape.width) == \
        (want.shape.length, want.shape.width)
    np.testing.assert_allclose(
        [s.position for s in got.trajectory],
        [s.position for s in ref.trajectory], rtol=0, atol=1e-9)
    np.testing.assert_allclose(got.initial_state.position,
                               ref.initial_state.position, atol=1e-9)
    assert [s.time_step for s in got.trajectory] == \
        [s.time_step for s in want.trajectory]
    np.testing.assert_allclose([s.position for s in got.trajectory],
                               [s.position for s in want.trajectory],
                               atol=1e-3)
