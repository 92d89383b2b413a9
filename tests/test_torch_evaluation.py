"""Solution evaluation (the physics certificate): the port against the JAX
package on one recorded drive.

ZAM_Over-1_1 is driven to its goal through the port's float64 conformance
path; its recorded states go through both packages' evaluation functions:
the KS forward simulation, the input reconstruction and the state
reconstruction agree to 1e-12, and the collision report (obstacle and road
boundary hits per step) is identical on the drive itself and on copies of
it moved onto the obstacle and across the road boundary.
"""

import functools
import logging

import numpy as np
import pytest

from commonroad_rp_tpu.utils import evaluation as jax_eval
from commonroad_rp_tpu.utils.config import \
    ReactivePlannerConfiguration as JaxConfig

from commonroad_rp_tpu_torch.ops import collision as co
from commonroad_rp_tpu_torch.run_planner import (drive_to_goal, load_config,
                                                 make_planner)
from commonroad_rp_tpu_torch.utils import evaluation as port_eval

logging.getLogger("RP_LOGGER").setLevel(logging.CRITICAL)

SCENARIO = "ZAM_Over-1_1"


@functools.lru_cache(maxsize=None)
def _drive(repo_root):
    """(port planner after the drive, its solution trajectory, the JAX
    package's scenario)."""
    config = load_config(SCENARIO, repo_root)
    config.debug.kernel_dtype = "float64"
    planner = make_planner(config, device="cpu")
    result = drive_to_goal(planner, max_steps=100)
    assert result["goal_reached"] and result["steps"] == 27
    trajectory = port_eval.create_full_solution_trajectory(
        planner.config, planner.record_state_list)
    jax_config = JaxConfig.load(
        repo_root / "configurations" / f"{SCENARIO}.yaml", f"{SCENARIO}.xml")
    jax_config.general.path_scenarios = \
        str(repo_root / "example_scenarios") + "/"
    jax_config.general.set_path_scenario(f"{SCENARIO}.xml")
    jax_config.update()
    return planner, trajectory, jax_config.scenario


def test_ks_forward_simulation_matches_jax(repo_root):
    planner, trajectory, _ = _drive(repo_root)
    vt = planner.config.vehicle.id_type_vehicle
    port = port_eval.VehicleDynamicsKS.from_vehicle_type(vt)
    jax = jax_eval.VehicleDynamicsKS.from_vehicle_type(vt)
    rng = np.random.default_rng(0)
    for state in trajectory.state_list:
        x0 = port.state_to_array(state)[0]
        np.testing.assert_array_equal(x0, jax.state_to_array(state)[0])
        u = rng.uniform([-0.5, -6.0], [0.5, 6.0])
        np.testing.assert_allclose(port.forward_simulation(x0, u, 0.1),
                                   jax.forward_simulation(x0, u, 0.1),
                                   rtol=1e-12, atol=1e-12)


def test_reconstruct_inputs_and_states_match_jax(repo_root):
    planner, trajectory, _ = _drive(repo_root)
    config = planner.config
    solution = port_eval.create_planning_problem_solution(
        config, trajectory, config.scenario, config.planning_problem)
    pps = solution.planning_problem_solutions[0]
    feasible, inputs = port_eval.reconstruct_inputs(config, pps)
    want_feasible, want_inputs = jax_eval.reconstruct_inputs(config, pps)
    assert feasible == want_feasible and all(feasible)
    for got, want in zip(inputs, want_inputs):
        assert got.time_step == want.time_step
        np.testing.assert_allclose(
            [got.acceleration, got.steering_angle_speed],
            [want.acceleration, want.steering_angle_speed], rtol=1e-12,
            atol=1e-12)
    states = port_eval.reconstruct_states(config, trajectory.state_list,
                                          inputs)
    want_states = jax_eval.reconstruct_states(config, trajectory.state_list,
                                              want_inputs)
    for got, want in zip(states, want_states):
        np.testing.assert_allclose(got.position, want.position, rtol=1e-12,
                                   atol=1e-12)
        assert got.velocity == pytest.approx(want.velocity, abs=1e-12)


def _moved(states, dx, dy):
    return [s.translate_rotate(np.array([dx, dy]), 0.0) for s in states]


def test_solution_collision_report_matches_jax(repo_root):
    planner, trajectory, jax_scenario = _drive(repo_root)
    scenario = planner.config.scenario
    vehicle = planner.config.vehicle
    states = trajectory.state_list
    # copies whose 10th state sits on the static obstacle and on the middle
    # of a road-boundary segment
    obstacle = co.compile_obstacles(scenario, 0, 0).pose[0, 0, :2].numpy()
    segment = co.compile_road_boundary(scenario).segments[0].numpy()
    to_obstacle = obstacle - states[10].position
    to_boundary = segment.mean(axis=0) - states[10].position
    reports = []
    for moved in (states, _moved(states, *to_obstacle),
                  _moved(states, *to_boundary)):
        got = port_eval.solution_collision_report(scenario, moved,
                                                  vehicle.length,
                                                  vehicle.width)
        want = jax_eval.solution_collision_report(jax_scenario, moved,
                                                  vehicle.length,
                                                  vehicle.width)
        assert got == want
        reports.append(got)
    assert reports[0]["collision_free"] and reports[0]["boundary_ok"]
    assert 10 in reports[1]["collision_steps"]
    assert 10 in reports[2]["boundary_steps"]


def test_run_evaluation_certifies_the_drive(repo_root, capsys):
    planner, _, _ = _drive(repo_root)
    solution, feasible = port_eval.run_evaluation(
        planner.config, planner.record_state_list, planner.record_input_list)
    assert all(feasible) and len(feasible) == 27
    ok, detail = port_eval.valid_solution(
        planner.config.scenario, planner.config.planning_problem_set,
        solution)
    assert ok, detail
    assert "Feasibility Check Result: (True" in capsys.readouterr().out
