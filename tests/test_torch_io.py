"""Checkpoints and scenario/solution files: the port against the JAX package.

* Checkpoint: a planner resumed from a checkpoint keeps planning (as
  ``tests/test_checkpoint.py``); a ``FleetCarry`` round-trips bit for bit; a
  planner file and a fleet file written by the JAX package load in the port,
  and the reverse, field for field.
* ``write_scenario_xml`` gives the JAX package's bytes on the four bundled
  scenarios; ``write_solution_file`` gives the JAX package's bytes on
  ZAM_Over's drive (both written in this run, so the date matches);
  ``read_solution_file`` round-trips and reads the other package's file.
"""

import functools
import logging

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from commonroad_rp_tpu.models.planner import ReactivePlanner as JaxPlanner
from commonroad_rp_tpu.models.state import \
    ReactivePlannerState as JaxState
from commonroad_rp_tpu.parallel.fleet import FleetCarry as JaxFleetCarry
from commonroad_rp_tpu.utils import checkpoint as jax_checkpoint
from commonroad_rp_tpu.utils import evaluation as jax_evaluation
from commonroad_rp_tpu.utils import scenario_writer as jax_scenario_writer
from commonroad_rp_tpu.utils import solution_writer as jax_solution_writer
from commonroad_rp_tpu.utils.config import \
    ReactivePlannerConfiguration as JaxConfig
from commonroad_rp_tpu.utils.route import RoutePlanner as JaxRoutePlanner
from commonroad_rp_tpu.utils.scenario import \
    read_scenario_xml as jax_read_scenario

from commonroad_rp_tpu_torch.parallel.fleet import FleetCarry
from commonroad_rp_tpu_torch.run_planner import (drive_to_goal, load_config,
                                                 make_planner)
from commonroad_rp_tpu_torch.utils import checkpoint
from commonroad_rp_tpu_torch.utils import evaluation
from commonroad_rp_tpu_torch.utils import scenario_writer, solution_writer
from commonroad_rp_tpu_torch.utils.scenario import read_scenario_xml

logging.getLogger("RP_LOGGER").setLevel(logging.CRITICAL)

SCENARIO = "ZAM_Over-1_1"
SCENARIOS = ("ZAM_Over-1_1", "DEU_Test-1_1_T-1", "ZAM-Ramp-1_1-T-1",
             "ZAM_Tjunction-1_42_T-1")
_STATE_FIELDS = ("time_step", "position", "orientation", "velocity",
                 "acceleration", "yaw_rate", "steering_angle")


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_planner(repo_root):
    config = JaxConfig.load(repo_root / "configurations" / f"{SCENARIO}.yaml",
                            f"{SCENARIO}.xml")
    config.general.path_scenarios = str(repo_root / "example_scenarios") + "/"
    config.general.set_path_scenario(f"{SCENARIO}.xml")
    config.update()
    route = JaxRoutePlanner(config.scenario, config.planning_problem) \
        .plan_routes().retrieve_first_route()
    planner = JaxPlanner(config)
    planner.set_reference_path(route.reference_path)
    return planner


def _drive(planner, n_steps):
    """``n_steps`` of the reference replanning loop
    (tests/test_checkpoint.py's)."""
    planner.record_state_and_input(planner.x_0)
    freq = planner.config.planning.replanning_frequency
    optimal = None
    for _ in range(n_steps):
        count = len(planner.record_state_list) - 1
        if count % freq == 0:
            planner.set_desired_velocity(current_speed=planner.x_0.velocity)
            optimal = planner.plan()
            offset = 1
        else:
            offset = 1 + count % freq
        planner.record_state_and_input(optimal[0].state_list[offset])
        planner.reset(initial_state_cart=planner.record_state_list[-1],
                      initial_state_curv=(optimal[2][offset],
                                          optimal[3][offset]),
                      collision_checker=planner.collision_checker,
                      coordinate_system=planner.coordinate_system)
    return planner


def _assert_same_planner_state(got, want):
    """Recorded states and inputs, x_0 and x_0_cl equal, field for field."""
    assert len(got.record_state_list) == len(want.record_state_list)
    for g, w in zip(got.record_state_list + [got.x_0],
                    want.record_state_list + [want.x_0]):
        for field in _STATE_FIELDS:
            np.testing.assert_array_equal(getattr(g, field),
                                          getattr(w, field))
    for g, w in zip(got.record_input_list, want.record_input_list):
        assert (g.time_step, g.acceleration, g.steering_angle_speed) == \
            (w.time_step, w.acceleration, w.steering_angle_speed)
    np.testing.assert_array_equal(np.asarray(got.x_0_cl[0], float),
                                  np.asarray(want.x_0_cl[0], float))
    np.testing.assert_array_equal(np.asarray(got.x_0_cl[1], float),
                                  np.asarray(want.x_0_cl[1], float))


def _assert_same_npz(path_a, path_b):
    a, b = np.load(path_a), np.load(path_b)
    assert sorted(a.files) == sorted(b.files)
    for key in a.files:
        assert a[key].dtype == b[key].dtype, key
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_planner_checkpoint_resume(repo_root, tmp_path):
    planner = _drive(make_planner(load_config(SCENARIO, repo_root),
                                  device="cpu"), 6)
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save_planner_state(planner, path)

    resumed = make_planner(load_config(SCENARIO, repo_root), device="cpu")
    meta = checkpoint.load_planner_state(resumed, path)
    assert meta["scenario"] == planner.config.general.name_scenario
    _assert_same_planner_state(resumed, planner)
    assert resumed.planning_times == planner.planning_times
    resumed.set_desired_velocity(current_speed=resumed.x_0.velocity)
    assert resumed.plan() is not None


def test_planner_checkpoint_crosses_packages(repo_root, tmp_path):
    """A JAX planner's file loads in the port, and the port's in the JAX
    package; each package re-saves what it loaded to the same archive."""
    jax_planner = _drive(_jax_planner(repo_root), 4)
    port_planner = _drive(make_planner(load_config(SCENARIO, repo_root),
                                       device="cpu"), 4)
    for writer, planner, reader, fresh in (
            (jax_checkpoint, jax_planner, checkpoint,
             lambda: make_planner(load_config(SCENARIO, repo_root),
                                  device="cpu")),
            (checkpoint, port_planner, jax_checkpoint,
             lambda: _jax_planner(repo_root))):
        src = str(tmp_path / "src.npz")
        again = str(tmp_path / "again.npz")
        writer.save_planner_state(planner, src)
        loaded = fresh()
        reader.load_planner_state(loaded, src)
        _assert_same_planner_state(loaded, planner)
        reader.save_planner_state(loaded, again)
        _assert_same_npz(src, again)


def _random_carry(seed, F=6):
    rng = np.random.default_rng(seed)
    return dict(x0_lon=rng.random((F, 3), np.float32),
                x0_lat=rng.random((F, 3), np.float32),
                orientation=rng.random(F, np.float32),
                velocity=rng.random(F, np.float32),
                time_step=np.arange(F, dtype=np.int32) * 3,
                alive=rng.random(F) > 0.3,
                kappa=rng.random(F, np.float32),
                px=rng.random(F, np.float32), py=rng.random(F, np.float32))


def test_fleet_carry_roundtrip(tmp_path):
    fields = _random_carry(0)
    carry = FleetCarry(**{f: torch.as_tensor(v) for f, v in fields.items()})
    path = str(tmp_path / "fleet.npz")
    checkpoint.save_fleet_carry(carry, cycle_index=7, path=path)
    restored, cycle = checkpoint.load_fleet_carry(path, device="cpu")
    assert cycle == 7
    for field in FleetCarry._fields:
        got, want = getattr(restored, field), getattr(carry, field)
        assert got.dtype == want.dtype and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    if not torch.cuda.is_available():
        # the device defaults to the card, as the planner's does
        with pytest.raises(RuntimeError, match="device='cpu'"):
            checkpoint.load_fleet_carry(path)


def test_fleet_carry_crosses_packages(tmp_path):
    fields = _random_carry(1)
    jax_carry = JaxFleetCarry(**{f: jnp.asarray(v)
                                 for f, v in fields.items()})
    port_carry = FleetCarry(**{f: torch.as_tensor(v)
                               for f, v in fields.items()})
    jax_path, port_path = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jax_checkpoint.save_fleet_carry(jax_carry, 11, jax_path)
    checkpoint.save_fleet_carry(port_carry, 11, port_path)
    _assert_same_npz(jax_path, port_path)

    from_jax, cycle = checkpoint.load_fleet_carry(jax_path, device="cpu")
    from_port, cycle_j = jax_checkpoint.load_fleet_carry(port_path)
    assert cycle == cycle_j == 11
    assert from_jax._fields == from_port._fields
    for field in FleetCarry._fields:
        want = fields[field]
        for got in (getattr(from_jax, field).numpy(),
                    np.asarray(getattr(from_port, field))):
            assert got.dtype == want.dtype, field
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", SCENARIOS)
def test_scenario_xml_matches_jax_bytes(scenario_dir, tmp_path, name):
    path = scenario_dir / f"{name}.xml"
    scenario, pp_set = read_scenario_xml(path)
    jax_scenario, jax_pp_set = jax_read_scenario(path)
    ours, theirs = tmp_path / "port.xml", tmp_path / "jax.xml"
    scenario_writer.write_scenario_xml(scenario, str(ours), pp_set)
    jax_scenario_writer.write_scenario_xml(jax_scenario, str(theirs),
                                           jax_pp_set)
    assert ours.read_bytes() == theirs.read_bytes()
    # and the file reads back into the same scenario
    again, again_pp = read_scenario_xml(ours)
    assert len(again.lanelet_network.lanelets) == \
        len(scenario.lanelet_network.lanelets)
    assert [o.obstacle_id for o in again.obstacles] == \
        [o.obstacle_id for o in scenario.obstacles]
    assert sorted(again_pp.planning_problem_dict) == \
        sorted(pp_set.planning_problem_dict)


@functools.lru_cache(maxsize=None)
def _port_drive(repo_root):
    planner = make_planner(load_config(SCENARIO, repo_root), device="cpu")
    result = drive_to_goal(planner)
    assert result["goal_reached"] and result["steps"] == 27
    return planner


def test_solution_file_matches_jax_bytes(repo_root, tmp_path):
    planner = _port_drive(repo_root)
    config = planner.config
    solution = evaluation.create_planning_problem_solution(
        config, evaluation.create_full_solution_trajectory(
            config, planner.record_state_list),
        config.scenario, config.planning_problem)

    jax_config = _jax_planner(repo_root).config
    jax_states = [JaxState(**{f: getattr(s, f) for f in _STATE_FIELDS})
                  for s in planner.record_state_list]
    jax_solution = jax_evaluation.create_planning_problem_solution(
        jax_config, jax_evaluation.create_full_solution_trajectory(
            jax_config, jax_states),
        jax_config.scenario, jax_config.planning_problem)

    ours, theirs = tmp_path / "port.xml", tmp_path / "jax.xml"
    solution_writer.write_solution_file(solution, str(ours),
                                        computation_time=1.25)
    jax_solution_writer.write_solution_file(jax_solution, str(theirs),
                                            computation_time=1.25)
    assert ours.read_bytes() == theirs.read_bytes()

    for path, reader in ((ours, solution_writer.read_solution_file),
                         (theirs, solution_writer.read_solution_file),
                         (ours, jax_solution_writer.read_solution_file)):
        back = reader(str(path))
        assert back.scenario_id == solution.scenario_id
        pps, want = back.planning_problem_solutions[0], \
            solution.planning_problem_solutions[0]
        assert (pps.planning_problem_id, pps.vehicle_type, pps.vehicle_model,
                pps.cost_function) == \
            (want.planning_problem_id, want.vehicle_type, want.vehicle_model,
             want.cost_function)
        got_states = pps.trajectory.state_list
        want_states = want.trajectory.state_list
        assert [s.time_step for s in got_states] == \
            [s.time_step for s in want_states]
        for field in ("position", "velocity", "orientation",
                      "steering_angle"):
            np.testing.assert_allclose(
                np.array([getattr(s, field) for s in got_states], float),
                np.array([0.0 if getattr(s, field) is None
                          else getattr(s, field) for s in want_states],
                         float), atol=1e-9, err_msg=field)


def test_checkpointed_fleet_scan_resumes_bit_for_bit(tmp_path):
    """A fused fleet scan of 2n cycles against n cycles, a checkpoint of the
    carry, and n more from the loaded carry: the same final carry and
    per-cycle metrics, bit for bit (the scan's windows follow
    ``carry.time_step``), and the same goal outcome per member."""
    from commonroad_rp_tpu_torch.run_fleet import (heterogeneous_fleet,
                                                   make_scan,
                                                   member_outcomes)

    n = 3
    scene, carry, goals, base_idx = heterogeneous_fleet(12, 2 * n,
                                                        device="cpu")
    full_run, _ = make_scan(scene, 2 * n)
    half_run, _ = make_scan(scene, n)
    full_carry, full_metrics = full_run(carry)
    mid_carry, first = half_run(carry)
    path = str(tmp_path / "fleet.npz")
    checkpoint.save_fleet_carry(mid_carry, n, path)
    loaded, cycle = checkpoint.load_fleet_carry(path, device="cpu")
    assert cycle == n
    end_carry, second = half_run(loaded)
    for field in FleetCarry._fields:
        a, b = getattr(end_carry, field), getattr(full_carry, field)
        assert a.dtype == b.dtype
        assert a.numpy().tobytes() == b.numpy().tobytes(), field
    for a, b, c in zip(first, second, full_metrics):
        both = torch.cat([a, b])
        assert both.dtype == c.dtype and both.shape == c.shape
        assert both.numpy().tobytes() == c.numpy().tobytes()
    resumed = tuple(torch.cat([a, b]) for a, b in zip(first, second))
    assert member_outcomes(resumed, goals, base_idx) == \
        member_outcomes(full_metrics, goals, base_idx)
