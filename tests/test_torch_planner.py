"""The ReactivePlanner facade: the port against the JAX package end to end.

ZAM_Over-1_1 runs three replanning cycles in both packages (JAX on its fused
Pallas path in interpret mode, the port on CPU tensors through the plain
scorer), fed the same curvilinear initial state (the JAX package projects it
with its C++ module, the port with numpy).  Each cycle's planned states,
cost, rejection counters and reason dict match.  Then the port alone drives
the scenario to its goal in 27 steps, as the JAX fast path does.
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

from commonroad_rp_tpu_torch.models.cost_functions import (
    CostFunction, DefaultCostFunctionFailSafe)
from commonroad_rp_tpu_torch.models.planner import ReactivePlanner
from commonroad_rp_tpu_torch.ops import scoring
from commonroad_rp_tpu_torch.run_planner import (drive_to_goal, load_config,
                                                 make_planner)

logging.getLogger("RP_LOGGER").setLevel(logging.CRITICAL)

SCENARIO = "ZAM_Over-1_1"
N_CYCLES = 3


def _jax_planner(repo_root):
    config = JaxConfig.load(repo_root / "configurations" / f"{SCENARIO}.yaml",
                            f"{SCENARIO}.xml")
    config.general.path_scenarios = str(repo_root / "example_scenarios") + "/"
    config.general.set_path_scenario(f"{SCENARIO}.xml")
    config.update()
    config.debug.fast_scoring = True
    config.debug.kernel_dtype = "float32"
    route = JaxRoutePlanner(config.scenario, config.planning_problem) \
        .plan_routes().retrieve_first_route()
    planner = JaxPlanner(config)
    planner.set_reference_path(route.reference_path)
    return planner


def _cycles(planner, x0_cl, n_cycles):
    """The replanning loop for ``n_cycles`` plan() calls; per cycle the planned
    Cartesian states, cost, counters and reason dict."""
    planner.x_0_cl = x0_cl
    planner.record_state_and_input(planner.x_0)
    freq = planner.config.planning.replanning_frequency
    out = []
    optimal = None
    while len(out) < n_cycles or \
            (len(planner.record_state_list) - 1) % freq != 0:
        count = len(planner.record_state_list) - 1
        if count % freq == 0:
            planner.set_desired_velocity(current_speed=planner.x_0.velocity)
            optimal = planner.plan()
            assert optimal is not None
            out.append(dict(
                position=np.array([s.position for s in optimal[0].state_list]),
                velocity=np.array([s.velocity for s in optimal[0].state_list]),
                orientation=np.array([s.orientation
                                      for s in optimal[0].state_list]),
                cost=planner.optimal_cost,
                n_kin=planner.infeasible_count_kinematics,
                n_coll=planner.infeasible_count_collision,
                reasons=dict(planner.infeasible_reason_dict)))
            offset = 1
        else:
            offset = 1 + count % freq
        planner.record_state_and_input(optimal[0].state_list[offset])
        planner.reset(initial_state_cart=planner.record_state_list[-1],
                      initial_state_curv=(optimal[2][offset],
                                          optimal[3][offset]),
                      collision_checker=planner.collision_checker,
                      coordinate_system=planner.coordinate_system)
    return out


@functools.lru_cache(maxsize=None)
def _both(repo_root):
    jax_planner = _jax_planner(repo_root)
    x0_cl = jax_planner._compute_initial_states(jax_planner.x_0)
    port = make_planner(load_config(SCENARIO, repo_root), device="cpu")
    port_x0 = port._compute_initial_states(port.x_0)
    np.testing.assert_allclose(np.concatenate(port_x0),
                               np.concatenate(x0_cl), rtol=0, atol=1e-9)
    return (_cycles(jax_planner, x0_cl, N_CYCLES),
            _cycles(port, x0_cl, N_CYCLES))


@pytest.mark.parametrize("cycle", range(N_CYCLES))
def test_planned_states_match(repo_root, cycle):
    want, got = (runs[cycle] for runs in _both(repo_root))
    for field in ("position", "velocity", "orientation"):
        np.testing.assert_allclose(got[field], want[field], rtol=0,
                                   atol=1e-4, err_msg=field)


@pytest.mark.parametrize("cycle", range(N_CYCLES))
def test_cost_counters_and_reasons_match(repo_root, cycle):
    want, got = (runs[cycle] for runs in _both(repo_root))
    assert got["cost"] == pytest.approx(want["cost"], rel=2e-4)
    assert got["n_kin"] == want["n_kin"]
    assert got["n_coll"] == want["n_coll"]
    assert got["reasons"] == want["reasons"]


def test_port_drives_to_goal_in_27_steps(repo_root):
    planner = make_planner(load_config(SCENARIO, repo_root), device="cpu")
    before = scoring.score_candidates.launches
    result = drive_to_goal(planner, max_steps=100)
    assert result["goal_reached"]
    assert result["steps"] == 27
    assert result["plan_calls"] == 9
    # CPU tensors run the plain scorer: no kernel launch is counted
    assert scoring.score_candidates.launches == before


@pytest.mark.parametrize("setting", [
    ("debug", "fast_scoring", False), ("debug", "kernel_dtype", "float64"),
    ("planning", "boundary_mode", "segments"),
    ("planning", "continuous_collision_check", True)])
def test_unported_configurations_raise(repo_root, setting):
    """The four configurations that raised before the conformance level
    program was ported now plan (the name is that test's): the first two
    through ``evaluate_level`` (in float32 and float64), the other two on
    the fused path with the lazy winner refinement.  An unknown dtype or
    boundary mode still raises.  This only checks that each path runs; the
    comparisons with the JAX package are
    ``test_torch_conformance.test_plan_float32_conformance_matches_jax``
    (``fast_scoring: False``), ``test_torch_conformance.test_golden_first_cycle``
    (``kernel_dtype: float64``) and
    ``test_torch_refinement.test_fused_plan_mode_matches_jax`` (``segments``,
    continuous)."""
    config = load_config(SCENARIO, repo_root)
    section, key, value = setting
    setattr(getattr(config, section), key, value)
    planner = make_planner(config, device="cpu")
    assert planner._kernel_ok() == (section == "planning")
    assert planner._dtype == (torch.float64 if value == "float64"
                              else torch.float32)
    planner.set_desired_velocity(current_speed=planner.x_0.velocity)
    assert planner.plan() is not None
    assert planner.infeasible_count_kinematics > 0
    if key in ("kernel_dtype", "boundary_mode"):
        setattr(getattr(config, section), key, "bogus")
        with pytest.raises(ValueError, match=f"unknown {key}"):
            ReactivePlanner(config, device="cpu")


def test_draw_traj_set_and_custom_cost_raise(repo_root):
    """``draw_traj_set`` with plots raised until trajectory-set capture was
    ported (the name is that test's): now it plans and stores the selected
    level's bundle (compared with the JAX package in
    ``tests/test_torch_capture.py``).  A custom cost structure still
    raises."""
    config = load_config(SCENARIO, repo_root)
    config.debug.draw_traj_set = True
    config.debug.save_plots = True
    planner = make_planner(config, device="cpu")
    planner.set_desired_velocity(current_speed=planner.x_0.velocity)
    assert planner.plan() is not None
    assert planner.stored_trajectories.x.shape[0] == \
        len(planner.stored_trajectories.labels) > 0

    class Custom(CostFunction):
        structure = ("custom",)

    planner = ReactivePlanner(load_config(SCENARIO, repo_root), device="cpu")
    # the JAX package evaluates no other cost structure on any path
    with pytest.raises(ValueError, match="unknown cost structure"):
        planner.set_cost_function(Custom())
    planner.set_cost_function(DefaultCostFunctionFailSafe())   # supported


def test_device_defaults_and_explicit_cuda(repo_root):
    """The default device is the card: with one, the planner runs there;
    without one, the default and an explicit ``cuda`` raise (nothing
    carries on on the CPU unasked) and ``device="cpu"`` plans."""
    if torch.cuda.is_available():
        planner = ReactivePlanner(load_config(SCENARIO, repo_root))
        assert planner.device.type == "cuda"
        return
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ReactivePlanner(load_config(SCENARIO, repo_root), device=device)
    # the command lines default to the card too
    from commonroad_rp_tpu_torch import run_fleet, run_planner
    for cli in (run_planner, run_fleet):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main([])
    planner = make_planner(load_config(SCENARIO, repo_root), device="cpu")
    assert planner.device.type == "cpu"
    planner.set_desired_velocity(current_speed=planner.x_0.velocity)
    assert planner.plan() is not None


def _jax_run_script_levels_outside(planner, x0_cl, n_steps):
    """The JAX run script's loop with ``--sampling-iteration-outside``
    (run_planner.py:313-355, the per-level escalation at :331-338) for
    ``n_steps`` steps; returns the driven states."""
    planner.x_0_cl = x0_cl
    planner.record_state_and_input(planner.x_0)
    freq = planner.config.planning.replanning_frequency
    optimal = None
    while len(planner.record_state_list) - 1 < n_steps:
        count = len(planner.record_state_list) - 1
        if count % freq == 0:
            planner.set_desired_velocity(current_speed=planner.x_0.velocity)
            optimal = None
            level = 1
            while optimal is None and level < planner.sampling_level:
                optimal = planner.plan(level)
                level += 1
            assert optimal
            offset = 1
        else:
            offset = 1 + count % freq
        planner.record_state_and_input(optimal[0].state_list[offset])
        planner.reset(initial_state_cart=planner.record_state_list[-1],
                      initial_state_curv=(optimal[2][offset],
                                          optimal[3][offset]),
                      collision_checker=planner.collision_checker,
                      coordinate_system=planner.coordinate_system)
    return planner.record_state_list


def test_sampling_iteration_outside_matches_jax_run_script(repo_root):
    """``drive_to_goal(sampling_iteration_outside=True)`` (the port's
    ``--sampling-iteration-outside``) selects the JAX run script's states over
    the first 3 replanning cycles of ZAM_Over-1_1, from the same
    curvilinear initial state, at the bar of the plan() comparison above
    (atol 1e-4)."""
    jax_planner = _jax_planner(repo_root)
    x0_cl = jax_planner._compute_initial_states(jax_planner.x_0)
    port = make_planner(load_config(SCENARIO, repo_root), device="cpu")
    n_steps = N_CYCLES * port.config.planning.replanning_frequency
    want = _jax_run_script_levels_outside(jax_planner, x0_cl, n_steps)
    port.x_0_cl = x0_cl
    levels = []
    plan = port.plan
    port.plan = lambda level=None: (levels.append(level), plan(level))[1]
    result = drive_to_goal(port, max_steps=n_steps,
                           sampling_iteration_outside=True)
    got = port.record_state_list
    assert result["steps"] == len(want) - 1 == n_steps
    # every cycle asked for a level: the loop escalated, not plan()
    assert len(levels) == result["plan_calls"] >= N_CYCLES
    assert None not in levels
    for field in ("position", "velocity", "orientation"):
        np.testing.assert_allclose(
            np.array([getattr(s, field) for s in got], float),
            np.array([getattr(s, field) for s in want], float), rtol=0,
            atol=1e-4, err_msg=field)
