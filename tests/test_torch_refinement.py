"""The fused path's exact refinement -- the ``segments`` road-boundary SAT
and the continuous swept-OBB pass -- through ``plan()`` and ``plan_scan``,
held against the JAX package (its Pallas scorer in interpret mode).

* ``plan()`` on the port's default path (the fused level program: the
  scorer with the bounded winner refinement ``ops.cycle.refine_cheapest``,
  continued by the lazy loop past its width) against the JAX
  planner's fused ``plan()`` on ZAM_Over's first cycle: the winner's states
  to 1e-4, its cost to rtol 2e-4, identical counters and reason dicts.
* ``plan_scan`` (the bounded refinement ``ops.cycle.refine_cheapest``)
  against the JAX package's ``plan_scan`` (its ``while_loop`` over winners)
  driving ZAM_Over to the goal from the same curvilinear state, at the bar
  of ``tests/test_torch_plan_scan.py``.
* The obstacle window the scan hands the continuous pass
  (``replanning_scan.window_obstacle_arrays``) against the JAX scan's
  ``dynamic_slice`` window with ``window_valid & in_span``, on DEU_Test's
  dynamic obstacles, inside and past the prediction span.
* The scan's bound of ``REFINE_WIDTH`` re-selections per cycle: the four
  bundled scenarios driven to their goals through ``plan_scan`` in both
  modes, in the JAX package's step counts, with the largest per-cycle count
  of re-selections pinned.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commonroad_rp_tpu.models.planner import ReactivePlanner as JaxPlanner
from commonroad_rp_tpu.utils.config import \
    ReactivePlannerConfiguration as JaxConfig
from commonroad_rp_tpu.utils.route import RoutePlanner as JaxRoutePlanner

from commonroad_rp_tpu.ops import collision as jax_collision

from commonroad_rp_tpu_torch import interop
from commonroad_rp_tpu_torch.parallel import replanning_scan
from commonroad_rp_tpu_torch.ops.cycle import REFINE_WIDTH
from commonroad_rp_tpu_torch.run_planner import load_config, make_planner

from tests.test_torch_plan_scan import _assert_drives_match, _drive

logging.getLogger("RP_LOGGER").setLevel(logging.CRITICAL)

SCENARIO = "ZAM_Over-1_1"
MODES = {"segments": dict(boundary_mode="segments"),
         "continuous": dict(continuous_collision_check=True)}
# plan_scan cycles and steps to the goal (replanning frequency 3), the JAX
# package's counts (tests/test_planner_e2e.py)
GOAL_CYCLES = {"ZAM_Over-1_1": (9, 27), "DEU_Test-1_1_T-1": (12, 35),
               "ZAM-Ramp-1_1-T-1": (15, 44),
               "ZAM_Tjunction-1_42_T-1": (49, 146)}
# the largest number of winners the refinement masks in one cycle of those
# drives; every other scenario and mode needs none
MAX_RESELECTIONS = {("ZAM_Over-1_1", "segments"): 1,
                    ("ZAM_Tjunction-1_42_T-1", "segments"): 4}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread per test: the scans issue thousands of small ops,
    and test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_planner(repo_root, mode, name=SCENARIO):
    config = JaxConfig.load(repo_root / "configurations" / f"{name}.yaml",
                            f"{name}.xml")
    config.general.path_scenarios = str(repo_root / "example_scenarios") + "/"
    config.general.set_path_scenario(f"{name}.xml")
    config.update()
    config.debug.fast_scoring = True
    config.debug.kernel_dtype = "float32"
    for key, value in MODES[mode].items():
        setattr(config.planning, key, value)
    route = JaxRoutePlanner(config.scenario, config.planning_problem) \
        .plan_routes().retrieve_first_route()
    planner = JaxPlanner(config)
    planner.set_reference_path(route.reference_path)
    return planner


def _port_planner(repo_root, mode, name=SCENARIO):
    config = load_config(name, repo_root)
    config.debug.fast_scoring = True
    config.debug.kernel_dtype = "float32"
    for key, value in MODES[mode].items():
        setattr(config.planning, key, value)
    return make_planner(config, device="cpu")


def _first_cycle(planner):
    planner.set_desired_velocity(current_speed=planner.x_0.velocity)
    result = planner.plan()
    assert result is not None
    states = result[0].state_list
    return dict(position=np.array([s.position for s in states]),
                velocity=np.array([s.velocity for s in states]),
                orientation=np.array([s.orientation for s in states]),
                cost=planner.optimal_cost,
                counters=(planner.infeasible_count_kinematics,
                          planner.infeasible_count_collision),
                reasons={k: v for k, v in
                         planner.infeasible_reason_dict.items() if v})


@pytest.mark.parametrize("mode", sorted(MODES))
def test_fused_plan_mode_matches_jax(repo_root, mode):
    port = _port_planner(repo_root, mode)
    assert port._kernel_ok()
    want = _first_cycle(_jax_planner(repo_root, mode))
    got = _first_cycle(port)
    np.testing.assert_allclose(got["cost"], want["cost"], rtol=2e-4)
    for field in ("position", "velocity", "orientation"):
        np.testing.assert_allclose(got[field], want[field], rtol=0,
                                   atol=1e-4, err_msg=field)
    assert got["counters"] == want["counters"]
    assert got["reasons"] == want["reasons"]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_plan_scan_mode_matches_jax(repo_root, mode):
    jax_planner = _jax_planner(repo_root, mode)
    x0_cl = jax_planner._compute_initial_states(jax_planner.x_0)
    want = _drive(jax_planner, x0_cl, 14)
    got = _drive(_port_planner(repo_root, mode), x0_cl, 14)
    assert want[0]["goal_reached"] and want[0]["steps"] == 27
    _assert_drives_match(want, got)
    assert got[0]["n_inf_kinematics"] == want[0]["n_inf_kinematics"]
    assert got[0]["n_inf_collision"] == want[0]["n_inf_collision"]


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("name", sorted(GOAL_CYCLES))
def test_plan_scan_refinement_within_bound(repo_root, name, mode):
    """No cycle comes near ``REFINE_WIDTH`` (a cycle past it would raise);
    the per-cycle counts are the lazy loop's re-selections."""
    cycles, steps = GOAL_CYCLES[name]
    planner = _port_planner(repo_root, mode, name)
    planner.set_desired_velocity(current_speed=planner.x_0.velocity)
    planner.record_state_and_input(planner.x_0)
    info = planner.plan_scan(cycles + 3)
    assert info["goal_reached"]
    assert (info["cycles_run"], info["steps"]) == (cycles, steps)
    assert len(info["reselections"]) == cycles
    assert max(info["reselections"]) == MAX_RESELECTIONS.get((name, mode), 0)
    assert max(info["reselections"]) < REFINE_WIDTH


@pytest.mark.parametrize("time_step", [0, 9, 30, 41, 70])
def test_continuous_window_matches_jax(repo_root, time_step):
    """DEU_Test's full-span obstacle tables (the span of a 20-cycle scan,
    steps 0..81), windowed at ``time_step`` as both scans window them; the
    last window starts past the table, so it is clamped and its late steps
    fall outside the span."""
    planner = _jax_planner(repo_root, "continuous", "DEU_Test-1_1_T-1")
    T, span = planner.N + 1, 60 + planner.N + 1
    full = jax_collision.compile_obstacles(planner._cc.scenario, 0, span, 1,
                                           dtype=jnp.float32)
    t_full = span + 1
    assert full.pose.shape[:2] == (2, t_full) and full.poly_verts is None
    with jax.enable_x64(False):
        ts = jnp.int32(time_step)
        want_pose = np.asarray(jax.lax.dynamic_slice_in_dim(
            full.pose, ts, T, axis=1))
        in_span = ts + jnp.arange(T, dtype=jnp.int32) < t_full
        want_valid = np.asarray(jax.lax.dynamic_slice_in_dim(
            full.valid, ts, T, axis=1) & in_span[None, :])
    # DEU_Test's predictions cover the span: only steps past it are invalid
    assert want_valid.all() == (time_step + T <= t_full) and want_valid.any()

    full_t = interop.obstacles(full, dtype=torch.float32)
    obs_tab, t_obs, _, _, V, t_full = \
        replanning_scan._obstacle_window_tables(full_t, T, "cpu")
    rows = replanning_scan._table_rows(
        torch.tensor(time_step, dtype=torch.int32), T, t_obs, t_full)
    got = replanning_scan.window_obstacle_arrays(
        obs_tab[:, rows], None, full_t.half_ext, full_t.radius, V)
    np.testing.assert_array_equal(got.valid.numpy(), want_valid)
    np.testing.assert_array_equal(got.pose.numpy()[want_valid],
                                  want_pose[want_valid])
    np.testing.assert_array_equal(got.half_ext.numpy(),
                                  np.asarray(full.half_ext))
    assert got.poly_verts is None and got.radius is None
