"""The conformance level program: the port against the JAX package.

* ``evaluate_level`` in float64 on ZAM_Over's level-2 bundle (K=540, with
  colliding candidates), fed the JAX planner's exact inputs through
  ``commonroad_rp_tpu_torch.interop``, in the corridor, ``segments`` and
  continuous modes: identical [3, K] masks, winner index and counters, costs
  and the winner's [14, T] states to rtol 1e-9.
* The float64 conformance ``plan()`` reproduces the JAX package's
  first-cycle goldens for all four scenarios at the tolerances of
  ``tests/test_precision_and_golden.py:125-136``.
* ``plan()`` with ``boundary_mode: segments`` and with
  ``continuous_collision_check: True`` gives the JAX package's first-cycle
  winner and counters (float64 conformance path in both), and so does the
  float32 conformance path (``fast_scoring: False``); the fused path's lazy
  winner refinement gives the conformance path's winner.
* ``plan_scan`` in each mode gives the port's host loop's states (the bar of
  ``tests/test_plan_scan_modes.py``).
"""

import functools
import logging

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from commonroad_rp_tpu.models import cost_functions as jax_cf
from commonroad_rp_tpu.models.planner import ReactivePlanner as JaxPlanner
from commonroad_rp_tpu.ops import cycle as jax_cycle
from commonroad_rp_tpu.utils.config import \
    ReactivePlannerConfiguration as JaxConfig
from commonroad_rp_tpu.utils.route import RoutePlanner as JaxRoutePlanner

from commonroad_rp_tpu_torch import interop
from commonroad_rp_tpu_torch.models import cost_functions as port_cf
from commonroad_rp_tpu_torch.ops import collision_kernel
from commonroad_rp_tpu_torch.ops import cost as cost_ops
from commonroad_rp_tpu_torch.ops import cycle as port_cycle
from commonroad_rp_tpu_torch.ops import scoring
from commonroad_rp_tpu_torch.run_planner import (drive_to_goal, load_config,
                                                 make_planner)

logging.getLogger("RP_LOGGER").setLevel(logging.CRITICAL)


@pytest.fixture(autouse=True)
def one_thread():
    """Run each test's tensor ops on one intra-op thread: the planner and
    scan tests issue thousands of mid-sized ops, and with test workers
    sharing the cores every multi-threaded op waits for its slowest
    thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SCENARIO = "ZAM_Over-1_1"
MODES = {"corridor": ("corridor", False), "segments": ("segments", False),
         "continuous": ("corridor", True)}

# Copied from tests/test_precision_and_golden.py:61-95 (_GOLDEN_FIRST_CYCLE,
# recorded from the JAX package's float64 conformance path on the CPU).
_GOLDEN_FIRST_CYCLE = {
    "ZAM_Over-1_1": dict(
        cost=3733.4777003862982,
        end_position=(67.81315751831903, 4.149639636126384),
        end_velocity=19.508531368656065,
        end_orientation=0.08752291224665676,
        infeasible_kinematics=45, infeasible_collision=44,
        reason_dict={"acceleration": 2, "kappa_dot": 43}),
    "DEU_Test-1_1_T-1": dict(
        cost=79.28082121119598,
        end_position=(57.224441656399875, 2.0000000000000067),
        end_velocity=11.606224999999998,
        end_orientation=3.297691703707007e-16,
        infeasible_kinematics=76, infeasible_collision=0,
        reason_dict={"acceleration": 18, "kappa_dot": 52, "yaw_rate": 6}),
    "ZAM-Ramp-1_1-T-1": dict(
        cost=305733.87850203505,
        end_position=(6.327282906400004, 1.7499999999999991),
        end_velocity=5.000000000000005,
        end_orientation=6.86410096761853e-17,
        infeasible_kinematics=68, infeasible_collision=0,
        reason_dict={"acceleration": 12, "kappa": 12, "kappa_dot": 44}),
    "ZAM_Tjunction-1_42_T-1": dict(
        cost=43.12236764498027,
        end_position=(-0.6221825578422608, 0.021638369718770756),
        end_velocity=5.240995600000005,
        end_orientation=-0.03976196117155634,
        infeasible_kinematics=63, infeasible_collision=0,
        reason_dict={"kappa_dot": 63}),
}


def _jax_planner(repo_root, dtype="float64", **planning):
    config = JaxConfig.load(repo_root / "configurations" / f"{SCENARIO}.yaml",
                            f"{SCENARIO}.xml")
    config.general.path_scenarios = str(repo_root / "example_scenarios") + "/"
    config.general.set_path_scenario(f"{SCENARIO}.xml")
    config.update()
    config.debug.fast_scoring = False
    config.debug.kernel_dtype = dtype
    for key, value in planning.items():
        setattr(config.planning, key, value)
    route = JaxRoutePlanner(config.scenario, config.planning_problem) \
        .plan_routes().retrieve_first_route()
    planner = JaxPlanner(config)
    planner.set_reference_path(route.reference_path)
    planner.set_desired_velocity(current_speed=planner.x_0.velocity)
    return planner


def _port_planner(repo_root, dtype="float64", fast=False, **planning):
    config = load_config(SCENARIO, repo_root)
    config.debug.fast_scoring = fast
    config.debug.kernel_dtype = dtype
    for key, value in planning.items():
        setattr(config.planning, key, value)
    return make_planner(config, device="cpu")


@functools.lru_cache(maxsize=None)
def _level_inputs(repo_root, level=2):
    """ZAM_Over's first-cycle bundle of one level and the JAX planner's
    float64 scene context."""
    planner = _jax_planner(repo_root)
    planner.x_0_cl = planner._compute_initial_states(planner.x_0)
    planner._low_vel_mode = False
    batch = planner._create_trajectory_bundle(*planner.x_0_cl, level)
    ctx = planner._scene_context()
    assert ctx["boundary_mode"] == "corridor"
    corridor = planner._cc.corridor_for(planner._co)
    return dict(batch=batch, goal_valid=planner._goal_valid_mask(batch),
                ref=planner._co.tables, veh=ctx["veh"],
                obstacles=ctx["obstacles"], boundary=ctx["boundary"],
                corridor=corridor, x0_orientation=planner.x_0.orientation,
                cost_params=ctx["cost_params"], dt=planner.dt,
                n_steps=planner.N, flags=ctx["flags"],
                cost_structure=planner.cost_function.structure)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_evaluate_level_matches_jax_float64(repo_root, mode):
    c = _level_inputs(repo_root)
    boundary_mode, continuous = MODES[mode]
    b, f64 = c["batch"], torch.float64
    static = dict(dt=c["dt"], n_steps=c["n_steps"], low_vel_mode=False,
                  cost_structure=c["cost_structure"],
                  constraint_flags=c["flags"], boundary_mode=boundary_mode,
                  continuous_check=continuous)
    segments = boundary_mode == "segments"
    want = jax_cycle.evaluate_level(
        jnp.asarray(b.coeffs_lon, jnp.float64),
        jnp.asarray(b.coeffs_lat, jnp.float64), jnp.asarray(b.traj_len),
        jnp.asarray(c["goal_valid"]), c["ref"], c["veh"], c["obstacles"],
        c["boundary"] if segments else None,
        None if segments else c["corridor"],
        jnp.asarray(c["x0_orientation"], jnp.float64), c["cost_params"],
        **static)
    cl, ca, tl, gv = interop.candidates(b.coeffs_lon, b.coeffs_lat,
                                        b.traj_len, c["goal_valid"],
                                        dtype=f64)
    got = port_cycle.evaluate_level(
        cl, ca, tl, gv, interop.ref_tables(c["ref"], dtype=f64),
        interop.vehicle(c["veh"]), interop.obstacles(c["obstacles"],
                                                     dtype=f64),
        interop.boundary(c["boundary"], dtype=f64) if segments else None,
        None if segments else interop.corridor(c["corridor"], dtype=f64),
        float(c["x0_orientation"]), interop.cost_params(c["cost_params"]),
        **static)
    masks = np.asarray(want.masks)
    assert 0 < masks[1].sum() < masks.shape[1], "degenerate test"
    assert bool(got.found) == bool(want.found)
    np.testing.assert_array_equal(got.masks.numpy(), masks)
    ws, gs = np.asarray(want.scalars), got.scalars.numpy()
    np.testing.assert_array_equal(gs[[0, 2, 3]], ws[[0, 2, 3]])
    np.testing.assert_allclose(gs[1], ws[1], rtol=1e-9)
    np.testing.assert_allclose(got.costs.numpy(), np.asarray(want.costs),
                               rtol=1e-9)
    np.testing.assert_allclose(got.optimal.numpy(), np.asarray(want.optimal),
                               rtol=1e-9, atol=1e-9)
    for field in ("x", "y", "theta_gl", "v", "feasible", "reason"):
        np.testing.assert_allclose(
            getattr(got.rollout, field).numpy(),
            np.asarray(getattr(want.rollout, field)), rtol=1e-9, atol=1e-9,
            err_msg=field)


def test_cost_functions_match_jax(repo_root):
    """``evaluate_batch`` of the default cost (speed target, stop target,
    both) and the fail-safe cost on one float64 rollout, both packages; the
    JAX package evaluates no other cost structure on any path, and neither
    does the port."""
    c = _level_inputs(repo_root)
    jax_ro = jax_cycle.evaluate_level(
        jnp.asarray(c["batch"].coeffs_lon, jnp.float64),
        jnp.asarray(c["batch"].coeffs_lat, jnp.float64),
        jnp.asarray(c["batch"].traj_len), jnp.asarray(c["goal_valid"]),
        c["ref"], c["veh"], c["obstacles"], None, c["corridor"],
        jnp.asarray(c["x0_orientation"], jnp.float64), c["cost_params"],
        dt=c["dt"], n_steps=c["n_steps"], low_vel_mode=False,
        cost_structure=c["cost_structure"], constraint_flags=c["flags"],
        boundary_mode="corridor").rollout
    ro = interop.rollout(jax_ro)
    for speed, stop in ((18.0, None), (None, 95.0), (12.5, 60.0)):
        want = jax_cf.DefaultCostFunction(speed, 0.3, stop)
        got = port_cf.DefaultCostFunction(speed, 0.3, stop)
        assert got.structure == want.structure
        np.testing.assert_allclose(got.evaluate_batch(ro).numpy(),
                                   np.asarray(want.evaluate_batch(jax_ro)),
                                   rtol=1e-12)
    np.testing.assert_allclose(
        port_cf.DefaultCostFunctionFailSafe().evaluate_batch(ro).numpy(),
        np.asarray(jax_cf.DefaultCostFunctionFailSafe()
                   .evaluate_batch(jax_ro)), rtol=1e-12)
    params = interop.cost_params(c["cost_params"])
    with pytest.raises(ValueError, match="unknown cost structure"):
        cost_ops.structure_costs(ro, ("custom",), params)


@pytest.mark.parametrize("name", sorted(_GOLDEN_FIRST_CYCLE))
def test_golden_first_cycle(repo_root, name):
    golden = _GOLDEN_FIRST_CYCLE[name]
    config = load_config(name, repo_root)
    config.debug.kernel_dtype = "float64"
    planner = make_planner(config, device="cpu")
    planner.set_desired_velocity(current_speed=planner.x_0.velocity)
    before = (scoring.score_candidates.launches,
              collision_kernel.obb_collision.launches)
    result = planner.plan()
    assert result is not None and not planner._kernel_ok()
    assert (scoring.score_candidates.launches,
            collision_kernel.obb_collision.launches) == before
    cart = result[0].state_list
    assert len(cart) == planner.N + 1
    np.testing.assert_allclose(planner.optimal_cost, golden["cost"],
                               rtol=1e-9)
    np.testing.assert_allclose(cart[-1].position, golden["end_position"],
                               rtol=0, atol=1e-7)
    np.testing.assert_allclose(cart[-1].velocity, golden["end_velocity"],
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(cart[-1].orientation,
                               golden["end_orientation"], rtol=0, atol=1e-9)
    assert planner.infeasible_count_kinematics == \
        golden["infeasible_kinematics"]
    assert planner.infeasible_count_collision == \
        golden["infeasible_collision"]
    got_reasons = {k: v for k, v in planner.infeasible_reason_dict.items()
                   if v}
    assert got_reasons == golden["reason_dict"]


def _first_cycle(planner):
    result = planner.plan()
    assert result is not None
    states = result[0].state_list
    return dict(position=np.array([s.position for s in states]),
                velocity=np.array([s.velocity for s in states]),
                cost=planner.optimal_cost,
                counters=(planner.infeasible_count_kinematics,
                          planner.infeasible_count_collision),
                reasons={k: v for k, v in
                         planner.infeasible_reason_dict.items() if v})


@functools.lru_cache(maxsize=None)
def _port_first_cycle(repo_root, mode, dtype="float64", fast=False):
    boundary_mode, continuous = MODES[mode]
    planner = _port_planner(repo_root, dtype, fast,
                            boundary_mode=boundary_mode,
                            continuous_collision_check=continuous)
    planner.set_desired_velocity(current_speed=planner.x_0.velocity)
    return _first_cycle(planner)


@pytest.mark.parametrize("mode", ["segments", "continuous"])
def test_plan_mode_matches_jax(repo_root, mode):
    boundary_mode, continuous = MODES[mode]
    want = _first_cycle(_jax_planner(repo_root, boundary_mode=boundary_mode,
                                     continuous_collision_check=continuous))
    got = _port_first_cycle(repo_root, mode)
    np.testing.assert_allclose(got["cost"], want["cost"], rtol=1e-9)
    for field in ("position", "velocity"):
        np.testing.assert_allclose(got[field], want[field], rtol=0,
                                   atol=1e-7, err_msg=field)
    assert got["counters"] == want["counters"]
    assert got["reasons"] == want["reasons"]


def test_plan_float32_conformance_matches_jax(repo_root):
    """``fast_scoring: False`` in float32: the conformance level program in
    the fused path's dtype, both packages (float32 sums in another order:
    cost rtol 2e-4, states 1e-4)."""
    want = _first_cycle(_jax_planner(repo_root, "float32"))
    got = _port_first_cycle(repo_root, "corridor", "float32", fast=False)
    np.testing.assert_allclose(got["cost"], want["cost"], rtol=2e-4)
    for field in ("position", "velocity"):
        np.testing.assert_allclose(got[field], want[field], rtol=0,
                                   atol=1e-4, err_msg=field)
    assert got["counters"] == want["counters"]
    assert got["reasons"] == want["reasons"]


@pytest.mark.parametrize("mode", ["segments", "continuous"])
def test_fused_refinement_matches_conformance(repo_root, mode):
    """The fused float32 path's lazy winner refinement selects the float32
    conformance program's winner (tests/test_plan_scan_modes.py:128-153)."""
    want = _port_first_cycle(repo_root, mode, "float32", fast=False)
    got = _port_first_cycle(repo_root, mode, "float32", fast=True)
    np.testing.assert_allclose(got["position"], want["position"], atol=1e-4)
    assert got["counters"][1] == want["counters"][1]


@pytest.mark.parametrize("mode", ["segments", "continuous"])
def test_plan_scan_mode_matches_host_loop(repo_root, mode):
    boundary_mode, continuous = MODES[mode]
    settings = dict(boundary_mode=boundary_mode,
                    continuous_collision_check=continuous)
    host = _port_planner(repo_root, "float32", True, **settings)
    result = drive_to_goal(host, max_steps=60)
    assert result["goal_reached"] and result["steps"] == 27
    planner = _port_planner(repo_root, "float32", True, **settings)
    planner.set_desired_velocity(current_speed=planner.x_0.velocity)
    planner.record_state_and_input(planner.x_0)
    info = planner.plan_scan(9)
    assert info["goal_reached"] and info["steps"] == result["steps"]
    for a, b in zip(host.record_state_list, planner.record_state_list):
        assert a.time_step == b.time_step
        np.testing.assert_allclose(b.position, a.position, atol=5e-3)
        np.testing.assert_allclose(b.velocity, a.velocity, atol=5e-3)


def test_conformance_drive_reaches_goal(repo_root):
    """The float64 conformance path drives ZAM_Over to its goal in the JAX
    package's 27 steps, one level evaluation per cycle."""
    config = load_config(SCENARIO, repo_root)
    config.debug.kernel_dtype = "float64"
    planner = make_planner(config, device="cpu")
    result = drive_to_goal(planner, max_steps=100)
    assert result["goal_reached"] and result["steps"] == 27
    assert result["plan_calls"] == 9


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_refine_cheapest_matches_lazy_loop(seed):
    """The bounded refinement gives the lazy winner loop's masked row,
    selection, counters and number of re-selections (the loop of
    ``evaluate_levels_fast``: select, check, mask, repeat), and flags
    overflow when every checked candidate collides."""
    from commonroad_rp_tpu_torch.ops.cycle import refine_cheapest

    rng = np.random.default_rng(seed)
    K, n_levels = 90, 3
    kin = torch.tensor(np.where(rng.random(K) < 0.2, np.inf,
                                np.round(rng.uniform(0, 50, K), 1)))
    masked = torch.where(torch.tensor(rng.random(K) < 0.3),
                         torch.tensor(np.inf, dtype=kin.dtype), kin)
    masked[3] = np.nan
    levels = torch.tensor(rng.integers(0, n_levels, K))
    goal = torch.ones(K, dtype=torch.bool)
    exact_hit = torch.tensor(rng.random(K) < 0.6)
    # the first winner collides: at least one re-selection
    exact_hit[port_cycle.select_across_levels(masked, kin, goal, levels,
                                              n_levels)[1]] = True

    want, n_masked = masked.clone(), 0
    while True:
        found, idx, *_ = port_cycle.select_across_levels(want, kin, goal,
                                                         levels, n_levels)
        if not bool(found) or not bool(exact_hit[idx]):
            break
        want[idx] = np.inf
        n_masked += 1
    for width, overflow in ((K, False), (1, True)):
        got, reselections, flag = refine_cheapest(
            masked, kin, goal, levels, n_levels, width, lambda idx: idx,
            lambda idx: exact_hit[idx])
        assert bool(flag) == overflow
        assert int(reselections) == min(n_masked, width)
        if not overflow:
            # the colliding run at the head of the order is masked: the
            # lazy loop's row itself
            assert torch.equal(got.isnan(), want.isnan())
            assert torch.equal(got.nan_to_num(), want.nan_to_num())
            for a, b in zip(port_cycle.select_across_levels(
                    got, kin, goal, levels, n_levels),
                    port_cycle.select_across_levels(
                        want, kin, goal, levels, n_levels)):
                assert torch.equal(a, b)
