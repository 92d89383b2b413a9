"""One fused planning cycle: ``evaluate_levels_fast`` in both packages.

The JAX planner prepares each scenario's first cycle (every sampling level's
candidates, the obstacle window, the corridor, vehicle and cost
parameters); ``commonroad_rp_tpu_torch.interop`` carries those exact inputs
into the port's tensors, so any difference is the scorer's, the selection's
or the re-roll's.  The selected index, the rejection counters, the selected
level and the re-roll verdict match exactly, the winner's cost to rtol 2e-4
(float32 sums in another order), its [14, T] state arrays to 1e-4, and the
reason rows exactly.

The lazy winner refinement (the exact ``segments`` boundary SAT and the
continuous swept-OBB pass, checked per winner, colliding winners masked and
re-selected) is held against the JAX package's ``while_loop`` on ZAM_Over's
first cycle at the same bar, with identical masked-cost patterns and at
least one re-selection in each mode.
"""

import functools
import logging

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from commonroad_rp_tpu.models.planner import ReactivePlanner as JaxPlanner
from commonroad_rp_tpu.ops import collision as jax_collision
from commonroad_rp_tpu.ops import cycle as jax_cycle
from commonroad_rp_tpu.utils.config import \
    ReactivePlannerConfiguration as JaxConfig
from commonroad_rp_tpu.utils.route import RoutePlanner as JaxRoutePlanner

from commonroad_rp_tpu_torch import interop
from commonroad_rp_tpu_torch.ops import cycle as port_cycle

logging.getLogger("RP_LOGGER").setLevel(logging.CRITICAL)

SCENARIOS = ["ZAM_Over-1_1", "DEU_Test-1_1_T-1", "ZAM-Ramp-1_1-T-1",
             "ZAM_Tjunction-1_42_T-1"]


@functools.lru_cache(maxsize=None)
def _first_cycle(repo_root, name):
    """(kwargs shared by both, JAX-only args, port-only args)."""
    config = JaxConfig.load(repo_root / "configurations" / f"{name}.yaml",
                            f"{name}.xml")
    config.general.path_scenarios = str(repo_root / "example_scenarios") + "/"
    config.general.set_path_scenario(f"{name}.xml")
    config.update()
    config.debug.fast_scoring = True
    config.debug.kernel_dtype = "float32"
    route = JaxRoutePlanner(config.scenario, config.planning_problem) \
        .plan_routes().retrieve_first_route()
    planner = JaxPlanner(config)
    planner.set_reference_path(route.reference_path)
    planner.set_desired_velocity(current_speed=planner.x_0.velocity)
    planner.x_0_cl = planner._compute_initial_states(planner.x_0)
    planner._low_vel_mode = \
        planner.x_0.velocity < config.planning.low_vel_mode_threshold
    x0_lon, x0_lat = planner.x_0_cl
    levels = range(1, planner.sampling_level)
    batches = [planner._create_trajectory_bundle(x0_lon, x0_lat, level)
               for level in levels]
    ctx = planner._scene_context()
    return dict(
        coeffs_lon=np.concatenate([b.coeffs_lon for b in batches]),
        coeffs_lat=np.concatenate([b.coeffs_lat for b in batches]),
        traj_len=np.concatenate([b.traj_len for b in batches]),
        goal_valid=np.concatenate([planner._goal_valid_mask(b)
                                   for b in batches]),
        level_ids=np.concatenate([np.full(b.size, j, np.int32)
                                  for j, b in enumerate(batches)]),
        ref=planner._co.tables, veh=ctx["veh"], obstacles=ctx["obstacles"],
        corridor=planner._corridor_or_unbounded(ctx["corridor"]),
        boundary=ctx["boundary"],
        unbounded=planner._corridor_or_unbounded(None),
        x0_orientation=np.float32(planner.x_0.orientation),
        cost_params=ctx["cost_params"], dt=planner.dt, n_steps=planner.N,
        low_vel_mode=planner._low_vel_mode,
        cost_structure=planner.cost_function.structure,
        constraint_flags=ctx["flags"], n_levels=len(batches))


def _run_jax(c, boundary=None, continuous=False):
    f32 = jnp.float32
    out = jax_cycle.evaluate_levels_fast(
        jnp.asarray(c["coeffs_lon"], f32), jnp.asarray(c["coeffs_lat"], f32),
        jnp.asarray(c["traj_len"]), jnp.asarray(c["goal_valid"]),
        jnp.asarray(c["level_ids"]), c["ref"], c["veh"], c["obstacles"],
        c["corridor"], jnp.asarray(c["x0_orientation"], f32),
        c["cost_params"], boundary, dt=c["dt"], n_steps=c["n_steps"],
        low_vel_mode=c["low_vel_mode"], cost_structure=c["cost_structure"],
        constraint_flags=c["constraint_flags"], n_levels=c["n_levels"],
        continuous=continuous, interpret=True)
    return {k: np.asarray(v) for k, v in out._asdict().items()}


def _run_port(c, boundary=None, continuous=False):
    cl, ca, tl, gv, lv = interop.candidates(
        c["coeffs_lon"], c["coeffs_lat"], c["traj_len"], c["goal_valid"],
        c["level_ids"])
    out = port_cycle.evaluate_levels_fast(
        cl, ca, tl, gv, lv, interop.ref_tables(c["ref"], dtype=torch.float32),
        interop.vehicle(c["veh"]),
        interop.obstacles(c["obstacles"], dtype=torch.float32),
        interop.corridor(c["corridor"], dtype=torch.float32),
        float(c["x0_orientation"]), interop.cost_params(c["cost_params"]),
        None if boundary is None
        else interop.boundary(boundary, dtype=torch.float32),
        dt=c["dt"], n_steps=c["n_steps"], low_vel_mode=c["low_vel_mode"],
        cost_structure=c["cost_structure"],
        constraint_flags=c["constraint_flags"], n_levels=c["n_levels"],
        continuous=continuous)
    return {k: v.numpy() for k, v in out._asdict().items()}


def _assert_cycles_match(want, got):
    ws, gs = want["scalars"], got["scalars"]
    assert bool(got["found"]) == bool(want["found"])
    # idx, n_inf_kin, n_coll, re-roll flag, level: exact
    np.testing.assert_array_equal(gs[[0, 2, 3, 4, 5]], ws[[0, 2, 3, 4, 5]])
    if np.isfinite(ws[1]):
        np.testing.assert_allclose(gs[1], ws[1], rtol=2e-4)
    else:
        assert not np.isfinite(gs[1])
    np.testing.assert_allclose(got["optimal"], want["optimal"], rtol=0,
                               atol=1e-4)
    np.testing.assert_array_equal(got["reasons"], want["reasons"])
    nan_inf = lambda x: np.where(np.isnan(x), np.inf, x)
    for row in ("costs", "kin_costs"):
        w, g = nan_inf(want[row]), nan_inf(got[row])
        np.testing.assert_array_equal(np.isfinite(g), np.isfinite(w))
        fin = np.isfinite(w)
        np.testing.assert_allclose(g[fin], w[fin], rtol=2e-4, atol=1e-2)


@pytest.mark.parametrize("name", SCENARIOS)
def test_evaluate_levels_fast_matches(repo_root, name):
    c = _first_cycle(repo_root, name)
    _assert_cycles_match(_run_jax(c), _run_port(c))


def _with_corner_disc(c, winner, radius=1.0):
    """``c`` with one more obstacle: a static disc diagonally off the
    front-left corner of ``winner``'s last ego box ([14, T] packed states),
    0.85 ``radius`` ahead and 0.85 ``radius`` outside.  The exact disc test
    misses that box by 0.2 ``radius``, while the continuous pass covers the
    disc by its bounding square, which reaches 0.15 ``radius`` into the
    corner: only the swept pass rejects that candidate."""
    veh = interop.vehicle(c["veh"])
    x, y, theta = (float(winner[i, -1]) for i in (7, 8, 9))
    major = np.array([np.cos(theta), np.sin(theta)])
    minor = np.array([-np.sin(theta), np.cos(theta)])
    corner = np.array([x, y]) + veh.wb_rear_axle * major \
        + veh.half_length * major + veh.half_width * minor
    center = corner + 0.85 * radius * (major + minor)
    obs = c["obstacles"]
    M, T = obs.pose.shape[:2]
    disc = np.broadcast_to(np.float32([center[0], center[1], theta]),
                           (1, T, 3))
    radii = np.zeros(M, np.float32) if obs.radius is None \
        else np.asarray(obs.radius)
    return dict(c, obstacles=jax_collision.ObstacleArrays(
        pose=jnp.concatenate([obs.pose, jnp.asarray(disc, obs.pose.dtype)]),
        half_ext=jnp.concatenate([obs.half_ext,
                                  jnp.zeros((1, 2), obs.half_ext.dtype)]),
        valid=jnp.concatenate([obs.valid, jnp.ones((1, T), bool)]),
        radius=jnp.asarray(np.append(radii, np.float32(radius))),
        poly_verts=obs.poly_verts, poly_valid=obs.poly_valid))


@pytest.mark.parametrize("mode", ["segments", "continuous"])
def test_evaluate_levels_fast_refinement_matches(repo_root, mode):
    """The fused cycle's lazy winner refinement, both packages: ZAM_Over's
    road boundary as exact segments (the corridor bands unbounded, as the
    planners pass them in that mode), or the continuous pass with a disc
    that only the swept check sees."""
    c = _first_cycle(repo_root, "ZAM_Over-1_1")
    if mode == "segments":
        c = dict(c, corridor=c["unbounded"])
        refine = dict(boundary=c["boundary"])
    else:
        c = _with_corner_disc(c, _run_port(c)["optimal"])
        refine = dict(continuous=True)
    unrefined = _run_port(c)
    want, got = _run_jax(c, **refine), _run_port(c, **refine)
    _assert_cycles_match(want, got)
    reselected = np.isfinite(unrefined["costs"]) & ~np.isfinite(got["costs"])
    assert reselected.sum() >= 1, "degenerate: no winner was re-selected"
    assert got["scalars"][0] != unrefined["scalars"][0]


def test_evaluate_level_fast_single_level_matches(repo_root):
    """``evaluate_level_fast`` (the ``plan(level)`` path): ZAM_Over's level-2
    bundle alone, both packages."""
    c = dict(_first_cycle(repo_root, "ZAM_Over-1_1"))
    first = c["level_ids"] == 0
    for key in ("coeffs_lon", "coeffs_lat", "traj_len", "goal_valid"):
        c[key] = c[key][first]
    f32 = jnp.float32
    shared = dict(dt=c["dt"], n_steps=c["n_steps"],
                  low_vel_mode=c["low_vel_mode"],
                  cost_structure=c["cost_structure"],
                  constraint_flags=c["constraint_flags"])
    want = jax_cycle.evaluate_level_fast(
        jnp.asarray(c["coeffs_lon"], f32), jnp.asarray(c["coeffs_lat"], f32),
        jnp.asarray(c["traj_len"]), jnp.asarray(c["goal_valid"]), c["ref"],
        c["veh"], c["obstacles"], c["corridor"],
        jnp.asarray(c["x0_orientation"], f32), c["cost_params"], None,
        interpret=True, **shared)
    cl, ca, tl, gv = interop.candidates(c["coeffs_lon"], c["coeffs_lat"],
                                        c["traj_len"], c["goal_valid"])
    got = port_cycle.evaluate_level_fast(
        cl, ca, tl, gv, interop.ref_tables(c["ref"], dtype=torch.float32),
        interop.vehicle(c["veh"]),
        interop.obstacles(c["obstacles"], dtype=torch.float32),
        interop.corridor(c["corridor"], dtype=torch.float32),
        float(c["x0_orientation"]), interop.cost_params(c["cost_params"]),
        **shared)
    ws, gs = np.asarray(want.scalars), got.scalars.numpy()
    np.testing.assert_array_equal(gs[[0, 2, 3, 4, 5]], ws[[0, 2, 3, 4, 5]])
    np.testing.assert_allclose(gs[1], ws[1], rtol=2e-4)
    np.testing.assert_allclose(got.optimal.numpy(), np.asarray(want.optimal),
                               rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got.reasons.numpy(),
                                  np.asarray(want.reasons))


def test_select_across_levels_escalation_and_nan():
    """Plain-torch selection: the first level with a finite cost wins, NaN
    never wins, statistics follow the selected level, and with nothing
    found they follow the last level."""
    inf, nan = np.inf, np.nan
    masked = torch.tensor([inf, nan, inf, 5.0, 3.0, nan, 1.0])
    kin = torch.tensor([2.0, 1.0, inf, 5.0, 3.0, 4.0, 1.0])
    goal = torch.ones(7, dtype=torch.bool)
    levels = torch.tensor([0, 0, 0, 1, 1, 1, 2])
    found, idx, cost, level, n_kin, n_coll = port_cycle.select_across_levels(
        masked, kin, goal, levels, 3)
    assert bool(found) and int(idx) == 4 and float(cost) == 3.0
    assert int(level) == 1 and int(n_kin) == 0
    assert int(n_coll) == 0       # NaN-masked kin 4.0 is not cheaper than 3
    masked[3:] = inf
    found, idx, cost, level, n_kin, n_coll = port_cycle.select_across_levels(
        masked, kin, goal, levels, 3)
    assert not bool(found) and np.isinf(float(cost)) and int(level) == 2
    assert int(n_coll) == 1       # the last level's colliding candidate
