"""``ReactivePlanner.plan_scan``: the port against the JAX package.

* ZAM_Over-1_1 driven to the goal through ``plan_scan(14)`` in both packages
  (JAX on its fused Pallas path in interpret mode, the port on CPU tensors
  through the plain scorer), from the same curvilinear initial state: the
  same cycles run (9) and steps (27), identical found flags, best costs
  within rtol 2e-3, recorded states within atol 5e-3
  (``tests/test_fast_scoring.py:291-294``).
* Stopping mode through both packages' ``plan_scan``.
* The scope errors (the fused path only: the conformance level program
  has no scan), the cache of built scans, the stop-at-goal mission of
  ``tests/test_mission.py`` through ``plan_scan`` alone, and corridor
  sampling through ``plan_scan`` against the port's host loop
  (``tests/test_corridor_sampling.py:247-297``).
* T=61: the port's scorer against ``score_candidates_pallas(...,
  span_steps=..., interpret=True)`` -- the TPU kernel with per-step table
  windows, ``_scoring_kernel_ps`` -- on a ``plan_scan`` cycle's level
  union at the reference's default horizon, at the bar of
  ``tests/test_pallas_cycle.py:107-117``.
"""

import functools
import logging

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from commonroad_rp_tpu.models.planner import ReactivePlanner as JaxPlanner
from commonroad_rp_tpu.ops import grid as jax_grid
from commonroad_rp_tpu.ops import pallas_cycle
from commonroad_rp_tpu.utils.config import \
    ReactivePlannerConfiguration as JaxConfig
from commonroad_rp_tpu.utils.route import RoutePlanner as JaxRoutePlanner

from commonroad_rp_tpu_torch import interop
from commonroad_rp_tpu_torch.models.cost_functions import \
    DefaultCostFunctionFailSafe
from commonroad_rp_tpu_torch.models.sampling import DrivingCorridor
from commonroad_rp_tpu_torch.ops import scoring
from commonroad_rp_tpu_torch.parallel.replanning_scan import \
    FacadeScanCarry
from commonroad_rp_tpu_torch.run_planner import (drive_mission, drive_scan,
                                                 drive_to_goal, load_config,
                                                 make_planner)

from tests.test_torch_scoring import assert_scorer_parity

logging.getLogger("RP_LOGGER").setLevel(logging.CRITICAL)

SCENARIO = "ZAM_Over-1_1"


def _jax_planner(repo_root, n_steps=None, slow_start=False):
    config = JaxConfig.load(repo_root / "configurations" / f"{SCENARIO}.yaml",
                            f"{SCENARIO}.xml")
    config.general.path_scenarios = str(repo_root / "example_scenarios") + "/"
    config.general.set_path_scenario(f"{SCENARIO}.xml")
    config.update()
    config.debug.fast_scoring = True
    config.debug.kernel_dtype = "float32"
    if n_steps is not None:
        config.planning.time_steps_computation = n_steps
    if slow_start:
        config.sampling.longitudinal_mode = "stopping"
    route = JaxRoutePlanner(config.scenario, config.planning_problem) \
        .plan_routes().retrieve_first_route()
    planner = JaxPlanner(config)
    planner.set_reference_path(route.reference_path)
    return _slow(planner) if slow_start else planner


def _port_planner(repo_root, slow_start=False):
    config = load_config(SCENARIO, repo_root)
    if slow_start:
        config.sampling.longitudinal_mode = "stopping"
    planner = make_planner(config, device="cpu")
    return _slow(planner) if slow_start else planner


def _slow(planner):
    """Stop-approach start (v = 8 m/s), tests/test_stopping_mode.py:33-40."""
    x0 = planner.x_0.copy()
    x0.velocity = 8.0
    x0.yaw_rate = 0.0
    planner.reset(initial_state_cart=x0,
                  collision_checker=planner.collision_checker,
                  coordinate_system=planner.coordinate_system)
    return planner


def _drive(planner, x0_cl, n_cycles, stop_offset=None):
    planner.x_0_cl = [list(map(float, part)) for part in x0_cl]
    if stop_offset is None:
        planner.set_desired_velocity(current_speed=planner.x_0.velocity)
    else:
        planner.set_desired_lon_position(x0_cl[0][0] + stop_offset)
    planner.record_state_and_input(planner.x_0)
    info = planner.plan_scan(n_cycles)
    states = planner.record_state_list
    return info, dict(
        time_step=np.array([s.time_step for s in states]),
        position=np.array([s.position for s in states]),
        velocity=np.array([s.velocity for s in states]),
        orientation=np.array([s.orientation for s in states]))


@functools.lru_cache(maxsize=None)
def _both(repo_root, stopping=False):
    jax_planner = _jax_planner(repo_root, slow_start=stopping)
    x0_cl = jax_planner._compute_initial_states(jax_planner.x_0)
    port = _port_planner(repo_root, slow_start=stopping)
    np.testing.assert_allclose(
        np.concatenate(port._compute_initial_states(port.x_0)),
        np.concatenate(x0_cl), rtol=0, atol=1e-9)
    kwargs = dict(stop_offset=8.0) if stopping else {}
    n_cycles = 6 if stopping else 14
    return (_drive(jax_planner, x0_cl, n_cycles, **kwargs),
            _drive(port, x0_cl, n_cycles, **kwargs), port)


def _assert_drives_match(want, got):
    (info_w, states_w), (info_g, states_g) = want, got
    assert info_g["cycles_run"] == info_w["cycles_run"]
    assert info_g["steps"] == info_w["steps"]
    assert info_g["goal_reached"] == info_w["goal_reached"]
    assert info_g["found"] == info_w["found"]
    np.testing.assert_allclose(info_g["best_cost"], info_w["best_cost"],
                               rtol=2e-3)
    np.testing.assert_array_equal(states_g["time_step"],
                                  states_w["time_step"])
    for field in ("position", "velocity", "orientation"):
        np.testing.assert_allclose(states_g[field], states_w[field],
                                   atol=5e-3, err_msg=field)


def test_plan_scan_matches_jax_to_goal(repo_root):
    want, got, port = _both(repo_root)
    assert want[0]["goal_reached"] and want[0]["cycles_run"] == 9
    assert want[0]["steps"] == 27
    _assert_drives_match(want, got)
    # the rejection counters of each cycle's selected level
    assert got[0]["n_inf_kinematics"] == want[0]["n_inf_kinematics"]
    assert got[0]["n_inf_collision"] == want[0]["n_inf_collision"]
    # the planner advanced to the last recorded state, at the goal
    assert port.goal_reached()
    assert port.x_0.time_step == 27


def test_plan_scan_stopping_mode_matches_jax(repo_root):
    want, got, port = _both(repo_root, stopping=True)
    assert want[0]["cycles_run"] == 6
    _assert_drives_match(want, got)
    v = got[1]["velocity"]
    assert v[-1] < v[0], "stopping mode decelerates"


def test_plan_scan_scope_errors(repo_root):
    planner = _port_planner(repo_root)
    # no desired speed yet: the cost function has no speed target
    with pytest.raises(ValueError, match="fused-kernel scope"):
        planner.plan_scan(2)
    planner.set_desired_velocity(current_speed=planner.x_0.velocity)
    planner.config.sampling.longitudinal_mode = "bogus"
    with pytest.raises(ValueError, match="unknown longitudinal mode"):
        planner.plan_scan(2)
    planner.config.sampling.longitudinal_mode = "stopping"
    with pytest.raises(ValueError, match="set_desired_lon_position"):
        planner.plan_scan(2)
    planner.config.sampling.longitudinal_mode = "velocity_keeping"
    planner.config.planning.factor = 2
    planner.x_0.time_step = 1
    with pytest.raises(ValueError, match="divisible by planning.factor"):
        planner.plan_scan(2)
    planner.config.planning.factor = 1
    planner.x_0.time_step = 0
    # the conformance level program has no scan, as in the JAX package
    planner.config.debug.fast_scoring = False
    with pytest.raises(ValueError, match="fused-kernel scope"):
        planner.plan_scan(2)
    planner.config.debug.fast_scoring = True
    planner.set_cost_function(DefaultCostFunctionFailSafe())
    with pytest.raises(ValueError, match="fused-kernel scope"):
        planner.plan_scan(2)


def test_plan_scan_cache_reuses_built_scans(repo_root):
    planner = _port_planner(repo_root)
    planner.set_desired_velocity(current_speed=planner.x_0.velocity)
    for _ in range(2):
        planner.plan_scan(2, record=False)
    assert planner._plan_scan_builds == 1
    for n in (3, 4, 5, 6, 2):
        planner.plan_scan(n, record=False)
    assert len(planner._plan_scan_cache) == 4
    assert planner._plan_scan_builds == 6


def test_drive_scan_reaches_goal(repo_root):
    """``run_planner --scan``'s loop: 12-cycle plan_scan dispatches until
    the goal, 27 steps in 9 cycles."""
    planner = _port_planner(repo_root)
    result = drive_scan(planner, max_steps=100)
    assert result["goal_reached"] and result["steps"] == 27
    assert result["cycles"] == 9 and len(result["scan_infos"]) == 1


def test_facade_carry_from_jax():
    """interop.facade_carry keeps each leaf's value and dtype."""
    from commonroad_rp_tpu.parallel.pallas_fleet import \
        FacadeScanCarry as JaxCarry

    leaves = dict(x0_lon=np.float32([40.0, 15.0, 0.2]),
                  x0_lat=np.float32([0.4, 0.05, 0.0]),
                  orientation=np.float32(0.08), velocity=np.float32(15.0),
                  time_step=np.int32(6), alive=np.bool_(True),
                  kappa=np.float32(0.01), px=np.float32(3.5),
                  py=np.float32(-1.25))
    got = interop.facade_carry(JaxCarry(**{k: jnp.asarray(v)
                                           for k, v in leaves.items()}))
    assert isinstance(got, FacadeScanCarry)
    for name, want in leaves.items():
        leaf = getattr(got, name)
        assert leaf.numpy().dtype == want.dtype, name
        np.testing.assert_array_equal(leaf.numpy(), want, err_msg=name)


def test_mission_stops_at_goal(repo_root):
    """Velocity keeping into the goal region's time window, braking, then
    stopping mode to rest at the stop target, every cycle in plan_scan."""
    config = load_config(SCENARIO, repo_root)
    planner = make_planner(config, device="cpu")
    planner.record_state_and_input(planner.x_0)
    assert planner.goal_center_s() == pytest.approx(93.0, abs=2.0)
    result = drive_mission(planner, config, max_steps=320)
    assert result["goal_entered"] and result["halted"], result
    assert result["success"], result
    velocities = [s.velocity for s in planner.record_state_list]
    assert velocities[-1] <= 0.05 and min(velocities) >= -1e-5
    assert result["cycles"] * config.planning.replanning_frequency + 3 \
        >= result["steps"]


def _corridor_planner(repo_root):
    """ZAM_Over with corridor sampling in the synthetic corridor of
    tests/test_corridor_sampling.py:22-32 (d band +-3.5 m, 40 steps)."""
    config = load_config(SCENARIO, repo_root)
    config.sampling.sampling_method = 2
    planner = make_planner(config, device="cpu")
    planner.x_0_cl = planner._compute_initial_states(planner.x_0)
    s0, v0, dt, steps = planner.x_0_cl[0][0], planner.x_0.velocity, 0.1, 40
    planner.sampling_space.driving_corridor = DrivingCorridor(
        first_step=0,
        velocity_intervals={i: (max(0.0, v0 - 5.0), v0 + 5.0)
                            for i in range(steps)},
        lateral_interval_map={i: [(s0 - 10.0, s0 + v0 * dt * steps + 50.0,
                                   -3.5, 3.5)] for i in range(steps)})
    return planner


def test_corridor_plan_scan_matches_host_loop(repo_root):
    host = _corridor_planner(repo_root)
    result = drive_to_goal(host, max_steps=60)
    assert result["goal_reached"]
    planner = _corridor_planner(repo_root)
    planner.set_desired_velocity(current_speed=planner.x_0.velocity)
    planner.record_state_and_input(planner.x_0)
    info = planner.plan_scan(14)
    assert info["goal_reached"] and info["steps"] == result["steps"]
    for a, b in zip(host.record_state_list, planner.record_state_list):
        assert a.time_step == b.time_step
        np.testing.assert_allclose(b.position, a.position, atol=5e-3)
        np.testing.assert_allclose(b.velocity, a.velocity, atol=5e-3)


def test_t61_union_matches_perstep_kernel(repo_root):
    """One plan_scan cycle's level union at T=61 (levels 1-3, ZAM_Over's
    first state) through the per-step-window TPU kernel and the port's
    scorer."""
    n_steps, dt = 60, 0.1
    T = n_steps + 1
    jp = _jax_planner(repo_root, n_steps=n_steps)
    jp.set_desired_velocity(current_speed=jp.x_0.velocity)
    x0_lon, x0_lat = (jnp.asarray(np.asarray(x, np.float32))
                      for x in jp._compute_initial_states(jp.x_0))
    ctx = jp._scene_context()
    veh = ctx["veh"]
    cs = jp.config.sampling
    v = jnp.float32(jp.x_0.velocity)
    v_min = jnp.maximum(0.0, v - 0.125 * jp.horizon * jnp.float32(veh.a_max))
    v_max = jnp.maximum(v_min + 5.0, v + 2.0)
    cls, cas, tls, gvs, spans, steps = [], [], [], [], [], []
    for level in range(1, jp.sampling_level):
        g = jax_grid.make_static_grid(level, cs.t_min, jp.horizon, dt,
                                      cs.d_min, cs.d_max,
                                      cs.num_sampling_levels)
        cl, ca, tl = jax_grid.velocity_keeping_candidates(
            x0_lon, x0_lat, v_min, v_max, jnp.asarray(False), g)
        nd1 = len(g.d_values) + 1
        dup = bool(np.any(np.float32(g.d_values) == np.asarray(x0_lat)[0]))
        gvs.append(~(((np.arange(g.size) % nd1) == nd1 - 1) & dup))
        spans.append(jax_grid.candidate_lon_span(x0_lon, v_min, v_max, g,
                                                 dt, n_steps))
        steps.append(jax_grid.candidate_lon_span_steps(
            x0_lon, v_min, v_max, g, dt, n_steps))
        cls.append(cl)
        cas.append(ca)
        tls.append(tl)
    cl, ca, tl = (jnp.concatenate(x) for x in (cls, cas, tls))
    gv = np.concatenate(gvs)
    span = (min(float(s[0]) for s in spans), max(float(s[1]) for s in spans))
    span_steps = (np.min([np.asarray(s[0]) for s in steps], axis=0),
                  np.max([np.asarray(s[1]) for s in steps], axis=0))
    packed = pallas_cycle.pack_ref_tables(jp.coordinate_system.tables,
                                          ctx["corridor"])
    ref_s_last = pallas_cycle.true_path_length(jp.coordinate_system.tables)
    obstacles = ctx["obstacles"]
    assert obstacles.pose.shape[1] == T
    theta = np.float32(jp.x_0.orientation)
    ds = np.float32(jp._desired_speed)

    # the per-step path is the one taken: its coverage condition holds
    P = packed.shape[0]
    ch = pallas_cycle._PS_CHUNK
    ws = np.array(pallas_cycle._ps_chunk_sched(T, ch))
    nch = len(ws)
    margin = float(veh.wb_rear_axle + veh.half_length + veh.half_width) + 1.0
    lo = np.pad(span_steps[0] - margin, (0, nch * ch - T),
                constant_values=np.inf).reshape(nch, ch).min(axis=1)
    hi = np.pad(span_steps[1] + margin, (0, nch * ch - T),
                constant_values=-np.inf).reshape(nch, ch).max(axis=1)
    s_col = np.asarray(packed[:, 0])
    i0 = np.clip((s_col[:, None] <= lo[None, :]).sum(axis=0) - 1, 0,
                 P - ws - 1) // 16 * 16
    assert pallas_cycle._PS_MAX + pallas_cycle._LANE <= P <= 4096
    assert (hi < s_col[i0 + ws]).all()

    want = [np.asarray(x) for x in pallas_cycle.score_candidates_pallas(
        cl, ca, tl, jnp.asarray(gv), packed, obstacles, veh,
        jnp.float32(theta), dt, jnp.asarray(False), jnp.float32(ds),
        jnp.float32(0.0), jnp.float32(5.0), ref_s_last,
        span=(jnp.float32(span[0]), jnp.float32(span[1])),
        span_steps=tuple(jnp.asarray(x, jnp.float32) for x in span_steps),
        n_steps=n_steps, interpret=True)]

    ref = interop.ref_tables(jp.coordinate_system.tables, "cpu",
                             torch.float32)
    cl_t, ca_t, tl_t, gv_t = interop.candidates(cl, ca, tl, gv)
    got = [x.numpy() for x in scoring.score_candidates(
        cl_t, ca_t, tl_t, gv_t,
        scoring.pack_ref_tables(ref, interop.corridor(ctx["corridor"], "cpu",
                                                      torch.float32)),
        interop.obstacles(obstacles, "cpu", torch.float32),
        interop.vehicle(veh), float(theta), dt, False, float(ds), 0.0, 5.0,
        scoring.true_path_length(ref), n_steps=n_steps)]

    assert cl.shape[0] > 8000 and np.isfinite(want[0]).any()
    clf = np.asarray(cl, np.float32)
    t = (np.arange(T, dtype=np.float32) * np.float32(dt))[:, None]
    s = sum(clf[:, i] * t ** i for i in range(6))
    active = np.arange(T)[:, None] < np.asarray(tl)[None]
    in_domain = np.all(((s >= 0) & (s <= float(ref_s_last))) | ~active,
                       axis=0)
    assert_scorer_parity(want, got, in_domain)
