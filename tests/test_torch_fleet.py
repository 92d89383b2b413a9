"""The port's fleet against the JAX package's.

* ``build_fleet_scene`` from each package's ``problem_from_planner_setup``:
  equal leaves.
* ``score_fleet_reference`` (the plain version of the fleet kernel) against
  ``pallas_cycle.score_fleet_pallas(..., interpret=True)`` on the 3-problem
  fleet of ``tests/test_pallas_fleet.py``, level 2, with and without the
  stopping cost term, at the bar of ``tests/test_pallas_cycle.py:107-117``:
  identical finite patterns and in-domain reasons, finite costs within
  rtol 2e-4 / atol 1e-2.
* ``make_fleet_scan`` against ``make_pallas_fleet_scan(interpret=True)``,
  3 cycles from the same carry (converted with ``interop``): identical
  ``alive``, ``x0_lon`` within rtol 2e-4 / atol 2e-3, best costs within
  rtol 2e-3 (the bar of ``tests/test_pallas_fleet.py:111-120``).
* The winner re-roll: ``kinematics.rollout`` with a leading problem axis
  (padded reference tables [F, P], per-problem vehicles, orientation and
  low-velocity mode as tensors) against ``jax.vmap(kinematics.rollout)``.
* ``make_replanning_scan`` (one problem) against
  ``make_pallas_replanning_scan(interpret=True)`` at the same bar.
* The dead-member, standstill and stopping cases of
  ``tests/test_pallas_fleet.py``, on the port alone.
* The lattice form of the fleet scorer (``scoring.FleetLatticeInputs``),
  in velocity keeping and stopping on a 12-problem fleet with members in
  and out of the low-velocity mode: the plain version scores it as the
  candidates ``ops.grid`` generates, and the fleet scan equals the cycle
  that generates them and gathers the winners from them, bit for bit.
"""

import functools
import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from commonroad_rp_tpu.ops import grid as jax_grid
from commonroad_rp_tpu.ops import pallas_cycle
from commonroad_rp_tpu.parallel import fleet as jax_fleet
from commonroad_rp_tpu.parallel import pallas_fleet
from commonroad_rp_tpu.utils.general import \
    load_scenario_and_planning_problem as jax_load
from commonroad_rp_tpu.utils.route import RoutePlanner as JaxRoutePlanner

from commonroad_rp_tpu_torch import interop
from commonroad_rp_tpu_torch.ops import grid, kinematics, scoring
from commonroad_rp_tpu_torch.ops.collision import CorridorArrays
from commonroad_rp_tpu_torch.parallel import fleet, replanning_scan
from commonroad_rp_tpu_torch.run_fleet import heterogeneous_fleet
from commonroad_rp_tpu_torch.utils import profiling
from commonroad_rp_tpu_torch.utils.general import \
    load_scenario_and_planning_problem
from commonroad_rp_tpu_torch.utils.route import RoutePlanner

from tests.test_torch_scoring import RTOL, ATOL

logging.getLogger("RP_LOGGER").setLevel(logging.CRITICAL)

N_STEPS, DT = 20, 0.1
SCENARIOS = ("ZAM_Over-1_1", "DEU_Test-1_1_T-1")


def _problems(repo_root, load, route_planner, setup):
    """The 3-problem fleet of tests/test_pallas_fleet.py:80-98 in one
    package: two scenarios plus ZAM_Over with a 0.8x slower start."""
    out = []
    for name in SCENARIOS:
        scenario, pp, _ = load(str(repo_root / "example_scenarios"
                                   / f"{name}.xml"))
        route = route_planner(scenario, pp).plan_routes() \
            .retrieve_first_route()
        out.append(setup(scenario, pp, route.reference_path,
                         n_steps=N_STEPS, horizon_pad=60))
    p2 = dict(out[0])
    p2["velocity"] = out[0]["velocity"] * 0.8
    p2["x0_lon"] = np.asarray(out[0]["x0_lon"]) * np.array([1.0, 0.8, 1.0])
    out.append(p2)
    return out


@functools.lru_cache(maxsize=None)
def _fleets(repo_root):
    jax_problems = _problems(
        repo_root, jax_load, JaxRoutePlanner,
        functools.partial(jax_fleet.problem_from_planner_setup,
                          dtype=jnp.float32))
    port_problems = _problems(repo_root, load_scenario_and_planning_problem,
                              RoutePlanner, fleet.problem_from_planner_setup)
    return (jax_fleet.build_fleet_scene(jax_problems, N_STEPS,
                                        dtype=jnp.float32),
            fleet.build_fleet_scene(port_problems, N_STEPS, device="cpu"))


def _flat_leaves(scene, carry):
    out = {}
    for name in scene._fields:
        leaf = getattr(scene, name)
        if isinstance(leaf, tuple):
            for sub in leaf._fields:
                out[f"{name}.{sub}"] = np.asarray(getattr(leaf, sub))
        else:
            out[name] = np.asarray(leaf)
    for name in carry._fields:
        out[f"carry.{name}"] = np.asarray(getattr(carry, name))
    return out


def test_build_fleet_scene_matches(repo_root):
    (scene_j, carry_j), (scene_p, carry_p) = _fleets(repo_root)
    want = _flat_leaves(scene_j, carry_j)
    got = _flat_leaves(scene_p, carry_p)
    assert want.keys() == got.keys()
    for name in want:
        w, g = want[name], got[name]
        assert w.shape == g.shape, name
        assert w.dtype == g.dtype or (w.dtype.kind == g.dtype.kind == "f"), \
            (name, w.dtype, g.dtype)
        if w.dtype.kind == "f":
            # float32 tables; the initial curvilinear state goes through the
            # JAX package's C++ projection and the port's numpy one
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-5,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


def _fleet_inputs(scene_j, carry_j, desired_s):
    """JAX-side operands of the first cycle's fleet launch (level 2,
    velocity keeping, obstacle windows at the carried time step)."""
    from commonroad_rp_tpu.ops.collision import CorridorArrays as JCorr

    T = N_STEPS + 1
    g = jax_grid.make_static_grid(2, 0.4, N_STEPS * DT, DT, -3.0, 3.0, 4)
    with jax.enable_x64(False):
        v = carry_j.velocity
        v_min = jnp.maximum(0.0, v - 0.125 * N_STEPS * DT * scene_j.veh.a_max)
        v_max = jnp.maximum(v_min + 5.0, v + 2.0)
        low_vel = v < 4.0
        cl, ca, tl = jax.vmap(jax_grid.velocity_keeping_candidates,
                              in_axes=(0, 0, 0, 0, 0, None))(
            carry_j.x0_lon, carry_j.x0_lat, v_min, v_max, low_vel, g)
        packed = jax.vmap(pallas_cycle.pack_ref_tables)(
            scene_j.ref, JCorr(d_lo=scene_j.corridor_lo,
                               d_hi=scene_j.corridor_hi))
        s = scene_j.ref.s
        ref_s_last = jnp.max(jnp.where(s < s[:, :1] + 5e5, s, -jnp.inf),
                             axis=1).astype(jnp.float32)
        F = cl.shape[0]
        return dict(
            cl=cl, ca=ca, tl=tl, gv=jnp.ones(cl.shape[:2], dtype=bool),
            packed=packed, pose=scene_j.obs_pose[:, :, :T],
            half=scene_j.obs_half, valid=scene_j.obs_valid[:, :, :T],
            veh=pallas_cycle.pack_veh_stack(scene_j.veh),
            theta=carry_j.orientation, low_vel=low_vel.astype(jnp.float32),
            desired_v=scene_j.desired_speed, desired_d=jnp.zeros(F),
            w_a=jnp.full(F, 5.0), ref_s_last=ref_s_last,
            desired_s=None if desired_s is None
            else jnp.asarray(desired_s, jnp.float32),
            radius=scene_j.obs_radius)


def _in_domain(cl, tl, ref_s_last):
    cl = np.asarray(cl, np.float32)
    T = N_STEPS + 1
    t = (np.arange(T, dtype=np.float32) * np.float32(DT))[:, None, None]
    t2 = t * t
    s = (cl[..., 0] + cl[..., 1] * t + cl[..., 2] * t2 + cl[..., 3] * (t2 * t)
         + cl[..., 4] * (t2 * t2) + cl[..., 5] * (t2 * t2 * t))
    active = np.arange(T)[:, None, None] < np.asarray(tl)[None]
    last = np.asarray(ref_s_last)[None, :, None]
    return np.all(((s >= 0) & (s <= last)) | ~active, axis=0)


@pytest.mark.parametrize("stopping_term", [False, True])
def test_plain_fleet_scorer_matches_tpu_kernel(repo_root, stopping_term):
    (scene_j, carry_j), _ = _fleets(repo_root)
    s0 = np.asarray(carry_j.x0_lon)[:, 0]
    desired_s = (s0 + 12.0).astype(np.float32) if stopping_term else None
    a = _fleet_inputs(scene_j, carry_j, desired_s)
    want = [np.asarray(x) for x in pallas_cycle.score_fleet_pallas(
        a["cl"], a["ca"], a["tl"], a["gv"], a["packed"], a["pose"],
        a["half"], a["valid"], a["veh"], a["theta"], DT, a["low_vel"],
        a["desired_v"], a["desired_d"], a["w_a"], a["ref_s_last"],
        desired_s=a["desired_s"], obs_radius=a["radius"], n_steps=N_STEPS,
        has_desired_s=stopping_term, interpret=True)]
    t = lambda x, dtype=torch.float32: interop.tensor(x, "cpu", dtype)
    got = [x.numpy() for x in scoring.score_fleet(
        t(a["cl"]), t(a["ca"]), t(np.asarray(a["tl"])),
        t(np.asarray(a["gv"])), t(a["packed"]), t(a["pose"]), t(a["half"]),
        t(np.asarray(a["valid"])), t(a["veh"]), t(a["theta"]), DT,
        t(a["low_vel"]), t(a["desired_v"]), t(a["desired_d"]), t(a["w_a"]),
        t(a["ref_s_last"]), None if desired_s is None else t(desired_s),
        t(a["radius"]), n_steps=N_STEPS, has_desired_s=stopping_term)]
    assert want[0].shape == got[0].shape == (3, a["cl"].shape[1])
    dom = _in_domain(a["cl"], a["tl"], a["ref_s_last"])
    nan_inf = lambda x: np.where(np.isnan(x), np.inf, x)
    for f in range(3):
        assert np.isfinite(want[1][f]).any(), f"problem {f} degenerate"
        for row in (0, 1):
            w, g = nan_inf(want[row][f]), nan_inf(got[row][f])
            np.testing.assert_array_equal(np.isfinite(g), np.isfinite(w))
            fin = np.isfinite(w)
            np.testing.assert_allclose(g[fin], w[fin], rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(got[2][f][dom[f]], want[2][f][dom[f]])
        w = nan_inf(want[0][f])
        if np.isfinite(w).any():
            iw, ig = int(np.argmin(w)), int(np.argmin(nan_inf(got[0][f])))
            assert iw == ig or np.isclose(w[iw], got[0][f][ig], rtol=RTOL,
                                          atol=ATOL)


def test_batched_rollout_matches_vmap_rollout(repo_root):
    """K candidates per problem through each problem's padded tables; the
    modes differ per problem.  The padded sentinel rows move interp_index's
    -1 wrap the same way in both packages."""
    from commonroad_rp_tpu.ops import kinematics as jax_kin

    (scene_j, carry_j), _ = _fleets(repo_root)
    assert len({int(np.sum(np.asarray(s) < np.asarray(s)[0] + 5e5))
                for s in scene_j.ref.s}) > 1, "the fleet's refs need padding"
    a = _fleet_inputs(scene_j, carry_j, None)
    pick = np.arange(0, a["cl"].shape[1], 97)                 # K = 29
    low_vel = np.array([False, True, False])
    theta = np.array(carry_j.orientation)

    def one(cl, ca, tl, ref, veh, th, lv):
        return jax_kin.rollout(cl, ca, tl, ref, veh, th, DT, N_STEPS, lv)

    with jax.enable_x64(False):
        want = jax.vmap(one)(a["cl"][:, pick], a["ca"][:, pick],
                             a["tl"][:, pick], scene_j.ref, scene_j.veh,
                             jnp.asarray(theta), jnp.asarray(low_vel))
    scene_p = interop.fleet_scene(scene_j)
    t = lambda x: torch.as_tensor(np.asarray(x)[:, pick])
    got = kinematics.rollout(t(a["cl"]), t(a["ca"]), t(a["tl"]), scene_p.ref,
                             scene_p.veh, torch.as_tensor(theta), DT, N_STEPS,
                             torch.as_tensor(low_vel))
    for name in kinematics.RolloutResult._fields:
        w, g = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert w.shape == g.shape, name
        if w.dtype.kind == "f":
            # float32 on both sides; the two libraries' atan2/cos/tan may
            # differ in the last bit
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


def test_fleet_scan_matches_pallas_fleet_scan(repo_root):
    (scene_j, carry_j), _ = _fleets(repo_root)
    g_jax = jax_grid.make_static_grid(2, 0.4, N_STEPS * DT, DT, -3.0, 3.0, 4)
    g = grid.make_static_grid(2, 0.4, N_STEPS * DT, DT, -3.0, 3.0, 4)
    n_cycles = 3
    kwargs = dict(replan_offset=3, low_vel_threshold=4.0,
                  horizon=N_STEPS * DT, n_cycles=n_cycles)
    final_j, metrics_j = pallas_fleet.make_pallas_fleet_scan(
        scene_j, g_jax, DT, N_STEPS, interpret=True, **kwargs)(carry_j)
    # the same scene and carry, converted: the comparison isolates the scan
    scene_p = interop.fleet_scene(scene_j)
    final_p, metrics_p = replanning_scan.make_fleet_scan(
        scene_p, g, DT, N_STEPS, **kwargs)(interop.fleet_carry(carry_j))

    alive_j = np.asarray(metrics_j[0])
    assert alive_j.all(), "all fleet members should plan every cycle"
    np.testing.assert_array_equal(metrics_p[0].numpy(), alive_j)
    np.testing.assert_allclose(final_p.x0_lon.numpy(),
                               np.asarray(final_j.x0_lon), rtol=2e-4,
                               atol=2e-3)
    np.testing.assert_allclose(final_p.velocity.numpy(),
                               np.asarray(final_j.velocity), atol=2e-3)
    np.testing.assert_allclose(metrics_p[1].numpy(), np.asarray(metrics_j[1]),
                               rtol=2e-3)
    np.testing.assert_array_equal(final_p.time_step.numpy(),
                                  np.asarray(final_j.time_step))
    # the rejection counters and the fleet aggregates, in JAX's order
    for i in (4, 6, 7):
        np.testing.assert_array_equal(metrics_p[i].numpy(),
                                      np.asarray(metrics_j[i]), err_msg=i)
    for i in (2, 3, 5, 8, 9):
        np.testing.assert_allclose(metrics_p[i].numpy(),
                                   np.asarray(metrics_j[i]), rtol=2e-3,
                                   atol=2e-3, err_msg=str(i))


def test_replanning_scan_matches_pallas_replanning_scan(repo_root):
    from commonroad_rp_tpu.ops import kinematics as jax_kin
    from commonroad_rp_tpu.utils.config import VehicleConfiguration

    scenario, pp, _ = jax_load(str(repo_root / "example_scenarios"
                                   / "ZAM_Over-1_1.xml"))
    route = JaxRoutePlanner(scenario, pp).plan_routes().retrieve_first_route()
    problem = jax_fleet.problem_from_planner_setup(
        scenario, pp, route.reference_path, n_steps=N_STEPS, horizon_pad=60,
        dtype=jnp.float32)
    vc = VehicleConfiguration()
    veh = jax_kin.VehicleArrays(*[np.float32(x) for x in [
        vc.wheelbase, vc.wb_rear_axle, vc.a_max, vc.v_switch,
        np.tan(vc.delta_max) / vc.wheelbase, vc.v_delta_max,
        vc.length / 2, vc.width / 2]])
    kwargs = dict(replan_offset=3, low_vel_threshold=4.0,
                  horizon=N_STEPS * DT,
                  desired_speed=float(problem["desired_speed"]), n_cycles=4)
    g_jax = jax_grid.make_static_grid(2, 0.4, N_STEPS * DT, DT, -3.0, 3.0, 4)
    carry_j = pallas_fleet.PallasCycleCarry(
        x0_lon=jnp.asarray(problem["x0_lon"], jnp.float32),
        x0_lat=jnp.asarray(problem["x0_lat"], jnp.float32),
        orientation=jnp.asarray(problem["orientation"], jnp.float32),
        velocity=jnp.asarray(problem["velocity"], jnp.float32),
        time_step=jnp.asarray(0, jnp.int32), alive=jnp.asarray(True))
    final_j, metrics_j = pallas_fleet.make_pallas_replanning_scan(
        problem["ref_tables"], problem["corridor"], problem["obstacles"],
        veh, g_jax, DT, N_STEPS, interpret=True, **kwargs)(carry_j)

    g = grid.make_static_grid(2, 0.4, N_STEPS * DT, DT, -3.0, 3.0, 4)
    final_p, metrics_p = replanning_scan.make_replanning_scan(
        interop.ref_tables(problem["ref_tables"]),
        interop.corridor(problem["corridor"]),
        interop.obstacles(problem["obstacles"]), interop.vehicle(veh), g,
        DT, N_STEPS, **kwargs)(interop.replanning_carry(carry_j))

    assert np.asarray(metrics_j[0]).all()
    np.testing.assert_array_equal(metrics_p[0].numpy(),
                                  np.asarray(metrics_j[0]))
    np.testing.assert_allclose(final_p.x0_lon.numpy(),
                               np.asarray(final_j.x0_lon), rtol=2e-4,
                               atol=2e-3)
    np.testing.assert_allclose(metrics_p[1].numpy(), np.asarray(metrics_j[1]),
                               rtol=2e-3)
    for i in (2, 3):
        np.testing.assert_allclose(metrics_p[i].numpy(),
                                   np.asarray(metrics_j[i]), atol=2e-3)
    assert int(final_p.time_step) == int(final_j.time_step) == 12


def _over_problem(repo_root, velocity=None):
    scenario, pp, _ = load_scenario_and_planning_problem(
        str(repo_root / "example_scenarios" / "ZAM_Over-1_1.xml"))
    if velocity is not None:
        pp.initial_state.velocity = velocity
        pp.initial_state.yaw_rate = 0.0
        pp.initial_state.acceleration = 0.0
    route = RoutePlanner(scenario, pp).plan_routes().retrieve_first_route()
    return fleet.problem_from_planner_setup(
        scenario, pp, route.reference_path, n_steps=N_STEPS, horizon_pad=60)


def _squeezed(corridor):
    """A drivable band collapsed to an impossible sliver."""
    return CorridorArrays(d_lo=torch.full_like(corridor.d_lo, 0.001),
                          d_hi=torch.full_like(corridor.d_hi, 0.002))


def _scan(scene, level, n_cycles, **kwargs):
    g = grid.make_static_grid(level, 0.4, N_STEPS * DT, DT, -3.0, 3.0, 4)
    return replanning_scan.make_fleet_scan(
        scene, g, DT, N_STEPS, replan_offset=3, low_vel_threshold=4.0,
        horizon=N_STEPS * DT, n_cycles=n_cycles, **kwargs), g


def test_fleet_scan_dead_member_freezes(repo_root):
    """A member whose corridor admits no candidate goes not-alive on cycle 1
    and its carry freezes while the rest of the fleet advances."""
    good = _over_problem(repo_root)
    bad = dict(good, corridor=_squeezed(good["corridor"]))
    scene, carry = fleet.build_fleet_scene([good, bad], N_STEPS, device="cpu")
    run, g = _scan(scene, 1, 3)
    final, metrics = run(carry)

    found = metrics[0].numpy()
    assert found[:, 0].all(), "healthy member should keep planning"
    assert not found[:, 1].any(), "squeezed member cannot plan"
    n_kin_inf, n_coll = metrics[6].numpy(), metrics[7].numpy()
    assert ((n_kin_inf + n_coll) <= g.size).all()
    assert (n_kin_inf[:, 1] + n_coll[:, 1] == g.size).all()
    assert (n_coll[:, 1] > 0).all()
    assert bool(final.alive[0]) and not bool(final.alive[1])
    np.testing.assert_allclose(final.x0_lon[1].numpy(),
                               carry.x0_lon[1].numpy(), atol=1e-6)
    assert int(final.time_step[1]) == int(carry.time_step[1])
    assert float(final.x0_lon[0, 0]) > float(carry.x0_lon[0, 0])
    assert np.isinf(metrics[1].numpy()[:, 1]).all()


def test_fleet_standstill_fallback(repo_root):
    """A blocked member at v ~ 0 plans the standstill fallback on the
    device: pose frozen, v = 0, cost 0, and it stays alive."""
    problem = _over_problem(repo_root, velocity=0.04)
    scene, carry = fleet.build_fleet_scene([problem], N_STEPS, device="cpu")
    scene = scene._replace(
        corridor_lo=torch.full_like(scene.corridor_lo, 0.001),
        corridor_hi=torch.full_like(scene.corridor_hi, 0.002))
    n_cycles = 4
    run, _ = _scan(scene, 1, n_cycles)
    final, metrics = run(carry)
    assert metrics[0].numpy().all(), "standstill keeps the member alive"
    np.testing.assert_array_equal(metrics[1].numpy(), 0.0)
    np.testing.assert_array_equal(metrics[9].numpy(), 0.0)
    np.testing.assert_allclose(metrics[2].numpy(), problem["px"], atol=1e-5)
    np.testing.assert_allclose(metrics[3].numpy(), problem["py"], atol=1e-5)
    assert int(final.time_step[0]) == n_cycles * 3
    np.testing.assert_allclose(final.velocity.numpy(), 0.0)


def test_fleet_stopping_mode(repo_root):
    """Stopping mode: per-problem stop targets, quintic lon sampling, the
    stopping cost (w_a = 1) and goal-behind filtering; both members
    decelerate toward their targets."""
    problems = []
    for v0 in (8.0, 7.0):
        p = dict(_over_problem(repo_root, velocity=v0))
        p["desired_speed"] = 0.0
        problems.append(p)
    scene, carry = fleet.build_fleet_scene(problems, N_STEPS, device="cpu")
    s0 = np.asarray(problems[0]["x0_lon"])[0]
    desired_s = np.asarray([s0 + 8.0, s0 + 7.0], np.float32)
    s_window = np.stack([desired_s - 1.0, desired_s + 1.0], axis=1)
    run, _ = _scan(scene, 2, 8, longitudinal_mode="stopping",
                   desired_s=desired_s, s_window=s_window, w_a=1.0)
    final, metrics = run(carry)
    assert metrics[0].numpy()[0].all()
    v_final = final.velocity.numpy()
    assert (v_final < 3.0).all(), f"should be decelerating, v={v_final}"
    s_final = final.x0_lon.numpy()[:, 0]
    assert (s_final < desired_s + 2.0).all()
    assert (s_final > s0 + 2.0).all()


def test_pad_fleet_and_scope(repo_root):
    """pad_fleet appends dead members that never count, also when the scan
    runs under a process group (``mesh``: a gloo group of one)."""
    import torch.distributed as dist

    from commonroad_rp_tpu_torch.parallel.mesh import make_fleet_group

    _, (scene, carry) = _fleets(repo_root)
    scene_p, carry_p, F = fleet.pad_fleet(scene, carry, 4)
    assert F == 3 and carry_p.alive.tolist() == [True, True, True, False]
    assert scene_p.obs_pose.shape[0] == 4
    run, _ = _scan(scene_p, 1, 1)
    _, metrics = run(carry_p)
    assert not bool(metrics[0][0, 3]) and int(metrics[4][0]) <= 3
    dist.init_process_group("gloo", store=dist.HashStore(), world_size=1,
                            rank=0)
    try:
        run_g, _ = _scan(scene_p, 1, 1, mesh=make_fleet_group())
        _, metrics_g = run_g(carry_p)
    finally:
        dist.destroy_process_group()
    assert not bool(metrics_g[0][0, 3])
    assert int(metrics_g[4][0]) == int(metrics[4][0])
    torch.testing.assert_close(metrics_g[5], metrics[5], rtol=0, atol=0)


@pytest.mark.parametrize("form", ["table_rows", "gather"])
@pytest.mark.parametrize("time_step", [0, 7, 150, 178, 200])
def test_obstacle_window_reproduces_dynamic_slice(time_step, form):
    """``fleet.window_rows`` gives dynamic_slice's clamped window with the
    steps past the span invalidated, in both forms the cycles read it: the
    fused scans' rows into a table with the appended invalid row, and the
    XLA fleet cycle's gather of the clamped rows, its validity ANDed with
    the in-span mask (every pose there is dynamic_slice's)."""
    rng = np.random.default_rng(time_step)
    n_rows, T = 181, N_STEPS + 1
    pose = rng.normal(size=(2, n_rows, 3)).astype(np.float32)
    valid = rng.uniform(size=(2, n_rows)) > 0.3
    with jax.enable_x64(False):
        ts = jnp.int32(time_step)
        wp = np.asarray(jax.lax.dynamic_slice_in_dim(jnp.asarray(pose), ts,
                                                     T, axis=1))
        wv = np.asarray(jax.lax.dynamic_slice_in_dim(jnp.asarray(valid), ts,
                                                     T, axis=1))
    wv = wv & ((time_step + np.arange(T)) < n_rows)[None]
    ts_t = torch.tensor(time_step, dtype=torch.int32)
    if form == "table_rows":
        table = replanning_scan._with_invalid_row(
            torch.as_tensor(np.concatenate([pose, valid[..., None]], -1)), 1)
        got = table[:, replanning_scan._table_rows(ts_t, T, n_rows,
                                                   n_rows)].numpy()
        got_pose, got_valid = got[..., :3], got[..., 3] > 0.5
        np.testing.assert_array_equal(got_pose[wv], wp[wv])
    else:
        rows, in_span = fleet.window_rows(ts_t.reshape(1), T, n_rows, n_rows)
        index = rows.reshape(1, 1, T)
        got_pose = torch.gather(torch.as_tensor(pose)[None], 2, index[
            ..., None].expand(1, 2, T, 3))[0].numpy()
        got_valid = (torch.gather(torch.as_tensor(valid)[None], 2,
                                  index.expand(1, 2, T))
                     & in_span[:, None, :])[0].numpy()
        np.testing.assert_array_equal(got_pose, wp)
    np.testing.assert_array_equal(got_valid, wv)


@functools.lru_cache(maxsize=None)
def _fleet12(repo_root):
    """The 12 (scenario, vehicle) bases, jittered (``run_fleet``): three
    members start below the 4 m/s low-velocity threshold."""
    scene, carry, _, _ = heterogeneous_fleet(12, 15, device="cpu",
                                             root=repo_root)
    return scene, carry


def _lattice_scan(repo_root, mode, n_cycles, **kwargs):
    scene, carry = _fleet12(repo_root)
    g = grid.make_static_grid(3, 0.4, N_STEPS * DT, DT, -3.0, 3.0, 4)
    extra = {}
    if mode == "stopping":
        desired_s = (carry.x0_lon[:, 0].numpy() + 8.0).astype(np.float32)
        extra = dict(longitudinal_mode="stopping", desired_s=desired_s,
                     s_window=np.stack([desired_s - 1.0, desired_s + 1.0],
                                       axis=1), w_a=1.0)
    run = replanning_scan.make_fleet_scan(
        scene, g, DT, N_STEPS, replan_offset=1, low_vel_threshold=4.0,
        horizon=N_STEPS * DT, n_cycles=n_cycles, **extra, **kwargs)
    return run, carry


def _grid_candidates(inp):
    """The lattice's candidates as ``ops.grid`` generates them at the
    carried state: (coeffs_lon, coeffs_lat, traj_len, goal_valid)."""
    low_vel = inp.scalars[:, scoring._S_LOW_VEL] > 0.5
    args = (inp.x0_lon, inp.x0_lat, inp.bounds[:, 0], inp.bounds[:, 1],
            low_vel, inp.grid)
    if inp.stopping:
        return grid.stopping_candidates(*args)
    cl, ca, tl = grid.velocity_keeping_candidates(*args)
    return cl, ca, tl, torch.ones(tl.shape, dtype=torch.bool)


def _grid_scorer(inp):
    """The plain scorer on ``FleetScorerInputs`` of the grid's
    candidates."""
    cl, ca, tl, gv = _grid_candidates(inp)
    return scoring.score_prepared_reference(scoring.FleetScorerInputs(
        coeffs_lon=cl, coeffs_lat=ca, traj_len=tl.to(torch.float32),
        goal_valid=gv.to(torch.float32), tables=inp.tables, obs=inp.obs,
        poly=inp.poly, scalars=inp.scalars, n_steps=inp.n_steps,
        n_poly_verts=inp.n_poly_verts, flags=inp.flags))


def _bitwise_equal(a, b):
    if a.dtype.is_floating_point:
        return a.shape == b.shape and torch.equal(
            a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))
    return torch.equal(a, b)


@pytest.mark.parametrize("mode", ["velocity_keeping", "stopping"])
def test_plain_scorer_takes_lattice_inputs(repo_root, mode):
    """The first cycle's ``FleetLatticeInputs``: the plain scorer returns
    what it returns on the grid's candidates, and ``lattice_candidates``
    (the CPU's plain version) what a gather from them gives."""
    captured = []

    def scorer(inp):
        captured.append(inp)
        return scoring.score_prepared(inp)

    run, carry = _lattice_scan(repo_root, mode, 1, scorer=scorer)
    run(carry)
    inp = captured[0]
    assert isinstance(inp, scoring.FleetLatticeInputs)
    assert inp.stopping == (mode == "stopping")
    low_vel = inp.scalars[:, scoring._S_LOW_VEL] > 0.5
    assert low_vel.any() and not low_vel.all()
    for got, want in zip(scoring.score_prepared(inp), _grid_scorer(inp)):
        assert _bitwise_equal(got, want)
    assert torch.isfinite(got).any()
    cl, ca, tl, _ = _grid_candidates(inp)
    index = torch.randint(0, inp.grid.size, (cl.shape[0], 7),
                          generator=torch.Generator().manual_seed(0))
    got = scoring.lattice_candidates(inp, index)
    want = (torch.gather(cl, 1, index[..., None].expand(-1, -1, 6)),
            torch.gather(ca, 1, index[..., None].expand(-1, -1, 6)),
            torch.gather(tl, 1, index).to(torch.float32))
    for g, w in zip(got, want):
        assert _bitwise_equal(g, w)


@pytest.mark.parametrize("mode", ["velocity_keeping", "stopping"])
def test_fleet_scan_equals_the_grid_cycle(repo_root, mode):
    """The fleet scan over 5 cycles gives the carry and metrics, bit for
    bit, of the same scan with each cycle's candidates generated by
    ``ops.grid``, scored as ``FleetScorerInputs`` and the winners gathered
    from them; each built scan counts once on
    ``fleet_scan.lattice_scorer``."""
    before = profiling.counters().get("fleet_scan.lattice_scorer", 0)
    run, carry = _lattice_scan(repo_root, mode, 5)
    assert profiling.counters()["fleet_scan.lattice_scorer"] == before + 1
    final, metrics = run(carry)

    def gathered(inp, index):
        cl, ca, tl, _ = _grid_candidates(inp)
        F = index.shape[0]
        take = lambda a: torch.gather(a, 1, index[..., None].expand(F, 1, 6))
        return take(cl), take(ca), torch.gather(tl, 1, index)

    run_g, _ = _lattice_scan(repo_root, mode, 5, scorer=_grid_scorer,
                             candidates=gathered)
    final_g, metrics_g = run_g(carry)
    for a, b in zip(final, final_g):
        assert _bitwise_equal(a, b)
    for a, b in zip(metrics, metrics_g):
        assert _bitwise_equal(a, b)
    assert bool(metrics[0].any())


@pytest.mark.parametrize("plain", [True, False], ids=["plain", "kernel"])
def test_fleet_scan_winners_follow_the_scorer(repo_root, plain, monkeypatch):
    """The fleet scan takes its winners' coefficients from the scorer's own
    function: ``lattice_candidates_reference`` under the plain scorer (its
    scan is plain throughout, on any device), ``lattice_candidates`` under
    the default one; once per cycle, and the other never."""
    calls = {"lattice_candidates": 0, "lattice_candidates_reference": 0}
    plain_version = scoring.lattice_candidates_reference

    def spy(name):
        def counted(inp, index):      # on the CPU both give the plain rows
            calls[name] += 1
            return plain_version(inp, index)
        monkeypatch.setattr(scoring, name, counted)

    for name in calls:
        spy(name)
    scorer = scoring.score_prepared_reference if plain \
        else scoring.score_prepared
    run, carry = _lattice_scan(repo_root, "velocity_keeping", 2,
                               scorer=scorer)
    run(carry)
    used = "lattice_candidates_reference" if plain else "lattice_candidates"
    assert calls == {name: 2 if name == used else 0 for name in calls}
