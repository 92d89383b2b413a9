"""The port's XLA fleet path against the JAX package's.

* ``make_fleet_rollout`` (and ``make_fleet_step``) against JAX
  ``make_fleet_rollout(make_fleet_mesh(1), ...)`` on the same
  ``build_fleet_scene`` inputs, carried across with ``interop``, at the bars
  of the JAX package's XLA-vs-Pallas tests (``tests/test_pallas_fleet.py:
  62-73, 111-120``): identical ``found`` every cycle, ``x0_lon`` within
  rtol 2e-4 / atol 2e-3, ``velocity`` within atol 2e-3, ``best_cost`` within
  rtol 2e-3, identical ``fleet_success`` and ``fleet_mean_cost`` within rtol
  2e-3.  Cases, from ``tests/test_fleet.py``: (a) the four-scenario fleet
  with one shared vehicle; (b) three vehicle types with ``veh=None``; (c)
  ``pad_fleet`` of F=5 over 4 shards, run shard by shard; (d) the
  standstill branch; (e) disc and polygon obstacles.
* ``check_collisions`` and ``check_corridor`` with a leading problem axis
  against ``jax.vmap`` of the single-problem functions: identical masks, on
  a synthetic fleet with box, disc, polygon and padded rows.
"""

import logging
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from commonroad_rp_tpu.ops import collision as jax_co
from commonroad_rp_tpu.ops import grid as jax_grid
from commonroad_rp_tpu.ops import kinematics as jax_kin
from commonroad_rp_tpu.parallel import fleet as jax_fleet
from commonroad_rp_tpu.parallel.mesh import make_fleet_mesh
from commonroad_rp_tpu.utils.config import VehicleConfiguration
from commonroad_rp_tpu.utils.general import load_scenario_and_planning_problem
from commonroad_rp_tpu.utils.route import RoutePlanner

from commonroad_rp_tpu_torch import interop
from commonroad_rp_tpu_torch.ops import collision as co
from commonroad_rp_tpu_torch.ops import grid
from commonroad_rp_tpu_torch.ops.kinematics import VehicleArrays
from commonroad_rp_tpu_torch.parallel import fleet
from commonroad_rp_tpu_torch.parallel.mesh import shard_fleet

logging.getLogger("RP_LOGGER").setLevel(logging.CRITICAL)

DT = 0.1
SCENARIOS = ("ZAM_Over-1_1", "DEU_Test-1_1_T-1", "ZAM_Tjunction-1_42_T-1",
             "ZAM-Ramp-1_1-T-1")


def _bmw():
    vc = VehicleConfiguration()
    return [np.float32(x) for x in (
        vc.wheelbase, vc.wb_rear_axle, vc.a_max, vc.v_switch,
        np.tan(vc.delta_max) / vc.wheelbase, vc.v_delta_max,
        vc.length / 2, vc.width / 2)]


def _problem(repo_root, name, n_steps, vehicle=None, horizon_pad=30,
             path=None, velocity=None):
    scenario, pp, _ = load_scenario_and_planning_problem(
        str(path or repo_root / "example_scenarios" / f"{name}.xml"))
    if velocity is not None:
        pp.initial_state.velocity = velocity
        pp.initial_state.yaw_rate = 0.0
        pp.initial_state.acceleration = 0.0
    route = RoutePlanner(scenario, pp).plan_routes().retrieve_first_route()
    return jax_fleet.problem_from_planner_setup(
        scenario, pp, route.reference_path, n_steps=n_steps,
        horizon_pad=horizon_pad, dtype=jnp.float32, vehicle=vehicle)


def _runs(n_steps, n_cycles, shared, level=1, n_devices=1):
    """(JAX run, port run) of make_fleet_rollout: the BMW 320i shared by
    every problem, or (``shared`` False) each problem's own vehicle."""
    args = (DT, n_steps)
    kw = dict(replan_offset=3, low_vel_threshold=4.0, horizon=n_steps * DT,
              n_cycles=n_cycles)
    run_j = jax_fleet.make_fleet_rollout(
        make_fleet_mesh(n_devices),
        jax_kin.VehicleArrays(*_bmw()) if shared else None,
        jax_grid.make_static_grid(level, 0.4, n_steps * DT, DT, -3.0, 3.0, 4),
        *args, **kw)
    run_p = fleet.make_fleet_rollout(
        None, VehicleArrays(*map(float, _bmw())) if shared else None,
        grid.make_static_grid(level, 0.4, n_steps * DT, DT, -3.0, 3.0, 4),
        *args, **kw, device="cpu")
    return run_j, run_p


def _port(scene, carry):
    return interop.fleet_scene(scene), interop.fleet_carry(carry)


def _assert_fleet_close(final_j, metrics_j, final_p, metrics_p):
    """The bars of tests/test_pallas_fleet.py:62-73, 111-120 (the JAX
    carry and metrics carried across with ``interop``)."""
    final_j = interop.fleet_carry(final_j)
    metrics_j = interop.cycle_metrics(metrics_j)
    assert metrics_j.orientation is None
    torch.testing.assert_close(metrics_p.found, metrics_j.found, rtol=0,
                               atol=0)
    torch.testing.assert_close(final_p.x0_lon, final_j.x0_lon, rtol=2e-4,
                               atol=2e-3)
    torch.testing.assert_close(final_p.velocity, final_j.velocity, rtol=0,
                               atol=2e-3)
    np.testing.assert_allclose(metrics_p.best_cost.numpy(),
                               metrics_j.best_cost.numpy(), rtol=2e-3)
    np.testing.assert_array_equal(metrics_p.fleet_success.numpy(),
                                  metrics_j.fleet_success.numpy())
    torch.testing.assert_close(metrics_p.fleet_mean_cost,
                               metrics_j.fleet_mean_cost, rtol=2e-3, atol=0)


def test_mixed_scenario_fleet(repo_root):
    """(a) tests/test_fleet.py:94-142: the four bundled scenarios, one shared
    vehicle, level 1, 3 cycles."""
    n_steps = 20
    problems = [_problem(repo_root, name, n_steps) for name in SCENARIOS]
    scene, carry = jax_fleet.build_fleet_scene(problems, n_steps,
                                               dtype=jnp.float32)
    run_j, run_p = _runs(n_steps, 3, shared=True)
    final_j, metrics_j = run_j(carry, scene)
    final_p, metrics_p = run_p(*reversed(_port(scene, carry)))
    assert metrics_p.found[0].all()
    _assert_fleet_close(final_j, metrics_j, final_p, metrics_p)
    # the port's extra metrics are the advanced carry's heading and speed
    alive = metrics_p.found[-1]
    np.testing.assert_array_equal(metrics_p.velocity[-1][alive].numpy(),
                                  final_p.velocity[alive].numpy())


def test_heterogeneous_vehicle_fleet(repo_root):
    """(b) tests/test_fleet.py:145-184: three vehicle types on ZAM_Over with
    ``veh=None`` (each problem's own vehicle), one ``make_fleet_step`` and a
    3-cycle rollout."""
    n_steps = 20
    problems = [_problem(repo_root, "ZAM_Over-1_1", n_steps,
                         vehicle=VehicleConfiguration(id_type_vehicle=vid))
                for vid in (1, 2, 3)]
    scene, carry = jax_fleet.build_fleet_scene(problems, n_steps,
                                               dtype=jnp.float32)
    scene_p, carry_p = _port(scene, carry)
    assert len(set(np.round(scene_p.veh.kappa_max.numpy(), 6))) == 3

    grid_j = jax_grid.make_static_grid(1, 0.4, n_steps * DT, DT, -3.0, 3.0, 4)
    step_j = jax_fleet.make_fleet_step(
        make_fleet_mesh(1), None, grid_j, DT, n_steps, replan_offset=3,
        low_vel_threshold=4.0, horizon=n_steps * DT)
    step_p = fleet.make_fleet_step(
        None, None, grid.make_static_grid(1, 0.4, n_steps * DT, DT, -3.0,
                                          3.0, 4),
        DT, n_steps, replan_offset=3, low_vel_threshold=4.0,
        horizon=n_steps * DT, device="cpu")
    new_j, m_j = jax.jit(step_j)(carry, scene)
    new_p, m_p = step_p(carry_p, scene_p)
    assert m_p.found.all()
    np.testing.assert_array_equal(m_p.found.numpy(), np.asarray(m_j.found))
    np.testing.assert_allclose(new_p.x0_lon.numpy(), np.asarray(new_j.x0_lon),
                               rtol=2e-4, atol=2e-3)
    np.testing.assert_allclose(m_p.best_cost.numpy(),
                               np.asarray(m_j.best_cost), rtol=2e-3)

    run_j, run_p = _runs(n_steps, 3, shared=False)
    _assert_fleet_close(*run_j(carry, scene), *run_p(carry_p, scene_p))


def test_fleet_uneven_shards(repo_root):
    """(c) tests/test_fleet.py:220-255: F=5 padded to 8 for 4 shards; the
    port runs each rank's slice alone (``shard_fleet``), the JAX package the
    padded fleet on a 4-device mesh.  The padded members stay dead, and the
    shards' summed aggregates equal the mesh's."""
    n_steps = 10
    problems = [_problem(repo_root, "ZAM_Over-1_1", n_steps)] * 5
    scene, carry = jax_fleet.build_fleet_scene(problems, n_steps,
                                               dtype=jnp.float32)
    scene_jp, carry_jp, F = jax_fleet.pad_fleet(scene, carry, 4)
    run_j, run_p = _runs(n_steps, 3, shared=True, n_devices=4)
    final_j, metrics_j = run_j(carry_jp, scene_jp)

    scene_p, carry_p = _port(scene, carry)
    shards = [shard_fleet(scene_p, carry_p, rank, 4) for rank in range(4)]
    assert all(s[2] == F == 5 for s in shards)
    outs = [run_p(c, s) for s, c, _ in shards]
    cat = lambda get: torch.cat([get(o) for o in outs], dim=-1)
    found = cat(lambda o: o[1].found)
    assert not found[:, F:].any()
    assert torch.isinf(cat(lambda o: o[1].best_cost)[:, F:]).all()
    np.testing.assert_array_equal(found.numpy(), np.asarray(metrics_j.found))
    np.testing.assert_allclose(
        torch.cat([o[0].x0_lon for o in outs]).numpy(),
        np.asarray(final_j.x0_lon), rtol=2e-4, atol=2e-3)
    np.testing.assert_allclose(cat(lambda o: o[1].best_cost).numpy(),
                               np.asarray(metrics_j.best_cost), rtol=2e-3)
    total = sum(o[1].fleet_success for o in outs)
    np.testing.assert_array_equal(total.numpy(),
                                  np.asarray(metrics_j.fleet_success))
    cost = cat(lambda o: o[1].best_cost)
    finite = torch.isfinite(cost)
    mean = torch.where(finite, cost, 0.0).sum(1) / finite.sum(1).clamp(min=1)
    np.testing.assert_allclose(mean.numpy(),
                               np.asarray(metrics_j.fleet_mean_cost),
                               rtol=2e-3)


def test_xla_fleet_standstill_fallback(repo_root):
    """(d) tests/test_fleet.py:356-: a blocked member at v ~ 0 plans the
    standstill fallback (pose frozen, v = 0, cost 0) and stays alive."""
    n_steps = 20
    problem = _problem(repo_root, "ZAM_Over-1_1", n_steps, horizon_pad=60,
                       velocity=0.04)
    scene, carry = jax_fleet.build_fleet_scene([problem], n_steps,
                                               dtype=jnp.float32)
    scene = scene._replace(
        corridor_lo=jnp.full_like(scene.corridor_lo, 0.001),
        corridor_hi=jnp.full_like(scene.corridor_hi, 0.002))
    run_j, run_p = _runs(n_steps, 4, shared=False)
    final_j, metrics_j = run_j(carry, scene)
    final_p, metrics_p = run_p(*reversed(_port(scene, carry)))
    assert metrics_p.found.all()
    np.testing.assert_array_equal(metrics_p.best_cost.numpy(), 0.0)
    np.testing.assert_allclose(metrics_p.x.numpy(), float(problem["px"]),
                               atol=1e-5)
    np.testing.assert_allclose(final_p.velocity.numpy(), 0.0)
    assert int(final_p.time_step[0]) == int(final_j.time_step[0]) == 12
    _assert_fleet_close(final_j, metrics_j, final_p, metrics_p)


def test_fleet_disc_obstacles(repo_root, tmp_path):
    """(e) tests/test_fleet.py:293-: a disc moved to the right edge of the
    lane and the scenario's triangle (the polygon group) -- the fleet
    collision pass with disc rows and the polygon pass in the same cycle."""
    from commonroad_rp_tpu.ops.collision import ObstacleArrays
    from tests.test_circle_obstacle_e2e import _SCENARIO

    path = tmp_path / "SYN_Disc-1_1.xml"
    path.write_text(textwrap.dedent(_SCENARIO))
    n_steps = 15
    problem = _problem(repo_root, None, n_steps, path=path)
    obs = problem["obstacles"]
    pose = np.asarray(obs.pose).copy()
    pose[0, :, 1] = -2.2
    problem["obstacles"] = ObstacleArrays(
        pose=jnp.asarray(pose, jnp.float32), half_ext=obs.half_ext,
        valid=obs.valid, radius=obs.radius, poly_verts=obs.poly_verts,
        poly_valid=obs.poly_valid)
    assert obs.radius is not None and obs.poly_verts is not None
    scene, carry = jax_fleet.build_fleet_scene([problem] * 2, n_steps,
                                               dtype=jnp.float32)
    run_j, run_p = _runs(n_steps, 10, shared=True)
    final_j, metrics_j = run_j(carry, scene)
    final_p, metrics_p = run_p(*reversed(_port(scene, carry)))
    assert metrics_p.found.all()
    assert float(metrics_p.x.max()) > 45.0
    assert float(final_p.x0_lat[:, 0].abs().max()) > 0.2
    _assert_fleet_close(final_j, metrics_j, final_p, metrics_p)


# ---------------------------------------------------------------------------
# the fleet forms of check_collisions / check_corridor
# ---------------------------------------------------------------------------

def _synthetic_fleet(seed=0, F=3, K=96, T=11, P=40):
    """Trajectories [F, K, T] on a straight road through box, disc and
    polygon rows; row 3 is a padded row (invalid, half extents 1), problem 1
    has no valid polygon step; per-problem ego extents."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    t = np.arange(T) * 0.5
    v = rng.uniform(4.0, 12.0, (F, K, 1))
    x = f32(v * t + rng.uniform(0.0, 10.0, (F, K, 1)))
    y = f32(rng.uniform(-4.0, 4.0, (F, K, 1)) + rng.uniform(-0.4, 0.4,
                                                             (F, K, 1)) * t)
    theta = f32(rng.uniform(-0.3, 0.3, (F, K, T)))
    M = 4
    pose = np.zeros((F, M, T, 3))
    pose[:, :3, :, 0] = rng.uniform(15.0, 60.0, (F, 3, 1)) \
        + rng.uniform(0.0, 3.0, (F, 3, 1)) * t
    pose[:, :3, :, 1] = rng.uniform(-3.0, 3.0, (F, 3, 1))
    pose[:, :3, :, 2] = rng.uniform(-0.5, 0.5, (F, 3, 1))
    half = np.ones((F, M, 2))
    half[:, :2] = rng.uniform(0.8, 2.5, (F, 2, 2))
    half[:, 2] = 0.0
    radius = np.zeros((F, M))
    radius[:, 2] = rng.uniform(0.8, 1.8, F)
    valid = rng.random((F, M, T)) > 0.2
    valid[:, 3] = False
    body = np.array([[-1.5, -1.0], [1.5, -1.2], [2.0, 0.4], [0.0, 1.5],
                     [0.0, 1.5]])                          # V = 5, padded
    center = np.stack([rng.uniform(20.0, 50.0, (F, 2, 1)) + 1.0 * t,
                       np.broadcast_to(rng.uniform(-2.0, 2.0, (F, 2, 1)),
                                       (F, 2, T))], axis=-1)   # [F, 2, T, 2]
    verts = body[None, None, None] + center[:, :, :, None, :]
    pvalid = np.ones((F, 2, T), bool)
    pvalid[1] = False
    s_tab = np.cumsum(rng.uniform(1.5, 2.5, (F, P)), axis=1)
    d_lo = -rng.uniform(2.0, 5.0, (F, P))
    d_hi = rng.uniform(2.0, 5.0, (F, P))
    veh = [f32(rng.uniform(lo, hi, F)) for lo, hi in
           ((1.8, 2.6), (0.7, 1.0), (1.0, 1.6))]          # hl, hw, wb
    return dict(x=x, y=y, theta=theta, pose=f32(pose), half=f32(half),
                valid=valid, radius=f32(radius), verts=f32(verts),
                pvalid=pvalid, s_tab=f32(s_tab), d_lo=f32(d_lo),
                d_hi=f32(d_hi), veh=veh)


@pytest.mark.parametrize("seed", [0, 1])
def test_check_collisions_fleet_matches_vmap(seed):
    d = _synthetic_fleet(seed)

    def single(x, y, theta, pose, half, valid, radius, verts, pvalid, hl,
               hw, wb):
        obstacles = jax_co.ObstacleArrays(pose=pose, half_ext=half,
                                          valid=valid, radius=radius,
                                          poly_verts=verts, poly_valid=pvalid)
        return jax_co.check_collisions(x, y, theta, obstacles, None, hl, hw,
                                       wb)

    want = np.asarray(jax.vmap(single)(
        d["x"], d["y"], d["theta"], d["pose"], d["half"], d["valid"],
        d["radius"], d["verts"], d["pvalid"], *d["veh"]))
    t = lambda a: torch.as_tensor(a)
    got = co.check_collisions(
        t(d["x"]), t(d["y"]), t(d["theta"]),
        co.ObstacleArrays(pose=t(d["pose"]), half_ext=t(d["half"]),
                          valid=t(d["valid"]), radius=t(d["radius"]),
                          poly_verts=t(d["verts"]), poly_valid=t(d["pvalid"])),
        None, *map(t, d["veh"]))
    assert got.shape == want.shape == (3, 96)
    assert 0 < int(want.sum()) < want.size
    np.testing.assert_array_equal(got.numpy(), want)

    # without the polygon group, and with one shared vehicle (floats)
    boxes = co.ObstacleArrays(pose=t(d["pose"]), half_ext=t(d["half"]),
                              valid=t(d["valid"]), radius=t(d["radius"]))
    want_box = np.asarray(jax.vmap(
        lambda x, y, th, p, h, v, r: jax_co.check_collisions(
            x, y, th, jax_co.ObstacleArrays(p, h, v, r), None,
            np.float32(2.2), np.float32(0.9), np.float32(1.4)))(
        d["x"], d["y"], d["theta"], d["pose"], d["half"], d["valid"],
        d["radius"]))
    got_box = co.check_collisions(t(d["x"]), t(d["y"]), t(d["theta"]),
                                  boxes, None, float(np.float32(2.2)),
                                  float(np.float32(0.9)),
                                  float(np.float32(1.4)))
    np.testing.assert_array_equal(got_box.numpy(), want_box)


@pytest.mark.parametrize("seed", [0, 1])
def test_check_corridor_fleet_matches_vmap(seed):
    d = _synthetic_fleet(seed)
    rng = np.random.default_rng(seed + 10)
    s = np.asarray(d["x"] + rng.uniform(-5.0, 20.0, (3, 1, 1)), np.float32)
    active = rng.random(s.shape) > 0.1

    def single(s_, d_, th, ref_s, lo, hi, act, hl, hw, wb):
        return jax_co.check_corridor(s_, d_, th, ref_s,
                                     jax_co.CorridorArrays(lo, hi), hl, hw,
                                     wb, act)

    want = np.asarray(jax.vmap(single)(
        s, d["y"], d["theta"], d["s_tab"], d["d_lo"], d["d_hi"], active,
        *d["veh"]))
    t = lambda a: torch.as_tensor(a)
    got = co.check_corridor(t(s), t(d["y"]), t(d["theta"]), t(d["s_tab"]),
                            co.CorridorArrays(t(d["d_lo"]), t(d["d_hi"])),
                            *map(t, d["veh"]), active=t(active))
    assert 0 < int(want.sum()) < want.size
    np.testing.assert_array_equal(got.numpy(), want)
