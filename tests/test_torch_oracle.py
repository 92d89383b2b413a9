"""The numpy oracle (``baseline/oracle.py``): the port against the JAX package.

* The port's oracle equals the JAX oracle on the same batches: identical
  feasibility and reasons, state arrays and costs to 1e-12.
* The port's float64 ``kinematics.rollout`` plus default cost equals the
  port's oracle to 1e-9, with the same argmin, at the operating points of
  ``tests/test_kinematics_conformance.py:59-120``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from commonroad_rp_tpu.baseline import oracle as jax_oracle
from commonroad_rp_tpu.models.sampling import \
    FixedIntervalSampling as JaxSampling
from commonroad_rp_tpu.ops import frenet as jax_frenet
from commonroad_rp_tpu.utils.config import \
    ReactivePlannerConfiguration as JaxConfig

from commonroad_rp_tpu_torch.baseline import oracle
from commonroad_rp_tpu_torch.models.sampling import FixedIntervalSampling
from commonroad_rp_tpu_torch.ops import cost as cost_ops
from commonroad_rp_tpu_torch.ops import frenet, kinematics
from commonroad_rp_tpu_torch.utils.config import ReactivePlannerConfiguration

CONSTRAINTS = ["velocity", "acceleration", "kappa", "kappa_dot", "yaw_rate"]
REASON_BY_CODE = {**kinematics.REASON_NAMES,
                  kinematics.REASON_DOMAIN: "domain"}
ARRAY_KEYS = ("x", "y", "theta_gl", "theta_cl", "v", "a", "kappa_gl",
              "kappa_dot", "s", "s_dot", "s_ddot", "d", "d_dot", "d_ddot")


def _curved_ref_path(n=400):
    """Gentle S-curve, ~200 m long (tests/test_kinematics_conformance.py)."""
    xs = np.linspace(0.0, 200.0, n)
    return np.stack([xs, 8.0 * np.sin(xs / 60.0)], axis=1)


def _config(cls):
    cfg = cls()
    cfg.planning.time_steps_computation = 20
    cfg.sampling.t_min = 0.4
    return cfg


def _oracle_vehicle(module, cfg):
    v = cfg.vehicle
    return module.OracleVehicle(
        wheelbase=v.wheelbase, wb_rear_axle=v.wb_rear_axle, a_max=v.a_max,
        v_switch=v.v_switch, kappa_max=v.kappa_max, v_delta_max=v.v_delta_max,
        half_length=v.length / 2, half_width=v.width / 2)


def _vehicle(cfg):
    v = cfg.vehicle
    return kinematics.VehicleArrays(
        wheelbase=v.wheelbase, wb_rear_axle=v.wb_rear_axle, a_max=v.a_max,
        v_switch=v.v_switch, kappa_max=v.kappa_max,
        v_delta_max=v.v_delta_max, half_length=v.length / 2,
        half_width=v.width / 2)


def _operating_point(point):
    """(v0, low_vel, x_0_lon, x_0_lat, x0_theta, level, v window) of the
    fixed points and the randomized sweep's seeds."""
    if isinstance(point, tuple):
        v0, low_vel = point
        return (v0, low_vel, np.array([40.0, v0, 0.0]),
                np.array([0.5, 0.1 if not low_vel else 0.02, 0.0]), 0.12, 1,
                (max(0.0, v0 - 5.0), v0 + 5.0))
    rng = np.random.default_rng(point)
    v0 = float(rng.uniform(0.5, 22.0))
    low_vel = v0 < ReactivePlannerConfiguration().planning \
        .low_vel_mode_threshold
    window = (max(0.0, v0 - rng.uniform(2.0, 6.0)), v0 + rng.uniform(2.0, 6.0))
    x_0_lon = np.array([rng.uniform(15.0, 120.0), v0, rng.uniform(-2.0, 2.0)])
    x_0_lat = np.array([rng.uniform(-2.5, 2.5), rng.uniform(-0.3, 0.3),
                        rng.uniform(-0.2, 0.2)])
    x0_theta = float(rng.uniform(-0.3, 0.3))
    level = int(rng.integers(1, 4))
    return v0, low_vel, x_0_lon, x_0_lat, x0_theta, level, window


POINTS = [(15.0, False), (2.0, True), (8.0, False), 10, 11, 12, 13]


def _batch(cls, cfg_cls, point):
    v0, low_vel, x_0_lon, x_0_lat, x0_theta, level, window = \
        _operating_point(point)
    cfg = _config(cfg_cls)
    cfg.sampling.v_min, cfg.sampling.v_max = window
    batch = cls(cfg).generate_trajectories_at_level(
        level, x_0_lon, x_0_lat, "velocity_keeping", low_vel)
    return cfg, batch, v0, low_vel, x0_theta


@pytest.mark.parametrize("point", POINTS[:3] + POINTS[3:4],
                         ids=lambda p: str(p))
def test_oracle_matches_jax(point):
    cfg, batch, v0, low_vel, x0_theta = _batch(FixedIntervalSampling,
                                               ReactivePlannerConfiguration,
                                               point)
    jcfg, jbatch, *_ = _batch(JaxSampling, JaxConfig, point)
    np.testing.assert_array_equal(batch.coeffs_lon, jbatch.coeffs_lon)
    np.testing.assert_array_equal(batch.coeffs_lat, jbatch.coeffs_lat)
    N = cfg.planning.time_steps_computation
    ref = oracle.OracleRefPath.from_tables(
        frenet.from_polyline(_curved_ref_path(), dtype=torch.float64))
    jref = jax_oracle.OracleRefPath.from_tables(
        jax_frenet.from_polyline(_curved_ref_path(), dtype=jnp.float64))
    for field in ("points", "s", "theta", "curv", "curv_d", "tangent",
                  "normal"):
        np.testing.assert_allclose(getattr(ref, field), getattr(jref, field),
                                   rtol=0, atol=1e-12)
    kw = dict(w_a=5.0, desired_d=0.0, desired_speed=v0)
    got = oracle.evaluate_batch(batch, ref, _oracle_vehicle(oracle, cfg),
                                x0_theta, cfg.planning.dt, N, low_vel,
                                CONSTRAINTS, **kw)
    want = jax_oracle.evaluate_batch(jbatch, jref,
                                     _oracle_vehicle(jax_oracle, jcfg),
                                     x0_theta, jcfg.planning.dt, N, low_vel,
                                     CONSTRAINTS, **kw)
    assert [c.index for c in got] == [c.index for c in want]
    assert [c.feasible for c in got] == [c.feasible for c in want]
    assert [c.reason for c in got] == [c.reason for c in want]
    assert any(c.feasible for c in got)
    for g, w in zip(got, want):
        if w.feasible:
            for key in ARRAY_KEYS:
                np.testing.assert_allclose(g.arrays[key], w.arrays[key],
                                           rtol=1e-12, atol=1e-12)
            np.testing.assert_allclose(g.cost, w.cost, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("point", POINTS, ids=lambda p: str(p))
def test_rollout_matches_oracle(point):
    cfg, batch, v0, low_vel, x0_theta = _batch(FixedIntervalSampling,
                                               ReactivePlannerConfiguration,
                                               point)
    N = cfg.planning.time_steps_computation
    tables = frenet.from_polyline(_curved_ref_path(), dtype=torch.float64)
    res = kinematics.rollout(
        torch.as_tensor(batch.coeffs_lon), torch.as_tensor(batch.coeffs_lat),
        torch.as_tensor(batch.traj_len), tables, _vehicle(cfg), x0_theta,
        cfg.planning.dt, N, low_vel)
    cands = oracle.evaluate_batch(batch, oracle.OracleRefPath.from_tables(
        tables), _oracle_vehicle(oracle, cfg), x0_theta, cfg.planning.dt, N,
        low_vel, CONSTRAINTS, w_a=5.0, desired_d=0.0, desired_speed=v0)

    feasible = res.feasible.numpy()
    np.testing.assert_array_equal(feasible, [c.feasible for c in cands])
    reasons = res.reason.numpy()
    for k, cand in enumerate(cands):
        if not cand.feasible:
            assert REASON_BY_CODE[int(reasons[k])] == cand.reason, k
    for k, cand in enumerate(cands):
        if cand.feasible:
            for key in ARRAY_KEYS:
                np.testing.assert_allclose(
                    getattr(res, key)[k].numpy(), cand.arrays[key],
                    rtol=1e-9, atol=1e-9, err_msg=f"candidate {k} {key}")
    if feasible.any():
        costs = cost_ops.default_cost(res, w_a=5.0, desired_d=0.0,
                                      desired_speed=v0).numpy()
        want = np.array([c.cost for c in cands])
        np.testing.assert_allclose(costs[feasible], want[feasible],
                                   rtol=1e-9, atol=1e-9)
        assert int(np.argmin(np.where(feasible, costs, np.inf))) == \
            int(np.argmin(np.where(feasible, want, np.inf)))
