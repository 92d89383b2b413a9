"""The port's device primitives against the JAX package, in float64 and
float32: closed-form polynomials, Frenet lookups and Cartesian conversion,
the batched kinematic rollout (the main path's winner re-roll), and the
candidate grids of the sampling spaces."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from commonroad_rp_tpu.models import sampling as jax_sampling
from commonroad_rp_tpu.ops import frenet as jax_frenet
from commonroad_rp_tpu.ops import kinematics as jax_kin
from commonroad_rp_tpu.ops import polynomial as jax_poly
from commonroad_rp_tpu.utils.config import \
    ReactivePlannerConfiguration as JaxConfig
from commonroad_rp_tpu.utils.config import VehicleConfiguration

from commonroad_rp_tpu_torch import interop
from commonroad_rp_tpu_torch.models import sampling as port_sampling
from commonroad_rp_tpu_torch.ops import frenet as port_frenet
from commonroad_rp_tpu_torch.ops import kinematics as port_kin
from commonroad_rp_tpu_torch.ops import polynomial as port_poly
from commonroad_rp_tpu_torch.utils.config import \
    ReactivePlannerConfiguration as PortConfig

_DTYPES = {"float64": (jnp.float64, torch.float64, 1e-12),
           "float32": (jnp.float32, torch.float32, 2e-4)}


def _polyline():
    xs = np.linspace(0.0, 200.0, 400)
    return np.stack([xs, 6.0 * np.sin(xs / 70.0)], axis=1)


@pytest.mark.parametrize("dtype", sorted(_DTYPES))
def test_polynomials_match(dtype):
    jdt, tdt, tol = _DTYPES[dtype]
    rng = np.random.default_rng(0)
    x0 = rng.normal(size=(64, 3)) * [10.0, 5.0, 1.0]
    xd = rng.normal(size=(64, 3)) * [30.0, 5.0, 1.0]
    dtau = rng.uniform(0.4, 6.0, size=64)
    tau = rng.uniform(0.0, 6.0, size=(21, 64))
    J = lambda a: jnp.asarray(a, jdt)
    P = lambda a: torch.as_tensor(np.array(a), dtype=tdt)
    pairs = [(jax_poly.quintic_coeffs(J(x0), J(xd), J(dtau)),
              port_poly.quintic_coeffs(P(x0), P(xd), P(dtau))),
             (jax_poly.quartic_coeffs(J(x0), J(xd[:, 1]), J(dtau)),
              port_poly.quartic_coeffs(P(x0), P(xd[:, 1]), P(dtau)))]
    for cj, cp in pairs:
        np.testing.assert_allclose(cp.numpy(), np.asarray(cj), rtol=tol,
                                   atol=tol)
        for fj, fp in ((jax_poly.eval_position, port_poly.eval_position),
                       (jax_poly.eval_velocity, port_poly.eval_velocity),
                       (jax_poly.eval_acceleration,
                        port_poly.eval_acceleration)):
            want = np.asarray(fj(cj[None], J(tau)))
            got = fp(P(np.asarray(cj))[None], P(tau)).numpy()
            np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_frenet_lookups_and_cartesian_match():
    ref_j = jax_frenet.from_polyline(_polyline(), dtype=jnp.float64)
    ref_p = port_frenet.from_polyline(_polyline(), dtype=torch.float64)
    s_last = float(ref_p.s[-1])
    # in range, exactly on vertices, below 0 and beyond the end (-1 wrap)
    s = np.concatenate([np.linspace(-5.0, s_last + 5.0, 997),
                        np.asarray(ref_p.s[::37]), [s_last]])
    d = np.linspace(-3.0, 3.0, s.size)
    idx_j = np.asarray(jax_frenet.interp_index(ref_j, jnp.asarray(s)))
    idx_p = port_frenet.interp_index(ref_p, torch.as_tensor(s)).numpy()
    np.testing.assert_array_equal(idx_p, idx_j)
    assert (idx_p == -1).any()
    tv_j = jax_frenet.lookup_interp_values(ref_j, jnp.asarray(idx_j))
    tv_p = port_frenet.lookup_interp_values(ref_p, torch.as_tensor(idx_p))
    for field in tv_j._fields:
        np.testing.assert_array_equal(getattr(tv_p, field).numpy(),
                                      np.asarray(getattr(tv_j, field)))
    want = jax_frenet.to_cartesian(ref_j, jnp.asarray(s), jnp.asarray(d))
    got = port_frenet.to_cartesian(ref_p, torch.as_tensor(s),
                                   torch.as_tensor(d))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-12)
    angle = np.linspace(-20.0, 20.0, 101)
    np.testing.assert_allclose(
        port_frenet.wrap_two_pi(torch.as_tensor(angle)).numpy(),
        np.asarray(jax_frenet.wrap_two_pi(jnp.asarray(angle))), atol=1e-12)


@pytest.mark.parametrize("dtype,low_vel", [("float64", False),
                                           ("float32", False),
                                           ("float32", True)])
def test_rollout_matches(dtype, low_vel):
    """kinematics.rollout on a level-1 bundle: every [K, T] state array,
    the feasibility mask and the reason codes."""
    jdt, tdt, _ = _DTYPES[dtype]
    config = PortConfig()
    config.planning.time_steps_computation = 20
    space = port_sampling.FixedIntervalSampling(config)
    v0 = 2.5 if low_vel else 15.0
    space.samples_v = port_sampling.VelocitySampling(max(0.0, v0 - 4.0),
                                                     v0 + 4.0, 4)
    batch = space.generate_trajectories_at_level(
        1, np.array([40.0, v0, 0.2]), np.array([0.4, 0.05, 0.0]),
        "velocity_keeping", low_vel)
    ref_j = jax_frenet.from_polyline(_polyline(), dtype=jdt)
    vc = VehicleConfiguration()
    veh_j = jax_kin.VehicleArrays(*[jnp.asarray(x, jdt) for x in [
        vc.wheelbase, vc.wb_rear_axle, vc.a_max, vc.v_switch,
        np.tan(vc.delta_max) / vc.wheelbase, vc.v_delta_max,
        vc.length / 2, vc.width / 2]])
    want = jax_kin.rollout(jnp.asarray(batch.coeffs_lon, jdt),
                           jnp.asarray(batch.coeffs_lat, jdt),
                           jnp.asarray(batch.traj_len), ref_j, veh_j,
                           jnp.asarray(0.08, jdt), 0.1, 20, low_vel)
    got = port_kin.rollout(torch.as_tensor(batch.coeffs_lon, dtype=tdt),
                           torch.as_tensor(batch.coeffs_lat, dtype=tdt),
                           torch.as_tensor(batch.traj_len),
                           interop.ref_tables(ref_j), interop.vehicle(veh_j),
                           0.08, 0.1, 20, low_vel)
    feasible = np.asarray(want.feasible)
    np.testing.assert_array_equal(got.feasible.numpy(), feasible)
    np.testing.assert_array_equal(got.reason.numpy(), np.asarray(want.reason))
    assert feasible.any()
    atol = 1e-9 if dtype == "float64" else 1e-3
    for field in port_kin.RolloutResult._fields[:14]:
        np.testing.assert_allclose(getattr(got, field).numpy()[feasible],
                                   np.asarray(getattr(want, field))[feasible],
                                   rtol=1e-4, atol=atol, err_msg=field)


@pytest.mark.parametrize("mode,low_vel", [("velocity_keeping", False),
                                          ("velocity_keeping", True),
                                          ("stopping", False)])
def test_sampling_bundles_match(mode, low_vel):
    """The port's candidate grids equal the JAX package's at every level
    (the low-velocity arclength span uses the numpy polynomial)."""
    spaces = []
    for module, cfg_cls in ((jax_sampling, JaxConfig),
                            (port_sampling, PortConfig)):
        space = module.FixedIntervalSampling(cfg_cls())
        space.samples_v = module.VelocitySampling(0.5, 9.0, 4)
        space.samples_s = module.PositionSampling(45.0, 52.0, 4)
        spaces.append(space)
    x0_lon, x0_lat = np.array([40.0, 3.0, 0.4]), np.array([0.2, 0.1, 0.0])
    for level in range(4):
        want, got = (sp.generate_trajectories_at_level(
            level, x0_lon, x0_lat, mode, low_vel) for sp in spaces)
        for field in ("coeffs_lon", "coeffs_lat", "delta_tau",
                      "delta_tau_lat", "traj_len", "lon_xd_pos"):
            np.testing.assert_allclose(getattr(got, field),
                                       getattr(want, field), rtol=1e-12,
                                       atol=1e-12, err_msg=field)


# the six primitives no planning path calls: float64 to 1e-9, float32 to the
# file's tolerance
_PRIM_TOL = {"float64": 1e-9, "float32": _DTYPES["float32"][2]}


@pytest.mark.parametrize("dtype", sorted(_DTYPES))
def test_jerk_primitives_match(dtype):
    jdt, tdt, _ = _DTYPES[dtype]
    tol = _PRIM_TOL[dtype]
    rng = np.random.default_rng(3)
    c = rng.normal(size=(64, 6)) * [10.0, 5.0, 1.0, 0.5, 0.1, 0.02]
    tau = rng.uniform(-1.0, 7.0, size=(21, 64))
    t_end = rng.uniform(0.4, 6.0, size=64)
    J = lambda a: jnp.asarray(a, jdt)
    P = lambda a: torch.as_tensor(np.array(a), dtype=tdt)
    np.testing.assert_allclose(
        port_poly.eval_jerk(P(c)[None], P(tau)).numpy(),
        np.asarray(jax_poly.eval_jerk(J(c)[None], J(tau))), rtol=tol,
        atol=tol)
    np.testing.assert_allclose(
        port_poly.squared_jerk_integral(P(c), P(t_end)).numpy(),
        np.asarray(jax_poly.squared_jerk_integral(J(c), J(t_end))),
        rtol=tol, atol=tol)
    for tau_0, delta_tau in ((0.0, 2.0), (0.5, 4.0)):
        np.testing.assert_allclose(
            port_poly.evaluate_state_at_tau(P(c)[None], P(tau), tau_0,
                                            delta_tau).numpy(),
            np.asarray(jax_poly.evaluate_state_at_tau(J(c)[None], J(tau),
                                                      tau_0, delta_tau)),
            rtol=tol, atol=tol)


def test_squared_jerk_integral_numeric():
    """tests/test_polynomial.py's case on the port."""
    rng = np.random.default_rng(4)
    c = torch.as_tensor(rng.normal(size=6))
    T = 1.7
    taus = np.linspace(0.0, T, 20001)
    jerk = port_poly.eval_jerk(c, torch.as_tensor(taus)).numpy()
    numeric = np.trapezoid(jerk ** 2, taus)
    got = float(port_poly.squared_jerk_integral(c, torch.tensor(T)))
    np.testing.assert_allclose(got, numeric, rtol=1e-6)


def test_evaluate_state_clamps_like_reference():
    """tests/test_polynomial.py's case on the port: tau outside
    [tau_0, tau_0 + delta_tau] clamps (polynomial_trajectory.py:205-210)."""
    c = port_poly.quintic_coeffs(torch.tensor([0.0, 1.0, 0.0]),
                                 torch.tensor([5.0, 0.0, 0.0]),
                                 torch.tensor(2.0))
    inside = port_poly.evaluate_state_at_tau(c, torch.tensor(2.0), 0.0, 2.0)
    beyond = port_poly.evaluate_state_at_tau(c, torch.tensor(3.5), 0.0, 2.0)
    np.testing.assert_allclose(beyond.numpy(), inside.numpy(), atol=1e-12)


@pytest.mark.parametrize("dtype", sorted(_DTYPES))
def test_interp_primitives_match(dtype):
    jdt, tdt, _ = _DTYPES[dtype]
    tol = _PRIM_TOL[dtype]
    ref_j = jax_frenet.from_polyline(_polyline(), dtype=jdt)
    ref_p = port_frenet.from_polyline(_polyline(), dtype=tdt)
    s_last = float(ref_p.s[-1])
    s = np.concatenate([np.linspace(-5.0, s_last + 5.0, 997),
                        ref_p.s[::37].double().numpy(), [s_last]])
    s_j, s_p = jnp.asarray(s, jdt), torch.as_tensor(s, dtype=tdt)
    idx = port_frenet.interp_index(ref_p, s_p)
    np.testing.assert_array_equal(
        idx.numpy(), np.asarray(jax_frenet.interp_index(ref_j, s_j)))
    idx_j = jnp.asarray(idx.numpy())
    lam_p = port_frenet.interp_fraction(ref_p, s_p, idx)
    lam_j = jax_frenet.interp_fraction(ref_j, s_j, idx_j)
    np.testing.assert_allclose(lam_p.numpy(), np.asarray(lam_j), rtol=tol,
                               atol=tol)
    for field in ("curv", "curv_d", "theta"):
        np.testing.assert_allclose(
            port_frenet.interp_table(getattr(ref_p, field), idx,
                                     lam_p).numpy(),
            np.asarray(jax_frenet.interp_table(getattr(ref_j, field), idx_j,
                                               lam_j)), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", sorted(_DTYPES))
def test_to_curvilinear_matches(dtype, monkeypatch):
    """Against the JAX function, and against the host projection of
    ``CoordinateSystem.convert_to_curvilinear_coords`` (its native and its
    numpy route) on the same tables."""
    from commonroad_rp_tpu_torch import native
    from commonroad_rp_tpu_torch.utils.coordinate_system import \
        CoordinateSystem

    jdt, tdt, _ = _DTYPES[dtype]
    tol = _PRIM_TOL[dtype]
    ref_j = jax_frenet.from_polyline(_polyline(), dtype=jdt)
    ref_p = port_frenet.from_polyline(_polyline(), dtype=tdt)
    rng = np.random.default_rng(5)
    pts = _polyline()[rng.integers(2, 398, 300)] + \
        rng.uniform(-4.0, 4.0, (300, 2))
    s_j, d_j = jax_frenet.to_curvilinear(ref_j, jnp.asarray(pts[:, 0], jdt),
                                         jnp.asarray(pts[:, 1], jdt))
    s_p, d_p = port_frenet.to_curvilinear(
        ref_p, torch.as_tensor(pts[:, 0], dtype=tdt),
        torch.as_tensor(pts[:, 1], dtype=tdt))
    np.testing.assert_allclose(s_p.numpy(), np.asarray(s_j), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(d_p.numpy(), np.asarray(d_j), rtol=tol,
                               atol=tol)
    if dtype != "float64":
        return
    co = CoordinateSystem(tables=ref_p)
    for route in ("native", "numpy"):
        if route == "numpy":
            monkeypatch.setattr(native, "available", lambda: False)
        host = np.array([co.convert_to_curvilinear_coords(*p) for p in pts])
        np.testing.assert_allclose(s_p.numpy(), host[:, 0], atol=1e-9)
        np.testing.assert_allclose(d_p.numpy(), host[:, 1], atol=1e-9)
