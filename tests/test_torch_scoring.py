"""The port's fused scorer (plain PyTorch version) against the TPU kernel.

The same candidates and scene, made with numpy and the JAX package's grid
helpers, go through ``pallas_cycle.score_candidates_pallas(...,
interpret=True)`` and ``commonroad_rp_tpu_torch.ops.scoring.score_candidates``
on CPU tensors (which runs ``score_candidates_reference``).  The bar is the
one ``tests/test_pallas_cycle.py`` sets between the Pallas and XLA paths:
identical finite/+inf patterns of the masked and kinematic rows, finite
costs within rtol 2e-4 / atol 1e-2 (float32 sums taken in another order),
the same argmin (or an exact cost tie), and identical reason codes for every
candidate whose active steps stay inside [0, s_last] (below s = 0 the TPU
kernel reads all-zero table rows, the port real rows; both mask the
candidate as out of domain).  The kernel-on-the-card comparison is in
``tests/test_torch_gpu.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from commonroad_rp_tpu.ops import collision as jax_collision
from commonroad_rp_tpu.ops import frenet as jax_frenet
from commonroad_rp_tpu.ops import grid as grid_ops
from commonroad_rp_tpu.ops import kinematics as jax_kin
from commonroad_rp_tpu.ops import pallas_cycle
from commonroad_rp_tpu.utils.config import VehicleConfiguration

from commonroad_rp_tpu_torch import interop
from commonroad_rp_tpu_torch.ops import scoring

RTOL, ATOL = 2e-4, 1e-2


def _scene(level=1, v0=15.0, low_vel=False, n_steps=20, obstacle="obb"):
    """The fixture shape of tests/test_pallas_cycle.py::_setup, with a
    choice of obstacle group."""
    dtype = jnp.float32
    dt = 0.1
    xs = np.linspace(0.0, 200.0, 400)
    ys = 6.0 * np.sin(xs / 70.0)
    ref = jax_frenet.from_polyline(np.stack([xs, ys], axis=1), dtype=dtype)
    P = ref.s.shape[0]
    corridor = jax_collision.CorridorArrays(
        d_lo=jnp.full(P, -4.0, dtype), d_hi=jnp.full(P, 4.0, dtype))
    vc = VehicleConfiguration()
    veh = jax_kin.VehicleArrays(*[jnp.asarray(x, dtype) for x in [
        vc.wheelbase, vc.wb_rear_axle, vc.a_max, vc.v_switch,
        np.tan(vc.delta_max) / vc.wheelbase, vc.v_delta_max,
        vc.length / 2, vc.width / 2]])
    grid = grid_ops.make_static_grid(level, 0.4, n_steps * dt, dt,
                                     -3.0, 3.0, 4)
    x0_lon = jnp.asarray([40.0, v0, 0.2], dtype)
    x0_lat = jnp.asarray([0.4, 0.05, 0.0], dtype)
    cl, ca, tl = grid_ops.velocity_keeping_candidates(
        x0_lon, x0_lat, jnp.asarray(max(0.0, v0 - 4.0), dtype),
        jnp.asarray(v0 + 4.0, dtype), jnp.asarray(low_vel), grid)

    T = n_steps + 1
    if obstacle == "obb":
        pose = np.zeros((1, T, 3), np.float32)
        pose[0, :, 0] = 70.0
        pose[0, :, 1] = 4.5
        obs = jax_collision.ObstacleArrays(
            pose=jnp.asarray(pose), half_ext=jnp.asarray([[2.5, 1.0]], dtype),
            valid=jnp.ones((1, T), dtype=bool))
    elif obstacle == "disc":
        # one OBB row (radius 0) and one disc row, the disc moving
        pose = np.zeros((2, T, 3), np.float32)
        pose[0, :, :2] = [70.0, 4.5]
        pose[1, :, 0] = 52.0 + 0.8 * np.arange(T)
        pose[1, :, 1] = 0.9
        valid = np.ones((2, T), bool)
        valid[1, :3] = False
        obs = jax_collision.ObstacleArrays(
            pose=jnp.asarray(pose),
            half_ext=jnp.asarray([[2.5, 1.0], [0.0, 0.0]], dtype),
            valid=jnp.asarray(valid), radius=jnp.asarray([0.0, 1.2], dtype))
    elif obstacle == "polygon":
        # no OBB rows; one convex piece (a pentagon padded to V=6 by
        # repeating its last vertex) drifting across the lane
        body = np.array([[-1.5, -1.0], [1.5, -1.2], [2.0, 0.4], [0.0, 1.5],
                         [-1.8, 0.6], [-1.8, 0.6]])
        verts = np.zeros((1, T, 6, 2), np.float32)
        for i in range(T):
            verts[0, i] = body + np.array([58.0 + 0.5 * i, 2.2 - 0.05 * i])
        pvalid = np.ones((1, T), bool)
        obs = jax_collision.ObstacleArrays(
            pose=jnp.zeros((0, T, 3), dtype), half_ext=jnp.zeros((0, 2), dtype),
            valid=jnp.zeros((0, T), dtype=bool),
            poly_verts=jnp.asarray(verts), poly_valid=jnp.asarray(pvalid))
    else:
        obs = jax_collision.ObstacleArrays(
            pose=jnp.zeros((0, T, 3), dtype), half_ext=jnp.zeros((0, 2), dtype),
            valid=jnp.zeros((0, T), dtype=bool))
    return dict(ref=ref, corridor=corridor, veh=veh, cl=cl, ca=ca, tl=tl,
                goal_valid=np.ones(cl.shape[0], bool), obstacles=obs, dt=dt,
                n_steps=n_steps, x0_theta=0.08, low_vel=low_vel,
                desired_v=v0, desired_d=0.0, w_a=5.0, desired_s=None,
                has_desired_v=True)


def _score_jax(sc):
    packed = pallas_cycle.pack_ref_tables(sc["ref"], sc["corridor"])
    out = pallas_cycle.score_candidates_pallas(
        sc["cl"], sc["ca"], sc["tl"], jnp.asarray(sc["goal_valid"]), packed,
        sc["obstacles"], sc["veh"], jnp.float32(sc["x0_theta"]), sc["dt"],
        jnp.asarray(sc["low_vel"]), jnp.float32(sc["desired_v"]),
        jnp.float32(sc["desired_d"]), jnp.float32(sc["w_a"]),
        pallas_cycle.true_path_length(sc["ref"]),
        None if sc["desired_s"] is None else jnp.float32(sc["desired_s"]),
        n_steps=sc["n_steps"], interpret=True,
        has_desired_v=sc["has_desired_v"])
    return [np.asarray(x) for x in out]


def _port_inputs(sc, device="cpu"):
    ref = interop.ref_tables(sc["ref"], device, torch.float32)
    corridor = interop.corridor(sc["corridor"], device, torch.float32)
    cl, ca, tl, gv = interop.candidates(sc["cl"], sc["ca"], sc["tl"],
                                        sc["goal_valid"], device=device)
    args = (cl, ca, tl, gv, scoring.pack_ref_tables(ref, corridor),
            interop.obstacles(sc["obstacles"], device, torch.float32),
            interop.vehicle(sc["veh"]), sc["x0_theta"], sc["dt"],
            sc["low_vel"], sc["desired_v"], sc["desired_d"], sc["w_a"],
            scoring.true_path_length(ref), sc["desired_s"])
    kwargs = dict(n_steps=sc["n_steps"], has_desired_v=sc["has_desired_v"])
    return args, kwargs


def _score_port(sc):
    args, kwargs = _port_inputs(sc)
    return [x.numpy() for x in scoring.score_candidates(*args, **kwargs)]


def _in_domain(sc):
    """Candidates whose active steps all lie in [0, s_last] (float32 rollout
    of s, as both scorers compute it)."""
    cl = np.asarray(sc["cl"], np.float32)
    tl = np.asarray(sc["tl"])
    T = sc["n_steps"] + 1
    t = (np.arange(T, dtype=np.float32) * np.float32(sc["dt"]))[:, None]
    t2 = t * t
    s = (cl[:, 0] + cl[:, 1] * t + cl[:, 2] * t2 + cl[:, 3] * (t2 * t)
         + cl[:, 4] * (t2 * t2) + cl[:, 5] * (t2 * t2 * t))
    active = np.arange(T)[:, None] < tl[None, :]
    s_last = np.float32(np.asarray(sc["ref"].s)[-1])
    return np.all(((s >= 0) & (s <= s_last)) | ~active, axis=0)


def assert_scorer_parity(want, got, in_domain):
    """The parity bar of the module docstring; ``want``/``got`` are
    (masked, kin, reason) numpy rows."""
    nan_inf = lambda x: np.where(np.isnan(x), np.inf, x)
    for name, w, g in zip(("masked", "kin"), want[:2], got[:2]):
        w, g = nan_inf(w), nan_inf(g)
        np.testing.assert_array_equal(np.isfinite(g), np.isfinite(w),
                                      err_msg=f"{name} finite pattern")
        fin = np.isfinite(w)
        np.testing.assert_allclose(g[fin], w[fin], rtol=RTOL, atol=ATOL,
                                   err_msg=f"{name} costs")
    w, g = nan_inf(want[0]), nan_inf(got[0])
    if np.isfinite(w).any():
        iw, ig = int(np.argmin(w)), int(np.argmin(g))
        assert iw == ig or np.isclose(w[iw], g[ig], rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got[2][in_domain], want[2][in_domain],
                                  err_msg="reason codes")


_CASES = {
    "obb_t21": dict(),
    "no_obstacles": dict(obstacle="none"),
    "low_velocity": dict(v0=2.5, low_vel=True),
    "disc_row": dict(obstacle="disc"),
    "polygon_piece": dict(obstacle="polygon"),
    "t61_level1": dict(n_steps=60),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_plain_scorer_matches_tpu_kernel(case):
    sc = _scene(**_CASES[case])
    want, got = _score_jax(sc), _score_port(sc)
    assert np.isfinite(want[1]).any(), "degenerate: no feasible candidate"
    assert_scorer_parity(want, got, _in_domain(sc))


def test_plain_scorer_stopping_term():
    """Stopping mode: quintics toward stop positions, the desired_s cost
    terms and goal-behind filtering."""
    sc = _scene(v0=8.0, obstacle="none")
    grid = grid_ops.make_static_grid(1, 0.4, sc["n_steps"] * sc["dt"],
                                     sc["dt"], -3.0, 3.0, 4)
    cl, ca, tl, gv = grid_ops.stopping_candidates(
        jnp.asarray([40.0, 8.0, 0.0], jnp.float32),
        jnp.asarray([0.3, 0.0, 0.0], jnp.float32), jnp.float32(36.0),
        jnp.float32(48.0), jnp.asarray(False), grid)
    sc.update(cl=cl, ca=ca, tl=tl, goal_valid=np.asarray(gv), desired_v=0.0,
              w_a=1.0, desired_s=45.0)
    want, got = _score_jax(sc), _score_port(sc)
    assert np.isfinite(want[0]).any()
    assert not np.asarray(gv).all()            # some goals behind
    assert_scorer_parity(want, got, _in_domain(sc))


def test_plain_scorer_fail_safe():
    """Fail-safe cost: w_a = 1, desired_d = 0, no velocity terms."""
    sc = _scene()
    sc.update(w_a=1.0, desired_d=0.0, has_desired_v=False)
    want, got = _score_jax(sc), _score_port(sc)
    assert np.isfinite(want[0]).any()
    assert_scorer_parity(want, got, _in_domain(sc))


@pytest.mark.parametrize("v0,low_vel", [(15.0, False), (2.5, True)])
def test_plain_scorer_meets_pallas_cycle_bar(v0, low_vel):
    """The bar of tests/test_pallas_cycle.py:107-117 word for word: finite
    patterns of both rows identical, costs to rtol 2e-4 / atol 1e-2, the
    same argmin, plus identical reason codes."""
    sc = _scene(v0=v0, low_vel=low_vel)
    want, got = _score_jax(sc), _score_port(sc)
    finite_want = np.isfinite(want[0])
    np.testing.assert_array_equal(np.isfinite(got[0]), finite_want)
    np.testing.assert_array_equal(np.isfinite(got[1]), np.isfinite(want[1]))
    assert finite_want.sum() > 0
    np.testing.assert_allclose(got[0][finite_want], want[0][finite_want],
                               rtol=RTOL, atol=ATOL)
    assert int(np.argmin(got[0])) == int(np.argmin(want[0]))
    in_dom = _in_domain(sc)
    np.testing.assert_array_equal(got[2][in_dom], want[2][in_dom])


def _atan_cephes_np(x):
    """pallas_cycle._atan in numpy float32, term for term (pl.reciprocal
    has no evaluation rule outside a kernel)."""
    f = np.float32
    sign = np.sign(x)
    ax = np.abs(x)
    hi = ax > f(2.414213562373095)
    mid = ax > f(0.4142135623730950)
    x_hi = -(f(1.0) / np.where(hi, ax, f(1.0)))
    x_mid = (ax - f(1.0)) / (ax + f(1.0))
    xr = np.where(hi, x_hi, np.where(mid, x_mid, ax))
    y0 = np.where(hi, f(np.pi / 2), np.where(mid, f(np.pi / 4), f(0.0)))
    z = xr * xr
    poly = (((f(8.05374449538e-2) * z - f(1.38776856032e-1)) * z
             + f(1.99777106478e-1)) * z - f(3.33329491539e-1)) * z * xr + xr
    return sign * (y0 + poly)


def test_atan_cephes_matches_tpu_kernel():
    """The Cephes arctangent is ported term for term (all three range
    branches, signs, zero) and stays within 3e-7 of arctan."""
    x = np.concatenate([np.linspace(-40.0, 40.0, 2001),
                        [0.0, 0.41421, 0.41422, 2.41421, 2.41422, 1e6]]
                       ).astype(np.float32)
    want = _atan_cephes_np(x)
    got = scoring.atan_cephes(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, np.arctan(x.astype(np.float64)),
                               rtol=0, atol=3e-7)


def test_wrapper_validates_inputs():
    """The wrapper raises on what the kernel does not take instead of
    converting silently."""
    sc = _scene()
    args, kwargs = _port_inputs(sc)
    bad = (args[0].double(),) + args[1:]
    with pytest.raises(TypeError):
        scoring.score_candidates(*bad, **kwargs)
    bad = (args[0][:, :5].contiguous(),) + args[1:]
    with pytest.raises(ValueError):
        scoring.score_candidates(*bad, **kwargs)
    with pytest.raises(ValueError):
        scoring.score_candidates(*args, n_steps=sc["n_steps"] + 3)
    before = scoring.score_candidates.launches
    scoring.score_candidates(*args, **kwargs)   # CPU: plain version
    assert scoring.score_candidates.launches == before


# ---------------------------------------------------------------------------
# hostile operands: the table search's edge cases and the early exits'
# ---------------------------------------------------------------------------

import functools

from commonroad_rp_tpu_torch.probes import hostile_inputs


@functools.lru_cache(maxsize=None)
def _hostile_rows(seed):
    """(case, JAX rows, plain-version rows, in-domain mask) of one hostile
    fleet: ``pallas_cycle.score_fleet_pallas(..., interpret=True)`` and the
    port's ``score_fleet`` on CPU tensors, same numpy arrays."""
    case = hostile_inputs.hostile_fleet(seed)
    j_args, j_kwargs = hostile_inputs.score_fleet_arguments(case, jnp.asarray)
    want = [np.asarray(x) for x in pallas_cycle.score_fleet_pallas(
        *j_args, **j_kwargs, interpret=True)]
    args, kwargs = hostile_inputs.score_fleet_arguments(case, torch.as_tensor)
    got = [x.numpy() for x in scoring.score_fleet(*args, **kwargs)]
    cl, T = case["coeffs_lon"], case["n_steps"] + 1
    t = (np.arange(T, dtype=np.float32)
         * np.float32(case["dt"]))[:, None, None]
    t2 = t * t
    with np.errstate(all="ignore"):
        s = (cl[..., 0] + cl[..., 1] * t + cl[..., 2] * t2
             + cl[..., 3] * (t2 * t) + cl[..., 4] * (t2 * t2)
             + cl[..., 5] * (t2 * t2 * t))
    active = np.arange(T)[:, None, None] < case["traj_len"][None]
    last = case["ref_s_last"][None, :, None]
    in_domain = np.all(((s >= 0) & (s <= last)) | ~active, axis=0)
    return case, want, got, in_domain


@pytest.mark.parametrize("group", hostile_inputs.GROUPS)
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_fleet_scorer_matches_tpu_kernel_on_hostile_operands(seed,
                                                                   group):
    """Each group of ``probes.hostile_inputs`` (three problems of different
    real table lengths under one padded length) at the module's bar."""
    case, want, got, in_domain = _hostile_rows(seed)
    members = case["group"] == hostile_inputs.GROUPS.index(group)
    for f in range(members.shape[0]):
        pick = lambda rows: [r[f][members[f]] for r in rows]
        assert_scorer_parity(pick(want), pick(got), in_domain[f][members[f]])
    feasible = np.isfinite(want[1][members])
    if group in ("nan", "then_prefilter", "then_leaves"):
        assert not feasible.any()
    else:
        assert feasible.any(), "degenerate: no feasible candidate"
    if group == "then_prefilter":
        # the prefilter's reason wins over the earlier violation's
        assert set(np.unique(got[2][members])) <= {0.0, 4.0}


def test_hostile_operands_cover_their_cases():
    """The generator makes what its groups promise: sentinel-padded tables
    of different real lengths, arclengths that decrease, fall below 0, pass
    the last real row and reach the padded rows, NaN coefficients, horizons
    of one step."""
    case = hostile_inputs.hostile_fleet(0)
    s_col = case["packed_tables"][..., 0]
    assert np.all(np.diff(s_col, axis=1) > 0)
    real = (s_col < 5e5).sum(axis=1)
    assert tuple(real) == hostile_inputs.REAL_ROWS
    np.testing.assert_array_equal(case["ref_s_last"], real - 1.0)
    group = lambda name: case["group"] == hostile_inputs.GROUPS.index(name)
    cl, last = case["coeffs_lon"], case["ref_s_last"][:, None]
    end = cl[..., 0] + cl[..., 1] * 2.0
    assert (cl[..., 1][group("still")] < 0).any()
    assert (cl[..., 1][group("still")] == 0).any()
    assert (cl[..., 0][group("below_zero")] < 0).any()
    assert (end > last)[group("past_end")].mean() > 0.5
    assert (end > last + 1e5)[group("past_end")].any()
    nan = np.isnan(cl).any(-1) | np.isnan(case["coeffs_lat"]).any(-1)
    np.testing.assert_array_equal(nan, group("nan"))
    assert set(np.unique(case["traj_len"][group("short")])) == {1.0, 2.0}


@pytest.mark.parametrize("problem", [0, 1, 2])
def test_plain_scorer_matches_tpu_kernel_on_hostile_problem(problem):
    """One problem of the hostile fleet through the single-problem entry
    points (``score_candidates_pallas`` / ``score_candidates``): the padded
    table with its own real length, the low-velocity problem included."""
    case = hostile_inputs.hostile_fleet(0)
    f = problem
    T = case["n_steps"] + 1

    def operands(xp, obstacle_arrays, vehicle_arrays):
        a = lambda name: xp(case[name][f])
        return (a("coeffs_lon"), a("coeffs_lat"), a("traj_len"),
                a("goal_valid"), a("packed_tables"),
                obstacle_arrays(pose=a("obs_pose"), half_ext=a("obs_half_ext"),
                                valid=xp(case["obs_valid"][f] > 0.5),
                                radius=a("obs_radius")),
                vehicle_arrays(*(xp(v) for v in case["veh_stack"][f])),
                a("x0_orientation"), case["dt"],
                xp(case["low_vel"][f] > 0.5), a("desired_speed"),
                a("desired_d"), a("w_a"), a("ref_s_last"))

    want = [np.asarray(x) for x in pallas_cycle.score_candidates_pallas(
        *operands(jnp.asarray, jax_collision.ObstacleArrays,
                  jax_kin.VehicleArrays), n_steps=case["n_steps"],
        interpret=True)]
    from commonroad_rp_tpu_torch.ops.collision import ObstacleArrays
    from commonroad_rp_tpu_torch.ops.kinematics import VehicleArrays
    got = [x.numpy() for x in scoring.score_candidates(
        *operands(torch.as_tensor, ObstacleArrays, VehicleArrays),
        n_steps=case["n_steps"])]
    assert want[0].shape == got[0].shape == (case["coeffs_lon"].shape[1],)
    _, _, fleet_rows, in_domain = _hostile_rows(0)
    assert_scorer_parity(want, got, in_domain[f])
    # the fleet form computes the same function problem by problem
    for row_f, row_1 in zip(fleet_rows, got):
        np.testing.assert_array_equal(row_f[f], row_1)


# ---------------------------------------------------------------------------
# the launch path: operand checks, shared-memory size by shape
# ---------------------------------------------------------------------------

# (P, M, T) -> bytes of dynamic shared memory per block: the main path's
# first cycle (ZAM_Over-1_1), the T=61 scan, the synthetic scene, the
# 1024-problem fleet, the hostile fleet, two long tables
_LAYOUTS = {
    "main": ((273, 1, 21), 1844),
    "plan_scan_t61": ((273, 1, 61), 3124),
    "synthetic_polygon": ((401, 2, 21), 3028),
    "fleet1024": ((513, 5, 21), 5492),
    "hostile": ((161, 3, 21), 2740),
    "large_table": ((2048, 5, 21), 11632),
    "large_table_polygon": ((4096, 2, 61), 20368),
}


@pytest.mark.parametrize("shape", sorted(_LAYOUTS))
def test_shared_layout_is_pinned(shape):
    sizes, want = _LAYOUTS[shape]
    assert scoring.shared_bytes(*sizes) == want
    # a pure function of the sizes
    assert scoring.shared_bytes(*sizes) == scoring.shared_bytes(*sizes)


def test_shared_bytes_count_what_a_block_stages():
    """20 scalar slots, 8 floats per obstacle (row, step) and one arclength
    per table row; the limit leaves the fleet kernel's static queue (1024
    candidates and a counter, in whole KB) inside the 227 KB a block may
    have."""
    for P, M, T in ((2, 0, 1), (273, 1, 21), (513, 5, 21), (4000, 16, 61)):
        assert scoring.shared_bytes(P, M, T) == 4 * (20 + 8 * M * T + P)
    assert 4 * 1024 + 4 <= 227 * 1024 - scoring.SHARED_BLOCK_LIMIT == 5 * 1024


def _cpu_operands(fleet):
    if fleet:
        case = hostile_inputs.hostile_fleet(0)
        args, kwargs = hostile_inputs.score_fleet_arguments(case,
                                                            torch.as_tensor)
        return scoring.prepare_fleet_inputs(*args, **kwargs)
    args, kwargs = _port_inputs(_scene())
    return scoring.prepare_inputs(*args, **kwargs)


def _on_meta(inp):
    """Prepared operands moved to the ``meta`` device: no storage and not the
    CPU, so the wrappers take their kernel path up to the operand checks."""
    return inp._replace(**{name: getattr(inp, name).to("meta")
                           for name in inp._fields[:8]})


@pytest.mark.parametrize("entry", ["score_prepared", "trivial_probe"])
@pytest.mark.parametrize("fault", ["dtype", "strides", "device_type",
                                   "mixed_devices"])
def test_launch_rejects_operands(entry, fault):
    """Operands the kernels do not take raise in the launch path, before any
    library is built or loaded and with nothing counted."""
    inp = _on_meta(_cpu_operands(fleet=False))
    if fault == "dtype":
        inp = inp._replace(coeffs_lat=inp.coeffs_lat.double())
        message = "kernel operand coeffs_lat must be contiguous float32"
    elif fault == "strides":
        inp = inp._replace(table=inp.table.T.contiguous().T)
        message = "kernel operand table must be contiguous float32"
    elif fault == "device_type":
        message = "unsupported device meta"
    else:
        inp = inp._replace(obs=torch.empty(inp.obs.shape))
        message = "kernel operand obs is on cpu, the candidates on meta"
    who = "score_candidates" if entry == "score_prepared" else entry
    before = (scoring.score_candidates.launches,
              scoring.trivial_probe.launches)
    with pytest.raises(ValueError, match=f"{who}: {message}"):
        if entry == "score_prepared":
            scoring.score_prepared(inp)
        else:
            scoring.trivial_probe(inp, torch.empty((), device="meta"))
    assert (scoring.score_candidates.launches,
            scoring.trivial_probe.launches) == before


def _lattice_on_meta(F=2, M=1, P=40):
    """``FleetLatticeInputs`` of F problems on the ``meta`` device, level 1."""
    from commonroad_rp_tpu_torch.ops import grid

    g = grid.make_static_grid(1, 0.4, 2.0, 0.1, -3.0, 3.0, 4)
    meta = lambda *shape: torch.empty(shape, device="meta")
    return scoring.FleetLatticeInputs(
        x0_lon=meta(F, 3), x0_lat=meta(F, 3), bounds=meta(F, 2), grid=g,
        stopping=False, tables=meta(F, P, 12), obs=meta(F, M, 21, 7),
        poly=meta(F, 0, 21, 3), scalars=meta(F, 17), n_steps=20,
        n_poly_verts=1, flags=scoring._flags((True,) * 5, False, True))


@pytest.mark.parametrize("fault", ["shape", "dtype", "device_type", "index"])
def test_lattice_launch_rejects_operands(fault):
    """Lattice operands the kernels do not take raise in the launch path
    (``score_prepared``, ``lattice_candidates``), before any library is
    built or loaded and with nothing counted."""
    inp = _lattice_on_meta()
    call = lambda: scoring.score_prepared(inp)
    if fault == "shape":
        inp = inp._replace(bounds=torch.empty((2, 1), device="meta"))
        message = r"score_fleet: bounds has shape \(2, 1\), expected \(2, 2\)"
    elif fault == "dtype":
        inp = inp._replace(x0_lon=inp.x0_lon.double())
        message = "score_fleet: kernel operand x0_lon must be contiguous float32"
    elif fault == "device_type":
        message = "score_fleet: unsupported device meta"
    else:
        call = lambda: scoring.lattice_candidates(inp, torch.empty(
            (2, 1), dtype=torch.int32, device="meta"))
        message = r"lattice_candidates: index must be \[F=2, J\] int64"
    before = (scoring.score_fleet.launches,
              scoring.lattice_candidates.launches)
    with pytest.raises(ValueError, match=message):
        call()
    assert (scoring.score_fleet.launches,
            scoring.lattice_candidates.launches) == before


@pytest.mark.parametrize("stopping", [False, True])
def test_lattice_flags_hold_the_level_sizes(stopping):
    """The lattice form's level sizes ride in the kernels' flags above the
    check bits (bit 7 stopping, bits 8-15 n_t, 16-23 n_lon, 24-30 n_d), and
    a lattice too large for them raises."""
    from commonroad_rp_tpu_torch.ops import grid

    g = grid.make_static_grid(3, 0.4, 2.0, 0.1, -3.0, 3.0, 4)
    flags = scoring.lattice_flags(g, stopping)
    checks = scoring._flags((True,) * 5, True, True)
    assert checks < 128 and flags & checks == 0
    assert (flags >> 7 & 1, flags >> 8 & 255, flags >> 16 & 255,
            flags >> 24) == (int(stopping), len(g.t_values), g.n_lon,
                             len(g.d_values))
    with pytest.raises(ValueError, match="larger than the kernels' flags"):
        scoring.lattice_flags(g._replace(d_values=(0.0,) * 128), stopping)


@pytest.mark.parametrize("fleet", [False, True])
def test_launch_rejects_a_table_past_the_shared_memory_limit(fleet):
    """One table row more than a block's shared memory holds raises by shape
    alone; the wrapper names the bytes it would need."""
    inp = _on_meta(_cpu_operands(fleet))
    M, T = inp.obs.shape[-3:-1]
    n_rows = (scoring.SHARED_BLOCK_LIMIT - scoring.shared_bytes(0, M, T)) // 4
    assert scoring.shared_bytes(n_rows, M, T) <= scoring.SHARED_BLOCK_LIMIT \
        < scoring.shared_bytes(n_rows + 1, M, T)
    lead = inp.coeffs_lon.shape[:-2]
    table = lambda n: torch.empty(*lead, n, 12, device="meta")
    name = "tables" if fleet else "table"
    with pytest.raises(ValueError, match=f"a table of {n_rows + 1} rows .* "
                       f"needs {scoring.shared_bytes(n_rows + 1, M, T)} "
                       "bytes of shared memory per block"):
        scoring.score_prepared(inp._replace(**{name: table(n_rows + 1)}))
    # at the limit the shape passes and the next check speaks
    with pytest.raises(ValueError, match="unsupported device meta"):
        scoring.score_prepared(inp._replace(**{name: table(n_rows)}))


@pytest.mark.parametrize("fleet", [False, True])
def test_cpu_operands_run_the_plain_version(fleet):
    """``score_prepared`` and ``trivial_probe`` on CPU operands are the plain
    versions and count no launch."""
    inp = _cpu_operands(fleet)
    wrapper = scoring.score_fleet if fleet else scoring.score_candidates
    before = wrapper.launches
    got = scoring.score_prepared(inp)
    want = scoring.score_prepared_reference(inp)
    for g, w in zip(got, want):
        assert g.shape == inp.coeffs_lon.shape[:-1]
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert wrapper.launches == before
    if not fleet:
        v = torch.tensor(20.0)
        probes = scoring.trivial_probe.launches
        np.testing.assert_array_equal(
            scoring.trivial_probe(inp, v).numpy(),
            scoring.trivial_probe_reference(inp, v).numpy())
        assert scoring.trivial_probe.launches == probes


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hinted_search_equals_searchsorted(tmp_path, seed):
    """``count_le_hint`` of ``csrc/scoring.cu`` (the two search functions are
    plain C++ once ``__device__`` is defined away) compiled with g++:
    count(s_row <= q) for every hint in [-1, P] on tables with sentinel
    rows, at queries on, next to, below, above and among the rows and at
    +-inf, equals ``numpy.searchsorted(..., side="right")``."""
    import ctypes
    import shutil
    import subprocess

    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the search functions")
    text = scoring.KERNEL_SOURCE.read_text()
    body = text[text.index("// count(s_row <= q) over the arclength column, "
                           "by bisection"):
                text.index("// Scores candidate k of one problem")]
    source = tmp_path / "search.cpp"
    source.write_text(
        "#define __device__\n#define __forceinline__ inline\n" + body +
        'extern "C" void count_many(const float* col, int P, const float* q,'
        " const int* hint, int n, int* out) {\n  for (int i = 0; i < n; ++i)"
        " out[i] = count_le_hint(col, P, q[i], hint[i]);\n}\n")
    lib_path = tmp_path / "libsearch.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-o",
                    str(lib_path), str(source)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    rng = np.random.default_rng(seed)
    f32 = np.float32
    for P in (2, 3, 17, 274, 513):
        real = int(rng.integers(1, P + 1))
        steps = np.where(np.arange(P) < real,
                         rng.uniform(0.01, 2.0, P), 1e6).astype(f32)
        col = (f32(rng.uniform(-50, 50)) + np.cumsum(steps)).astype(f32)
        assert np.all(np.diff(col) > 0)
        q = np.concatenate([
            col, np.nextafter(col, f32(np.inf)), np.nextafter(col, f32(-np.inf)),
            rng.uniform(col[0] - 5, col[real - 1] + 5, 400).astype(f32),
            rng.uniform(col[0], col[-1], 50).astype(f32),
            [f32(np.inf), f32(-np.inf), col[0] - 1e6, col[-1] + 1e6]]
        ).astype(f32)
        want = np.searchsorted(col, q, side="right").astype(np.int32)
        for hint in list(range(-1, P + 1))[::max(1, P // 40)] + [P]:
            hints = np.full(len(q), hint, np.int32)
            got = np.empty(len(q), np.int32)
            lib.count_many(
                col.ctypes.data_as(ctypes.c_void_p), P,
                q.ctypes.data_as(ctypes.c_void_p),
                hints.ctypes.data_as(ctypes.c_void_p), len(q),
                got.ctypes.data_as(ctypes.c_void_p))
            np.testing.assert_array_equal(got, want, err_msg=f"P={P} "
                                          f"hint={hint}")
