"""The port's device grid generators against ``commonroad_rp_tpu.ops.grid``.

The same carried states go through both packages' candidate generators:
velocity keeping and stopping at sampling levels 1-3 with the low-velocity
mode off and on, the corridor lattice, and the fleet form (a leading problem
axis against ``jax.vmap``).  Coefficients agree to rtol 1e-6 (float32
arithmetic in the same order); lengths and masks are equal.

The fleet kernel's own lattice (``lattice_candidate`` of
``csrc/scoring.cu``, compiled with g++) is held to the port's generators bit
for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from commonroad_rp_tpu.models.sampling import \
    CorridorSampling as JaxCorridorSampling
from commonroad_rp_tpu.models.sampling import \
    DrivingCorridor as JaxDrivingCorridor
from commonroad_rp_tpu.ops import grid as jax_grid
from commonroad_rp_tpu.utils.config import \
    ReactivePlannerConfiguration as JaxConfig

from commonroad_rp_tpu_torch.models.sampling import (CorridorSampling,
                                                     DrivingCorridor)
from commonroad_rp_tpu_torch.ops import grid, scoring
from commonroad_rp_tpu_torch.utils.config import ReactivePlannerConfiguration

RTOL = 1e-6
X0_LON = np.array([40.0, 15.0, 0.2], np.float32)
X0_LAT = np.array([0.4, 0.05, 0.0], np.float32)


def _grids(level):
    args = (level, 0.4, 2.0, 0.1, -3.0, 3.0, 4)
    return jax_grid.make_static_grid(*args), grid.make_static_grid(*args)


def _f32(x):
    return torch.as_tensor(np.asarray(x, np.float32))


def _assert_batch(want, got):
    for w, g in zip(want, got):
        w, g = np.asarray(w), g.numpy()
        assert w.shape == g.shape
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=1e-6)
        else:
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("level", [1, 2, 3])
def test_static_grid_matches(level):
    want, got = _grids(level)
    assert tuple(want) == tuple(got)
    assert want.size == got.size


@pytest.mark.parametrize("low_vel", [False, True])
@pytest.mark.parametrize("level", [1, 2, 3])
def test_velocity_keeping_candidates_match(level, low_vel):
    g_jax, g = _grids(level)
    v0 = 2.5 if low_vel else 15.0
    x0_lon = X0_LON * np.array([1.0, v0 / 15.0, 1.0], np.float32)
    v_min, v_max = np.float32(max(0.0, v0 - 4.0)), np.float32(v0 + 4.0)
    want = jax_grid.velocity_keeping_candidates(
        jnp.asarray(x0_lon), jnp.asarray(X0_LAT), jnp.asarray(v_min),
        jnp.asarray(v_max), jnp.asarray(low_vel), g_jax)
    got = grid.velocity_keeping_candidates(
        _f32(x0_lon), _f32(X0_LAT), _f32(v_min), _f32(v_max),
        torch.tensor(low_vel), g)
    assert got[0].shape == (g.size, 6)
    _assert_batch(want, got)


@pytest.mark.parametrize("low_vel", [False, True])
@pytest.mark.parametrize("level", [1, 2, 3])
def test_stopping_candidates_match(level, low_vel):
    g_jax, g = _grids(level)
    x0_lon = np.array([40.0, 3.0 if low_vel else 8.0, 0.0], np.float32)
    s_min, s_max = np.float32(36.0), np.float32(48.0)
    want = jax_grid.stopping_candidates(
        jnp.asarray(x0_lon), jnp.asarray(X0_LAT), jnp.asarray(s_min),
        jnp.asarray(s_max), jnp.asarray(low_vel), g_jax)
    got = grid.stopping_candidates(
        _f32(x0_lon), _f32(X0_LAT), _f32(s_min), _f32(s_max),
        torch.tensor(low_vel), g)
    assert not np.asarray(want[3]).all()          # some goals behind
    _assert_batch(want, got)


def test_fleet_candidates_match_vmap():
    """A leading problem axis equals jax.vmap over problems (mixed modes)."""
    g_jax, g = _grids(2)
    rng = np.random.default_rng(0)
    F = 3
    x0_lon = np.stack([X0_LON] * F)
    x0_lon[:, 1] = [15.0, 2.5, 9.0]
    x0_lat = (np.stack([X0_LAT] * F)
              + rng.uniform(-0.3, 0.3, (F, 3))).astype(np.float32)
    v_min = np.maximum(0.0, x0_lon[:, 1] - 4.0).astype(np.float32)
    v_max = (x0_lon[:, 1] + 4.0).astype(np.float32)
    low_vel = x0_lon[:, 1] < 4.0
    want = jax.vmap(jax_grid.velocity_keeping_candidates,
                    in_axes=(0, 0, 0, 0, 0, None))(
        jnp.asarray(x0_lon), jnp.asarray(x0_lat), jnp.asarray(v_min),
        jnp.asarray(v_max), jnp.asarray(low_vel), g_jax)
    got = grid.velocity_keeping_candidates(
        _f32(x0_lon), _f32(x0_lat), _f32(v_min), _f32(v_max),
        torch.as_tensor(low_vel), g)
    _assert_batch(want, got)
    s_win = np.stack([x0_lon[:, 0] + 4.0, x0_lon[:, 0] + 12.0],
                     axis=1).astype(np.float32)
    want = jax.vmap(jax_grid.stopping_candidates,
                    in_axes=(0, 0, 0, 0, 0, None))(
        jnp.asarray(x0_lon), jnp.asarray(x0_lat), jnp.asarray(s_win[:, 0]),
        jnp.asarray(s_win[:, 1]), jnp.asarray(low_vel), g_jax)
    got = grid.stopping_candidates(
        _f32(x0_lon), _f32(x0_lat), _f32(s_win[:, 0]), _f32(s_win[:, 1]),
        torch.as_tensor(low_vel), g)
    _assert_batch(want, got)


def _corridor_space(config_cls, space_cls, corridor_cls, repo_root):
    config = config_cls.load(
        repo_root / "configurations" / "ZAM_Over-1_1.yaml",
        "ZAM_Over-1_1.xml")
    config.general.path_scenarios = str(repo_root / "example_scenarios") + "/"
    config.general.set_path_scenario("ZAM_Over-1_1.xml")
    config.update()
    space = space_cls(config)
    n_steps = config.planning.time_steps_computation
    # a drivable band that narrows and shifts along the horizon, with two
    # lateral intervals per step beyond the first quarter
    steps = []
    for i in range(n_steps + 1):
        v_iv = (8.0 + 0.1 * i, 16.0 + 0.05 * i)
        ivs = [(30.0 + 0.5 * i, 90.0, -2.5 + 0.02 * i, 1.5)]
        if i > n_steps // 4:
            ivs.append((90.0, 140.0, 0.5, 3.0 - 0.01 * i))
        steps.append((v_iv, ivs))
    space.driving_corridor = corridor_cls(
        first_step=0,
        velocity_intervals={i: st[0] for i, st in enumerate(steps)},
        lateral_interval_map={i: st[1] for i, st in enumerate(steps)})
    return space, config.planning.dt


@pytest.mark.parametrize("level", [1, 2])
def test_corridor_candidates_match(repo_root, level):
    space_jax, dt = _corridor_space(JaxConfig, JaxCorridorSampling,
                                    JaxDrivingCorridor, repo_root)
    space, _ = _corridor_space(ReactivePlannerConfiguration,
                               CorridorSampling, DrivingCorridor, repo_root)
    cg_jax = jax_grid.make_corridor_grid(space_jax, level, dt)
    cg = grid.make_corridor_grid(space, level, dt)
    assert cg.size == cg_jax.size
    x0_lon = np.array([40.0, 12.0, 0.1], np.float32)
    want = jax_grid.corridor_candidates(jnp.asarray(x0_lon),
                                        jnp.asarray(X0_LAT), cg_jax)
    got = grid.corridor_candidates(_f32(x0_lon), _f32(X0_LAT), cg)
    assert np.asarray(want[3]).any() and not np.asarray(want[3]).all()
    _assert_batch(want, got)


def test_linspace_matches_jnp():
    lo = np.array([0.0, 3.7, 11.25], np.float32)
    hi = np.array([5.0, 9.1, 11.25], np.float32)
    for n in (2, 3, 5, 9, 17):
        want = np.asarray(jax.vmap(
            lambda a, b: jnp.linspace(a, b, n, dtype=jnp.float32))(
                jnp.asarray(lo), jnp.asarray(hi)))
        got = grid.linspace(_f32(lo), _f32(hi), n).numpy()
        # XLA may fuse the two products; the endpoints are exact
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
        np.testing.assert_array_equal(got[:, [0, -1]], want[:, [0, -1]])


def _kernel_lattice(tmp_path):
    """The lattice functions of ``csrc/scoring.cu`` (the part between its
    markers is plain C++ once ``__device__`` is defined away and ``__ldg``
    is a load) compiled with g++ without contracting multiply-adds, as nvcc
    builds the kernel, behind a loop over problems and candidates: per
    candidate ``lattice_operands`` on the level table (coefficient rows,
    valid steps, goal flag) and ``lattice_steps``, ``lattice_goal`` alone,
    as the fleet kernel reads them."""
    import ctypes
    import shutil
    import subprocess

    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the lattice function")
    text = scoring.KERNEL_SOURCE.read_text()
    body = text[text.index("// ---- the lattice candidate"):
                text.index("// ---- end of the lattice candidate")]
    source = tmp_path / "lattice.cpp"
    source.write_text(
        "#define __device__\n#define __forceinline__ inline\n"
        "template <class T> inline T __ldg(const T* p) { return *p; }\n"
        + body +
        'extern "C" void lattice_many(const float* x0_lon, const float* '
        "x0_lat, const float* bounds, const float* level, int flags, "
        "const int* low_vel, int F, int K, float* out) {\n"
        "  for (int f = 0; f < F; ++f)\n    for (int k = 0; k < K; ++k) {\n"
        "      float* o = out + ((long)f * K + k) * 16;\n      bool ok;\n"
        "      lattice_operands(k, x0_lon + 3 * f, x0_lat + 3 * f, "
        "bounds + 2 * f, level, flags, low_vel[f], o, o + 6, o[12], ok);\n"
        "      o[13] = ok;\n      o[14] = lattice_steps(k, level, flags);\n"
        "      o[15] = lattice_goal(k, x0_lon + 3 * f, bounds + 2 * f, "
        "flags);\n    }\n}\n")
    lib_path = tmp_path / "liblattice.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared",
                    "-fPIC", "-o", str(lib_path), str(source)], check=True)
    return ctypes.CDLL(str(lib_path))


@pytest.mark.parametrize("level", [1, 3])
@pytest.mark.parametrize("stopping", [False, True],
                         ids=["velocity_keeping", "stopping"])
def test_kernel_lattice_is_the_grid(tmp_path, stopping, level):
    """Candidate k of the fleet kernel's lattice is point (it, iv, id) of
    ``grid._lattice``'s flattening, k = (it * n_lon + iv) * (Nd + 1) + id,
    and its coefficient rows, valid steps and goal flag are
    ``velocity_keeping_candidates``' / ``stopping_candidates``' bit for
    bit, on a fleet with members in and out of the low-velocity mode (one
    whose current lateral offset is a base d sample)."""
    import ctypes

    g = grid.make_static_grid(level, 0.4, 2.0, 0.1, -3.0, 3.0, 4)
    n_t, n_d = len(g.t_values), len(g.d_values)
    K = g.size
    rng = np.random.default_rng(level)
    F = 5
    x0_lon = np.stack([np.array([40.0, 15.0, 0.2], np.float32)] * F)
    x0_lon[:, 0] += rng.uniform(-20, 20, F).astype(np.float32)
    x0_lon[:, 1] = [15.0, 2.5, 9.0, 0.3, 0.0]
    x0_lon[:, 2] = rng.uniform(-1.0, 1.0, F).astype(np.float32)
    x0_lat = rng.uniform(-0.6, 0.6, (F, 3)).astype(np.float32)
    x0_lat[2, 0] = g.d_values[1]
    low_vel = x0_lon[:, 1] < 4.0
    assert low_vel.any() and not low_vel.all()
    if stopping:
        bounds = np.stack([x0_lon[:, 0] - 4.0, x0_lon[:, 0] + 12.0], 1)
    else:
        v_min = np.maximum(0.0, x0_lon[:, 1] - 4.0)
        bounds = np.stack([v_min, np.maximum(v_min + 5.0,
                                             x0_lon[:, 1] + 2.0)], 1)
    bounds = bounds.astype(np.float32)

    # the decode against _lattice's own grids
    lon = grid.linspace(_f32(bounds[:, 0]), _f32(bounds[:, 1]), g.n_lon)
    T, L, D = (a.reshape(F, K).numpy()
               for a in grid._lattice(_f32(x0_lon), _f32(x0_lat), lon, g))
    it, iv, i_d = np.unravel_index(np.arange(K), (n_t, g.n_lon, n_d + 1))
    np.testing.assert_array_equal(
        it * g.n_lon * (n_d + 1) + iv * (n_d + 1) + i_d, np.arange(K))
    d_all = np.concatenate([np.broadcast_to(np.float32(g.d_values), (F, n_d)),
                            x0_lat[:, :1]], 1)
    np.testing.assert_array_equal(T, np.broadcast_to(
        np.float32(g.t_values)[it], (F, K)))
    np.testing.assert_array_equal(L, lon.numpy()[:, iv])
    np.testing.assert_array_equal(D, d_all[:, i_d])

    lib = _kernel_lattice(tmp_path)
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    table = scoring.lattice_table(g, "cpu").numpy()
    low_vel_flags = low_vel.astype(np.int32)
    out = np.empty((F, K, 16), np.float32)
    lib.lattice_many(ptr(x0_lon), ptr(x0_lat), ptr(bounds), ptr(table),
                     scoring.lattice_flags(g, stopping), ptr(low_vel_flags), F,
                     K, ptr(out))
    args = (_f32(x0_lon), _f32(x0_lat), _f32(bounds[:, 0]),
            _f32(bounds[:, 1]), torch.as_tensor(low_vel), g)
    if stopping:
        cl, ca, tl, goal = grid.stopping_candidates(*args)
        assert not goal.all() and goal.any()
    else:
        cl, ca, tl = grid.velocity_keeping_candidates(*args)
        goal = torch.ones(tl.shape, dtype=torch.bool)
    bits = lambda a: np.ascontiguousarray(a).view(np.int32)
    np.testing.assert_array_equal(bits(out[..., :6]), bits(cl.numpy()))
    np.testing.assert_array_equal(bits(out[..., 6:12]), bits(ca.numpy()))
    for steps, flag in ((12, 13), (14, 15)):
        np.testing.assert_array_equal(out[..., steps], tl.numpy())
        np.testing.assert_array_equal(out[..., flag] > 0.5, goal.numpy())
