"""The compiled level programs (``ops.level_program.LevelProgram``) on the
CPU, where the step runs eagerly: the form a CUDA graph captures.

* Bit for bit the eager bodies: ZAM_Over-1_1's fused first cycle (three
  levels), one ``plan(level)`` level, the ``segments`` and continuous
  refinement of the fused cycle, and the conformance level program in
  float64 (corridor, ``segments``, continuous) and float32 with the
  capture bundle.
* At the parity bar of ROADMAP.md against the JAX package (Pallas in
  interpret mode, as tests/test_torch_cycle.py runs it), on the scenario's
  first cycle with the heading and the desired speed moved by a numpy seed:
  the fused cycle, ``plan(level)``, the refinement modes and the
  conformance level in float64 and float32.
* A second call at another heading, desired speed, obstacle window and
  coefficients equals a fresh build; the first call's results stay as
  they were.
* Signatures: ``low_vel_mode`` on and off build two programs, each once;
  the planner's LRU evicts the oldest.
* The forbidden-op recorder of tests/test_torch_scan_graph.py finds nothing
  in any step: no device read, data-dependent shape, host data turned into
  a tensor or copy between devices.
* With ``REFINE_WIDTH`` at 1, a cycle that needs two re-selections
  overflows, is continued eagerly, and equals the lazy loop (the port's and
  the JAX package's ``while_loop``).
* A ``plan()`` drive without refinement reads the device once per call.
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
from commonroad_rp_tpu_torch.models import planner as planner_module
from commonroad_rp_tpu_torch.ops import cycle as port_cycle
from commonroad_rp_tpu_torch.ops import level_program as lp
from commonroad_rp_tpu_torch.run_planner import (drive_to_goal, load_config,
                                                 make_planner)
from test_torch_scan_graph import CaptureForbidden

logging.getLogger("RP_LOGGER").setLevel(logging.CRITICAL)

SCENARIO = "ZAM_Over-1_1"
F32, F64 = torch.float32, torch.float64


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def _planner(repo_root, name=SCENARIO, dtype=None, **planning):
    """A CPU planner at its first cycle and that cycle's level batches."""
    config = load_config(name, repo_root)
    if dtype is not None:
        config.debug.fast_scoring = False
        config.debug.kernel_dtype = dtype
    for key, value in planning.items():
        setattr(config.planning, key, value)
    planner = make_planner(config, device="cpu")
    planner.set_desired_velocity(current_speed=planner.x_0.velocity)
    x0_lon, x0_lat = planner.begin_cycle()
    batches = [planner._create_trajectory_bundle(x0_lon, x0_lat, level)
               for level in range(1, planner.sampling_level)]
    return planner, batches


def _with_corner_disc(obstacles, winner, veh, radius=1.0):
    """``obstacles`` with a static disc diagonally off the front-left
    corner of ``winner``'s last ego box ([14, T] packed states): the exact
    disc test misses that box, the continuous pass (which covers the disc
    by its bounding square) rejects it (tests/test_torch_cycle.py)."""
    x, y, theta = (float(winner[i, -1]) for i in (7, 8, 9))
    major = np.array([np.cos(theta), np.sin(theta)])
    minor = np.array([-np.sin(theta), np.cos(theta)])
    corner = np.array([x, y]) + veh.wb_rear_axle * major \
        + veh.half_length * major + veh.half_width * minor
    center = corner + 0.85 * radius * (major + minor)
    M, T = obstacles.pose.shape[:2]
    pose = obstacles.pose
    disc = pose.new_tensor([center[0], center[1], theta]).expand(1, T, 3)
    radii = pose.new_zeros(M) if obstacles.radius is None \
        else obstacles.radius
    return obstacles._replace(
        pose=torch.cat([pose, disc]),
        half_ext=torch.cat([obstacles.half_ext,
                            obstacles.half_ext.new_zeros((1, 2))]),
        valid=torch.cat([obstacles.valid,
                         torch.ones((1, T), dtype=torch.bool)]),
        radius=torch.cat([radii, pose.new_tensor([radius])]))


def _fast_case(repo_root, mode):
    """(LevelArgs, static) of the fused program: ZAM_Over's first cycle,
    every level ("fused"), level 2 alone ("level"), with the road boundary
    as exact segments ("segments") or the continuous pass and a disc only
    it sees ("continuous")."""
    planning = {"segments": dict(boundary_mode="segments"),
                "continuous": dict(continuous_collision_check=True)}
    planner, batches = _planner(repo_root, **planning.get(mode, {}))
    args, static = planner.fast_arguments(
        batches[:1] if mode == "level" else batches)
    if mode == "continuous":
        winner = _eager(lp.FAST, args, static).optimal.numpy()
        args = args._replace(obstacles=_with_corner_disc(
            args.obstacles, winner, args.veh))
    return args, static


def _level_case(repo_root, mode, dtype="float64", bundle=False):
    """(LevelArgs, static) of the conformance program: ZAM_Over's level-2
    bundle in ``dtype`` with the corridor, the exact segments or the
    continuous pass."""
    planning = {"segments": dict(boundary_mode="segments"),
                "continuous": dict(continuous_collision_check=True)}
    planner, batches = _planner(repo_root, dtype=dtype,
                                **planning.get(mode, {}))
    batch = batches[1]
    return planner.level_arguments(batch, planner._goal_valid_mask(batch),
                                   bundle)


def _eager(kind, args, static):
    """The eager body on the arguments the program stages."""
    kwargs = lp.eager_arguments(kind, args, "cpu")
    if kind == lp.FAST:
        return port_cycle.evaluate_levels_fast(**kwargs, **static)
    static = dict(static)
    static.pop("bundle")
    return port_cycle.evaluate_level(**kwargs, **static)


def _same(got, want, label):
    """Bit for bit, NaN in the same places."""
    got, want = torch.as_tensor(got), torch.as_tensor(want)
    assert got.dtype == want.dtype and got.shape == want.shape, label
    if got.dtype.is_floating_point:
        assert torch.equal(torch.isnan(got), torch.isnan(want)), label
        got, want = got.nan_to_num(), want.nan_to_num()
    assert torch.equal(got, want), label


def _host_reason_counts(reasons, rejected):
    return np.array([int(np.sum(rejected & (reasons == c)))
                     for c in range(lp.N_REASONS)])


# ---------------------------------------------------------------------------
# the program's buffered form against the eager bodies, bit for bit
# ---------------------------------------------------------------------------

FAST_MODES = ["fused", "level", "segments", "continuous"]


@pytest.mark.parametrize("mode", FAST_MODES)
def test_fast_program_equals_eager(repo_root, mode):
    args, static = _fast_case(repo_root, mode)
    program = lp.LevelProgram(lp.FAST, args, static)
    assert not program.graph
    out = program(args)
    want = _eager(lp.FAST, args, static)
    got = program.outputs[0]
    for field in want._fields:
        _same(getattr(got, field), getattr(want, field), field)
    _same(out.scalars, want.scalars.numpy(), "host scalars")
    _same(out.optimal, want.optimal.numpy(), "host winner")
    assert not out.overflow
    level = int(out.scalars[5])
    rejected = args.goal_valid & (args.level_ids == level) \
        & ~np.isfinite(want.kin_costs.numpy())
    np.testing.assert_array_equal(
        out.reason_counts,
        _host_reason_counts(want.reasons.numpy(), rejected))
    if mode in ("segments", "continuous"):
        # the refinement re-selected: the unrefined cycle's winner is gone
        static_off = dict(static, continuous=False)
        unrefined = _eager(lp.FAST, args._replace(boundary=None), static_off)
        masked = torch.isfinite(unrefined.costs) & ~torch.isfinite(got.costs)
        assert masked.sum() >= 1, "degenerate: no re-selection"
        assert unrefined.scalars[0] != got.scalars[0]
    assert program.calls == program.readbacks == 1


LEVEL_CASES = [("corridor", "float64", True), ("segments", "float64", False),
               ("continuous", "float64", False), ("corridor", "float32",
                                                  True)]


@pytest.mark.parametrize("mode,dtype,bundle", LEVEL_CASES)
def test_level_program_equals_eager(repo_root, mode, dtype, bundle):
    args, static = _level_case(repo_root, mode, dtype, bundle)
    program = lp.LevelProgram(lp.LEVEL, args, static)
    out = program(args)
    want = _eager(lp.LEVEL, args, static)
    got = program.outputs[0]
    for field in ("found", "scalars", "masks", "costs", "optimal"):
        _same(getattr(got, field), getattr(want, field), field)
    for field in want.rollout._fields:
        _same(getattr(got.rollout, field), getattr(want.rollout, field),
              field)
    _same(out.scalars, want.scalars.numpy(), "host scalars")
    _same(out.optimal, want.optimal.numpy(), "host winner")
    masks = want.masks.numpy()
    np.testing.assert_array_equal(
        out.reason_counts,
        _host_reason_counts(masks[2], args.goal_valid & (masks[0] == 0)))
    assert 0 < masks[1].sum() < masks.shape[1], "degenerate: no collision"
    if bundle:
        x, y, costs, feasible, collides = out.bundle
        _same(x, want.rollout.x.numpy(), "bundle x")
        _same(y, want.rollout.y.numpy(), "bundle y")
        _same(costs, want.costs.numpy(), "bundle costs")
        np.testing.assert_array_equal(feasible, masks[0].astype(bool))
        np.testing.assert_array_equal(collides, masks[1].astype(bool))
    else:
        assert out.bundle is None


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_first_cycle(repo_root, dtype="float32", name=SCENARIO):
    """The JAX planner's first cycle of ``name``: every level's batch and
    the scene context (float32 fused, or float64 conformance)."""
    config = JaxConfig.load(repo_root / "configurations" / f"{name}.yaml",
                            f"{name}.xml")
    config.general.path_scenarios = str(repo_root / "example_scenarios") + "/"
    config.general.set_path_scenario(f"{name}.xml")
    config.update()
    config.debug.fast_scoring = dtype == "float32"
    config.debug.kernel_dtype = dtype
    route = JaxRoutePlanner(config.scenario, config.planning_problem) \
        .plan_routes().retrieve_first_route()
    planner = JaxPlanner(config)
    planner.set_reference_path(route.reference_path)
    planner.set_desired_velocity(current_speed=planner.x_0.velocity)
    planner.x_0_cl = planner._compute_initial_states(planner.x_0)
    planner._low_vel_mode = False
    batches = [planner._create_trajectory_bundle(*planner.x_0_cl, level)
               for level in range(1, planner.sampling_level)]
    ctx = planner._scene_context()
    return dict(batches=batches,
                goal_valid=[planner._goal_valid_mask(b) for b in batches],
                ref=planner._co.tables, veh=ctx["veh"],
                obstacles=ctx["obstacles"], boundary=ctx["boundary"],
                corridor=planner._cc.corridor_for(planner._co),
                unbounded=planner._corridor_or_unbounded(None),
                x0_orientation=float(planner.x_0.orientation),
                cost_params=ctx["cost_params"], dt=planner.dt,
                n_steps=planner.N, flags=ctx["flags"],
                cost_structure=planner.cost_function.structure)


def _seeded(c, seed):
    """The heading and the desired speed moved by a numpy seed."""
    rng = np.random.default_rng(seed)
    speed = float(np.asarray(c["cost_params"].desired_speed)) \
        + rng.uniform(-1.5, 1.5)
    return dict(c, x0_orientation=c["x0_orientation"] + rng.normal(0, 0.02),
                cost_params=c["cost_params"]._replace(
                    desired_speed=np.float32(speed)
                    if c["ref"].s.dtype == jnp.float32 else speed))


def _jax_fast(c, levels, boundary=None, continuous=False, obstacles=None):
    f32 = jnp.float32
    b = [c["batches"][i] for i in levels]
    cat = lambda f: np.concatenate([getattr(x, f) for x in b])
    level_ids = np.concatenate([np.full(x.size, j, np.int32)
                                for j, x in enumerate(b)])
    out = jax_cycle.evaluate_levels_fast(
        jnp.asarray(cat("coeffs_lon"), f32), jnp.asarray(cat("coeffs_lat"),
                                                         f32),
        jnp.asarray(cat("traj_len")),
        jnp.asarray(np.concatenate([c["goal_valid"][i] for i in levels])),
        jnp.asarray(level_ids), c["ref"], c["veh"],
        obstacles or c["obstacles"],
        c["unbounded"] if boundary is not None else c["corridor"],
        jnp.asarray(c["x0_orientation"], f32), c["cost_params"], boundary,
        dt=c["dt"], n_steps=c["n_steps"], low_vel_mode=False,
        cost_structure=c["cost_structure"], constraint_flags=c["flags"],
        n_levels=len(levels), continuous=continuous, interpret=True)
    return {k: np.asarray(v) for k, v in out._asdict().items()}


def _port_fast_args(c, levels, segments=False, continuous=False):
    b = [c["batches"][i] for i in levels]
    cat = lambda f: np.concatenate([getattr(x, f) for x in b])
    args = lp.LevelArgs(
        coeffs_lon=cat("coeffs_lon"), coeffs_lat=cat("coeffs_lat"),
        traj_len=cat("traj_len"),
        goal_valid=np.concatenate([c["goal_valid"][i] for i in levels]),
        level_ids=np.concatenate([np.full(x.size, j, np.int32)
                                  for j, x in enumerate(b)]),
        x0_orientation=float(np.float32(c["x0_orientation"])),
        cost_params=interop.cost_params(c["cost_params"]),
        veh=interop.vehicle(c["veh"]),
        ref=interop.ref_tables(c["ref"], dtype=F32),
        corridor=interop.corridor(c["unbounded"] if segments
                                  else c["corridor"], dtype=F32),
        obstacles=interop.obstacles(c["obstacles"], dtype=F32),
        boundary=interop.boundary(c["boundary"], dtype=F32)
        if segments else None)
    static = dict(dt=c["dt"], n_steps=c["n_steps"], low_vel_mode=False,
                  cost_structure=c["cost_structure"],
                  constraint_flags=c["flags"], n_levels=len(levels),
                  continuous=continuous)
    return args, static


def _jax_disc(obstacles, disc):
    """The JAX ObstacleArrays with the port's appended disc row."""
    M = obstacles.pose.shape[0]
    radii = np.zeros(M, np.float32) if obstacles.radius is None \
        else np.asarray(obstacles.radius)
    return jax_collision.ObstacleArrays(
        pose=jnp.asarray(disc.pose.numpy()),
        half_ext=jnp.asarray(disc.half_ext.numpy()),
        valid=jnp.asarray(disc.valid.numpy()),
        radius=jnp.asarray(np.append(radii, disc.radius.numpy()[-1])),
        poly_verts=obstacles.poly_verts, poly_valid=obstacles.poly_valid)


def _assert_fast_parity(want, out, got):
    """The ROADMAP bar: identical finite pattern and reasons, the argmin
    (index, counters, level, re-roll verdict) exact, costs rtol 2e-4 /
    atol 1e-2, the winner's states to 1e-4."""
    ws = want["scalars"]
    np.testing.assert_array_equal(out.scalars[[0, 2, 3, 4, 5]],
                                  ws[[0, 2, 3, 4, 5]])
    np.testing.assert_allclose(out.scalars[1], ws[1], rtol=2e-4)
    np.testing.assert_allclose(out.optimal, want["optimal"], rtol=0,
                               atol=1e-4)
    np.testing.assert_array_equal(got.reasons.numpy(), want["reasons"])
    nan_inf = lambda x: np.where(np.isnan(x), np.inf, x)
    for row, name in ((got.costs, "costs"), (got.kin_costs, "kin_costs")):
        w, g = nan_inf(want[name]), nan_inf(row.numpy())
        np.testing.assert_array_equal(np.isfinite(g), np.isfinite(w))
        fin = np.isfinite(w)
        np.testing.assert_allclose(g[fin], w[fin], rtol=2e-4, atol=1e-2)


@pytest.mark.parametrize("mode", FAST_MODES)
def test_fast_program_matches_jax(repo_root, mode):
    c = _seeded(_jax_first_cycle(repo_root), FAST_MODES.index(mode))
    levels = [1] if mode == "level" else [0, 1, 2]
    segments, continuous = mode == "segments", mode == "continuous"
    args, static = _port_fast_args(c, levels, segments, continuous)
    program = lp.LevelProgram(lp.FAST, args, static)
    obstacles = None
    if continuous:
        winner = program(args).optimal
        args = args._replace(obstacles=_with_corner_disc(
            args.obstacles, winner, args.veh))
        obstacles = _jax_disc(c["obstacles"], args.obstacles)
        program = lp.LevelProgram(lp.FAST, args, static)
    out = program(args)
    want = _jax_fast(c, levels, c["boundary"] if segments else None,
                     continuous, obstacles)
    _assert_fast_parity(want, out, program.outputs[0])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_level_program_matches_jax(repo_root, dtype):
    """The conformance program with the dense bundle against the JAX
    ``evaluate_level``: in float64 at 1e-9; in float32 (the capture
    bundle's dtype) at the ROADMAP bar (identical masks and argmin, costs
    rtol 2e-4 / atol 1e-2, the winner to 1e-4) and the bundle's positions
    to 1e-3 (tests/test_torch_capture.py's bar)."""
    c = _seeded(_jax_first_cycle(repo_root, dtype), 7)
    f64 = dtype == "float64"
    jdt, tdt = (jnp.float64, F64) if f64 else (jnp.float32, F32)
    b, goal_valid = c["batches"][1], c["goal_valid"][1]
    static = dict(dt=c["dt"], n_steps=c["n_steps"], low_vel_mode=False,
                  cost_structure=c["cost_structure"],
                  constraint_flags=c["flags"], boundary_mode="corridor",
                  continuous_check=False)
    want = jax_cycle.evaluate_level(
        jnp.asarray(b.coeffs_lon, jdt), jnp.asarray(b.coeffs_lat, jdt),
        jnp.asarray(b.traj_len), jnp.asarray(goal_valid), c["ref"],
        c["veh"], c["obstacles"], None, c["corridor"],
        jnp.asarray(c["x0_orientation"], jdt), c["cost_params"], **static)
    x0 = c["x0_orientation"] if f64 \
        else float(np.float32(c["x0_orientation"]))
    args = lp.LevelArgs(
        coeffs_lon=b.coeffs_lon, coeffs_lat=b.coeffs_lat,
        traj_len=b.traj_len, goal_valid=goal_valid, level_ids=None,
        x0_orientation=x0, cost_params=interop.cost_params(c["cost_params"]),
        veh=interop.vehicle(c["veh"]),
        ref=interop.ref_tables(c["ref"], dtype=tdt),
        corridor=interop.corridor(c["corridor"], dtype=tdt),
        obstacles=interop.obstacles(c["obstacles"], dtype=tdt),
        boundary=None)
    program = lp.LevelProgram(lp.LEVEL, args, dict(static, bundle=True))
    out = program(args)
    masks = np.asarray(want.masks)
    assert 0 < masks[1].sum() < masks.shape[1], "degenerate test"
    np.testing.assert_array_equal(program.outputs[0].masks.numpy(), masks)
    ws = np.asarray(want.scalars)
    np.testing.assert_array_equal(out.scalars[[0, 2, 3]], ws[[0, 2, 3]])
    x, y, costs, feasible, collides = out.bundle
    want_costs = np.asarray(want.costs)
    if f64:
        np.testing.assert_allclose(out.scalars[1], ws[1], rtol=1e-9)
        np.testing.assert_allclose(out.optimal, np.asarray(want.optimal),
                                   rtol=1e-9, atol=1e-9)
        for got_a, want_a in ((x, want.rollout.x), (y, want.rollout.y)):
            np.testing.assert_allclose(got_a, np.asarray(want_a), rtol=1e-9,
                                       atol=1e-9)
        np.testing.assert_allclose(costs, want_costs, rtol=1e-9)
    else:
        np.testing.assert_allclose(out.scalars[1], ws[1], rtol=2e-4)
        np.testing.assert_allclose(out.optimal, np.asarray(want.optimal),
                                   rtol=0, atol=1e-4)
        for got_a, want_a in ((x, want.rollout.x), (y, want.rollout.y)):
            np.testing.assert_allclose(got_a, np.asarray(want_a), atol=1e-3)
        fin = np.isfinite(want_costs)
        np.testing.assert_array_equal(np.isfinite(costs), fin)
        np.testing.assert_allclose(costs[fin], want_costs[fin], rtol=2e-4,
                                   atol=1e-2)
    np.testing.assert_array_equal(feasible, masks[0].astype(bool))
    np.testing.assert_array_equal(collides, masks[1].astype(bool))
    np.testing.assert_array_equal(
        out.reason_counts,
        _host_reason_counts(masks[2], goal_valid & (masks[0] == 0)))


def test_overflow_is_continued_as_the_lazy_loop(repo_root, monkeypatch):
    """``REFINE_WIDTH`` at 1 and a cycle that needs two re-selections (the
    exact segments reject the first winner, the continuous pass a disc at
    the second's corner): the program overflows, ``continue_lazy`` carries
    the lazy loop on, and the result equals the port's lazy loop bit for
    bit and the JAX ``while_loop`` at the parity bar."""
    c = _jax_first_cycle(repo_root)
    levels = [0, 1, 2]
    args, static = _port_fast_args(c, levels, segments=True)
    second = _eager(lp.FAST, args, static).optimal.numpy()
    args = args._replace(obstacles=_with_corner_disc(args.obstacles, second,
                                                     args.veh))
    static = dict(static, continuous=True)
    lazy = _eager(lp.FAST, args, static)
    unrefined = _eager(lp.FAST, args._replace(boundary=None),
                       dict(static, continuous=False))
    n_masked = int((torch.isfinite(unrefined.costs)
                    & ~torch.isfinite(lazy.costs)).sum())
    assert n_masked >= 2, "degenerate: fewer than two re-selections"

    monkeypatch.setattr(port_cycle, "REFINE_WIDTH", 1)
    program = lp.LevelProgram(lp.FAST, args, static)
    first = program(args)
    assert first.overflow
    out = program.continue_lazy()
    assert not out.overflow and program.continuations == 1
    assert program.readbacks == 2
    _same(out.scalars, lazy.scalars.numpy(), "scalars")
    _same(out.optimal, lazy.optimal.numpy(), "winner")
    want = _jax_fast(c, levels, c["boundary"], True,
                     _jax_disc(c["obstacles"], args.obstacles))
    ws = want["scalars"]
    np.testing.assert_array_equal(out.scalars[[0, 2, 3, 4, 5]],
                                  ws[[0, 2, 3, 4, 5]])
    np.testing.assert_allclose(out.scalars[1], ws[1], rtol=2e-4)
    np.testing.assert_allclose(out.optimal, want["optimal"], rtol=0,
                               atol=1e-4)


def test_planner_counts_continuations(repo_root, monkeypatch):
    """Through ``plan()``: ZAM_Over's first cycle with the segments
    boundary re-selects once, so a width of 1 overflows; the planner
    continues, counts it, and plans what the default width plans."""
    config = load_config(SCENARIO, repo_root)
    config.planning.boundary_mode = "segments"
    results = {}
    default = port_cycle.REFINE_WIDTH
    for width in (default, 1):
        monkeypatch.setattr(port_cycle, "REFINE_WIDTH", width)
        planner = make_planner(config, device="cpu")
        planner.set_desired_velocity(current_speed=planner.x_0.velocity)
        plan = planner.plan()
        results[width] = (
            np.array([[s.position[0], s.position[1], s.velocity]
                      for s in plan[0].state_list]),
            planner.optimal_cost, planner.infeasible_count_kinematics,
            planner.infeasible_count_collision,
            dict(planner.infeasible_reason_dict),
            planner.refine_continuations)
    wide, narrow = results[default], results[1]
    assert wide[5] == 0 and narrow[5] == 1
    np.testing.assert_array_equal(narrow[0], wide[0])
    assert narrow[1:5] == wide[1:5]


# ---------------------------------------------------------------------------
# calls, signatures, capture safety
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", [lp.FAST, lp.LEVEL])
def test_second_call_equals_fresh_build(repo_root, kind):
    """DEU_Test (dynamic obstacles): a call at another heading, desired
    speed, obstacle window and coefficients equals a fresh build, and the
    first call's results are not changed by it."""
    planner, batches = _planner(repo_root, "DEU_Test-1_1_T-1",
                                dtype=None if kind == lp.FAST
                                else "float64")
    if kind == lp.FAST:
        args, static = planner.fast_arguments(batches)
    else:
        args, static = planner.level_arguments(
            batches[1], planner._goal_valid_mask(batches[1]), True)
    program = lp.LevelProgram(kind, args, static)
    first = program(args)
    kept = [np.copy(x) for x in first[:2]]
    rng = np.random.default_rng(3)
    window = planner.collision_checker.obstacles_for_window(
        12, planner.N, planner.config.planning.factor)
    args2 = args._replace(
        x0_orientation=args.x0_orientation + 0.03,
        cost_params=args.cost_params._replace(
            desired_speed=args.cost_params.desired_speed + 2.0),
        obstacles=window,
        coeffs_lon=args.coeffs_lon * (1.0 + 1e-3 * rng.standard_normal(
            args.coeffs_lon.shape)),
        coeffs_lat=args.coeffs_lat + 1e-3 * rng.standard_normal(
            args.coeffs_lat.shape))
    assert not torch.equal(window.pose, args.obstacles.pose)
    second = program(args2)
    fresh = lp.LevelProgram(kind, args2, static)
    want = fresh(args2)
    for a, b, label in zip(second, want, lp.LevelOutput._fields):
        if label == "bundle":
            for x, y in zip(a or (), b or ()):
                _same(x, y, label)
        elif label != "overflow":
            _same(a, b, label)
    assert not np.array_equal(second.optimal, first.optimal)
    for x, y in zip(first[:2], kept):
        _same(x, y, "the first call's result")
    for a, b in zip(program.outputs[0], fresh.outputs[0]):
        if isinstance(a, torch.Tensor):
            _same(a, b, "device outputs")


def test_signatures_and_lru(repo_root, monkeypatch):
    """``low_vel_mode`` on and off are two signatures, each built once and
    found again; past ``LEVEL_PROGRAMS`` the least recently used program
    is dropped."""
    planner, batches = _planner(repo_root)
    args, static = planner.fast_arguments(batches)
    built = {}
    for low_vel in (False, True, False, True):
        s = dict(static, low_vel_mode=low_vel)
        program = planner._level_program(lp.FAST, args, s)
        assert built.setdefault(low_vel, program) is program
        program(args)
    assert len(planner.level_programs) == 2
    assert [p.calls for p in planner.level_programs.values()] == [2, 2]
    monkeypatch.setattr(planner_module, "LEVEL_PROGRAMS", 2)
    one_level, s1 = planner.fast_arguments(batches[:1])
    planner._level_program(lp.FAST, one_level, s1)
    assert len(planner.level_programs) == 2
    assert built[False] not in planner.level_programs.values()
    assert built[True] in planner.level_programs.values()
    with pytest.raises(ValueError, match="signature"):
        built[True](one_level)


RECORDED = [(lp.FAST, mode) for mode in ("fused", "segments",
                                         "continuous")] \
    + [(lp.LEVEL, mode) for mode in ("corridor", "segments", "continuous")]


@pytest.mark.parametrize("kind,mode", RECORDED)
def test_step_has_no_capture_forbidden_op(repo_root, kind, mode):
    args, static = _fast_case(repo_root, mode) if kind == lp.FAST \
        else _level_case(repo_root, mode, bundle=True)
    program = lp.LevelProgram(kind, args, static)
    program(args)
    with CaptureForbidden() as rec:
        program._program.step()
    assert rec.seen == [], rec.seen


class _HostReads(CaptureForbidden):
    """Records the reads of a tensor's value on the host (and, as its base
    does, boolean indexes and copies between devices)."""

    NAMES = ("_local_scalar_dense",)


def test_drive_reads_once_per_plan(repo_root):
    """ZAM_Over to its goal through ``plan()``: one built program, one
    readback per call and no other read of a tensor's value inside
    ``plan()`` (the reason counts come back in the readback)."""
    planner = make_planner(load_config(SCENARIO, repo_root), device="cpu")
    rec = _HostReads()
    inner = planner.plan

    def plan(*args):
        with rec:
            return inner(*args)

    planner.plan = plan
    result = drive_to_goal(planner, max_steps=100)
    assert result["goal_reached"] and result["steps"] == 27
    (program,) = planner.level_programs.values()
    assert program.calls == program.readbacks == result["plan_calls"] == 9
    assert rec.seen == []
    assert planner.refine_continuations == 0
