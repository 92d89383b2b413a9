"""The CUDA kernels (scorers, OBB collision in both forms, the dense XLA
fleet cycle's rollout and winner kernels, the probe kernel) against their
plain PyTorch versions, the captured replanning scans and
level programs against their uncaptured twins, the conformance level
program, the captured XLA fleet path and the fleet programs captured under
an NCCL group of one, on the card.  The fleet scorer's lattice form at
fleet1024's shape against its loaded form and against ``ops.grid`` on the
card, bit for bit, and the scorer kernels' build without register spills.

Marked ``gpu``: without a card every test skips.  On a machine with one,
run (from the repository root; no JAX needed):

    python -m pytest tests/test_torch_gpu.py --noconftest -q
"""

import re
import subprocess

import numpy as np
import pytest
import torch

import chip_smoke
from commonroad_rp_tpu_torch.ops import collision_kernel, cuda_build
from commonroad_rp_tpu_torch.ops import cycle as cycle_ops
from commonroad_rp_tpu_torch.ops import grid, scoring
from commonroad_rp_tpu_torch.ops.program import CapturedStep
from commonroad_rp_tpu_torch.run_fleet import heterogeneous_fleet, make_scan
from commonroad_rp_tpu_torch.run_planner import (drive_to_goal, load_config,
                                                 make_planner)
from commonroad_rp_tpu_torch.utils import profiling

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def test_largest_table_through_captured_scan(cuda):
    """The F=12 fleet's scan with its tables padded to the most rows a
    scorer block's shared memory holds: captured == uncaptured bit for
    bit, and the padding changes no found flag.  The warm-up cycle raises
    the kernel's shared-memory limit past 48 KB (``cudaFuncSetAttribute``)
    before the capture only where no earlier call in the process raised
    it: this module runs it first, and ``chip_smoke.py`` phase 6 runs the
    same check before any other launch at that size."""
    scene, carry, _, _ = heterogeneous_fleet(12, 3, device=cuda)
    padded = chip_smoke.padded_fleet_scene(
        torch, scene, chip_smoke.largest_table_rows(scene))
    run, twin = (make_scan(padded, 3, graph=g)[0] for g in (True, False))
    got, _, counts = chip_smoke.captured_and_twin(torch, "largest table",
                                                  run, twin, carry)
    assert counts == {"score_candidates": 0, "score_fleet": 2,
                      "lattice_candidates": 2}
    _, metrics = make_scan(scene, 3)[0](carry)
    assert torch.equal(got[1][0], metrics[0])


def _facade_forms(n_cycles, n_steps=None):
    config = load_config("ZAM_Over-1_1")
    if n_steps is not None:
        config.planning.time_steps_computation = n_steps
    planner = make_planner(config, "cuda")
    planner.set_desired_velocity(current_speed=planner.x_0.velocity)
    run, carry = planner.scan_program(n_cycles)
    twin, _ = planner.scan_program(n_cycles, graph=False)
    return run, twin, carry, (float(planner._desired_speed),)


def _scan_forms(which, cuda):
    """(captured program, uncaptured twin, carry, run arguments)."""
    if which == "plan_scan T=21":
        return _facade_forms(9)
    if which == "plan_scan T=61":
        return _facade_forms(12, n_steps=60)
    if which == "fleet F=12":
        scene, carry, _, _ = heterogeneous_fleet(12, 10, device=cuda)
        return (make_scan(scene, 10)[0], make_scan(scene, 10, graph=False)[0],
                carry, ())
    run, carry = chip_smoke.single_problem_scan(torch, 4, cuda)
    twin, _ = chip_smoke.single_problem_scan(torch, 4, cuda, graph=False)
    return run, twin, carry, ()


@pytest.mark.parametrize("which", ["plan_scan T=21", "plan_scan T=61",
                                   "fleet F=12", "single problem"])
def test_captured_scan_equals_uncaptured(cuda, which):
    """The default program on the card replays a captured cycle (its replay
    counter) and gives the uncaptured twin's carry, metrics and recorded
    states bit for bit, in a first and a warm call; a third call, from
    where the first ended and (``plan_scan``) at a desired speed 2 m/s
    above the captured one, replays again and still equals the twin at
    that speed."""
    run, twin, carry, args = _scan_forms(which, cuda)
    got, _, _ = chip_smoke.captured_and_twin(torch, which, run, twin, carry,
                                             *args)
    faster = tuple(ds + 2.0 for ds in args)
    again = run(got[0], *faster)
    assert run.replays == 3 * run.n_cycles
    chip_smoke.assert_bit_identical(torch, which, again,
                                    twin(got[0], *faster))


def test_capture_counters_count_captures_not_replays(cuda):
    """A step's capture adds 1 to ``captured_step.captures`` and a positive
    host wall to ``captured_step.capture_ns``; a warm replay adds
    nothing."""
    x = torch.arange(4.0, device=cuda)
    step = CapturedStep(lambda: x * 2, cuda)
    before = profiling.counters()
    out = step()
    first = profiling.counters()
    step()
    torch.cuda.synchronize()
    assert first["captured_step.captures"] == \
        before.get("captured_step.captures", 0) + 1
    assert first["captured_step.capture_ns"] > \
        before.get("captured_step.capture_ns", 0)
    assert profiling.counters() == first
    assert step.replays == 2 and torch.equal(out, x * 2)


def _kernel_vs_plain(label, args, kwargs):
    before = scoring.score_candidates.launches
    out_k = scoring.score_candidates(*args, **kwargs)
    out_p = scoring.score_candidates_reference(*args, **kwargs)
    torch.cuda.synchronize()
    assert scoring.score_candidates.launches == before + 1
    chip_smoke.compare(torch, label, out_k, out_p,
                       chip_smoke.in_domain(torch, args, kwargs["n_steps"]))


@pytest.mark.parametrize("n_steps", [20, 60])
def test_kernel_matches_plain_synthetic_scene(cuda, n_steps):
    args, kwargs = chip_smoke.synthetic_args(torch, n_steps, cuda)
    _kernel_vs_plain(f"synthetic_T{n_steps + 1}", args, kwargs)


def test_kernel_matches_plain_first_cycle(cuda):
    planner = make_planner(load_config("ZAM_Over-1_1"), "cuda")
    planner.set_desired_velocity(current_speed=planner.x_0.velocity)
    x0_lon, x0_lat = planner.begin_cycle()
    inputs = planner.cycle_inputs([
        planner._create_trajectory_bundle(x0_lon, x0_lat, level)
        for level in range(1, planner.sampling_level)])
    inputs.pop("n_levels")
    inputs.pop("level_ids")
    _kernel_vs_plain("ZAM_Over first cycle",
                     *cycle_ops.scorer_arguments(**inputs))


def test_kernel_drives_to_goal(cuda):
    """ZAM_Over through the captured ``plan()``: one fused program, whose
    warm-up and capture are the wrapper's two launches; a warm drive on it
    executes ``score_kernel`` once per call (profiler)."""
    planner = make_planner(load_config("ZAM_Over-1_1"), "cuda")
    scoring.score_candidates.launches = 0
    result = drive_to_goal(planner, max_steps=100)
    assert result["goal_reached"] and result["steps"] == 27
    assert len(planner.level_programs) == 1
    assert scoring.score_candidates.launches == 2
    executions, _ = chip_smoke.kernel_executions(
        torch, lambda: chip_smoke.plan_drive(
            torch, "ZAM_Over-1_1", programs=planner.level_programs),
        chip_smoke.SCORE_KERNEL, 9)
    assert executions == result["plan_calls"] == 9


def test_captured_plan_drive_equals_uncaptured(cuda):
    """ZAM_Over to its goal through the captured ``plan()`` and through the
    ``graph=False`` twin: bit for bit the same states, costs, counters and
    reason dicts; in a warm drive every call after the first (which also
    compiles the corridor) reads the device once; a replay at
    a desired speed 2 m/s higher equals the twin at that speed."""
    got = chip_smoke.plan_drive(torch, "ZAM_Over-1_1")
    want = chip_smoke.plan_drive(torch, "ZAM_Over-1_1", graph=False)
    chip_smoke.assert_drives_identical("ZAM_Over", got, want)
    (program,) = got[0].level_programs.values()
    assert program.graph and program.replays == program.calls == 9
    assert not any(p.graph for p in want[0].level_programs.values())
    rows = chip_smoke.reads_per_plan(torch, "ZAM_Over-1_1",
                                     programs=got[0].level_programs)
    assert len(rows) == got[1]["plan_calls"]
    chip_smoke.check_reads("ZAM_Over", rows, per_call=1)
    chip_smoke.replay_at_new_speed(torch, "ZAM_Over", "ZAM_Over-1_1")


def test_kernel_rejects_mixed_devices(cuda):
    args, kwargs = chip_smoke.synthetic_args(torch, 20, cuda)
    args = (args[0],) + (args[1].cpu(),) + args[2:]
    with pytest.raises(ValueError):
        scoring.score_candidates(*args, **kwargs)


@pytest.fixture
def fleet12(cuda):
    """The 12-problem fleet (4 scenarios x 3 vehicle types), level 3."""
    scene, carry, _, _ = heterogeneous_fleet(12, 10, device=cuda)
    return scene, carry


def test_fleet_kernel_matches_plain_first_cycle(fleet12):
    scene, carry = fleet12
    inp = chip_smoke.captured_operands(
        lambda scorer: make_scan(scene, 1, scorer=scorer,
                                        graph=False)[0](carry))
    before = scoring.score_fleet.launches
    out_k = scoring.score_prepared(inp)
    out_p = scoring.score_prepared_reference(inp)
    torch.cuda.synchronize()
    assert scoring.score_fleet.launches == before + 1
    chip_smoke.compare(torch, "fleet F=12", out_k, out_p,
                       chip_smoke.prepared_in_domain(torch, inp))


def test_fleet_scan_kernel_matches_plain_without_device_reads(fleet12):
    scene, carry = fleet12
    run_k, _ = make_scan(scene, 5)
    run_p, _ = make_scan(scene, 5, scorer=scoring.score_prepared_reference)
    before = scoring.score_fleet.launches
    final_k, metrics_k = chip_smoke.no_sync(torch, lambda: run_k(carry))
    # the warm-up cycle's launch and the captured one; 5 replays
    assert scoring.score_fleet.launches == before + 2
    assert run_k.replays == 5
    final_p, metrics_p = run_p(carry)
    assert torch.equal(metrics_k[0], metrics_p[0])
    torch.testing.assert_close(final_k.x0_lon, final_p.x0_lon, rtol=0,
                               atol=chip_smoke.SCAN_ATOL)


def test_fleet_kernel_rejects_bad_operands(fleet12):
    scene, carry = fleet12
    inp = chip_smoke.captured_operands(
        lambda scorer: make_scan(scene, 1, scorer=scorer,
                                        graph=False)[0](carry))
    loaded = scoring.lattice_scorer_inputs(inp)
    with pytest.raises(ValueError):
        scoring.score_prepared(loaded._replace(
            coeffs_lon=loaded.coeffs_lon.transpose(0, 1)))
    with pytest.raises(ValueError, match="x0_lon must be contiguous float32"):
        scoring.score_prepared(inp._replace(x0_lon=inp.x0_lon.double()))
    with pytest.raises(ValueError, match="bounds has shape"):
        scoring.score_prepared(inp._replace(
            bounds=inp.bounds[:, :1].contiguous()))
    with pytest.raises(ValueError, match="index must be"):
        scoring.lattice_candidates(inp, torch.zeros(
            (12, 1), dtype=torch.int32, device=inp.x0_lon.device))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fleet_kernel_matches_plain_on_hostile_operands(cuda, seed):
    """The operands of ``probes.hostile_inputs`` (the CPU tests hold the
    plain version against the JAX scorer on the same arrays): kernel against
    plain."""
    from commonroad_rp_tpu_torch.probes import hostile_inputs

    case = hostile_inputs.hostile_fleet(seed)
    args, kwargs = hostile_inputs.score_fleet_arguments(
        case, lambda a: torch.as_tensor(a, device=cuda))
    inp = scoring.prepare_fleet_inputs(*args, **kwargs)
    before = scoring.score_fleet.launches
    out_k = scoring.score_prepared(inp)
    out_p = scoring.score_prepared_reference(inp)
    torch.cuda.synchronize()
    assert scoring.score_fleet.launches == before + 1
    chip_smoke.compare(torch, f"hostile {seed}", out_k, out_p,
                       chip_smoke.prepared_in_domain(torch, inp))


def test_shared_memory_size_and_limit_are_the_library_s(fleet12):
    """The wrapper's shared-memory bytes and limit are the library's own, and
    the kernel runs, and agrees with the plain version, with the tables
    padded to the limit."""
    scene, carry = fleet12
    inp = chip_smoke.captured_operands(
        lambda scorer: make_scan(scene, 1, scorer=scorer,
                                        graph=False)[0](carry))
    out_p = scoring.score_prepared_reference(inp)
    lib = scoring._library()
    P, (M, T) = inp.tables.shape[1], inp.obs.shape[1:3]
    for n_rows in (P, 4096):
        assert scoring.shared_bytes(n_rows, M, T) \
            == lib.crp_score_shared_bytes(n_rows, M, T)
    assert scoring.SHARED_BLOCK_LIMIT == lib.crp_score_shared_limit()
    before = scoring.score_fleet.launches
    chip_smoke.compare_largest_table(torch, "fleet F=12", inp, out_p)
    assert scoring.score_fleet.launches == before
    with pytest.raises(ValueError, match="must be contiguous float32"):
        scoring.score_prepared(inp._replace(scalars=inp.scalars.double()))


def test_plan_scan_on_card_one_launch_per_cycle(cuda):
    """``plan_scan`` takes the cached captured program; the wrapper counts
    the warm-up's launch and the captured one, the profiler one
    ``score_kernel`` execution per cycle of a replayed call."""
    planner = make_planner(load_config("ZAM_Over-1_1"), "cuda")
    planner.set_desired_velocity(current_speed=planner.x_0.velocity)
    run, carry = planner.scan_program(9)
    planner.record_state_and_input(planner.x_0)
    scoring.score_candidates.launches = 0
    info = planner.plan_scan(9)
    assert info["goal_reached"] and info["steps"] == 27
    assert run.graph and run.replays == info["cycles_run"] == 9
    assert scoring.score_candidates.launches == 2
    count, names = chip_smoke.kernel_executions(
        torch, lambda: run(carry, float(planner._desired_speed)),
        chip_smoke.SCORE_KERNEL, 9)
    assert count == 9, names


def _collision_kernel_vs_plain(ops):
    before = collision_kernel.obb_collision.launches
    got = collision_kernel.obb_collision(*ops)
    want = collision_kernel.obb_collision_reference(*ops)
    torch.cuda.synchronize()
    assert collision_kernel.obb_collision.launches == before + 1
    assert got.dtype == torch.bool and got.device.type == "cuda"
    differ = torch.nonzero(got != want).flatten()
    tol = chip_smoke.MARGIN_TOL[str(ops[0].dtype).split(".")[-1]]
    margins = chip_smoke.sat_margins(torch, *ops)[differ]
    assert bool(torch.all(margins < tol)), margins
    assert len(differ) == 0, margins


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_steps", [20, 60])
def test_collision_kernel_matches_plain_synthetic(cuda, dtype, n_steps):
    _collision_kernel_vs_plain(chip_smoke.collision_scene(torch, n_steps,
                                                          dtype, cuda))


@pytest.mark.parametrize("dtype_name", ["float32", "float64"])
def test_collision_kernel_matches_plain_first_cycle_levels(cuda, dtype_name):
    levels = chip_smoke.level_collision_operands(torch, "ZAM_Over-1_1",
                                                 dtype_name)
    assert len(levels) == 3
    for ops in levels:
        _collision_kernel_vs_plain(ops)


def test_collision_kernel_rejects_mixed_devices(cuda):
    cx, cy, theta, obstacles, hl, hw = chip_smoke.collision_scene(
        torch, 20, torch.float32, cuda)
    with pytest.raises(ValueError):
        collision_kernel.obb_collision(cx, cy.cpu(), theta, obstacles, hl,
                                       hw)
    with pytest.raises(ValueError):
        collision_kernel.obb_collision(cx, cy, theta.double(), obstacles, hl,
                                       hw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_collision_kernels_match_plain_on_hostile_and_near_touching(cuda,
                                                                    dtype):
    """Both forms against their plain versions, 0 differing candidates, on
    the operands of ``probes.hostile_collision`` (the CPU tests hold the
    g++-compiled pair test to the plain version on the same arrays): the
    hostile cases and the near-touching scene, each over the horizon and
    each step alone."""
    for label, ops in chip_smoke.collision_cases(torch, dtype, cuda).items():
        chip_smoke.compare_collision_case(torch, label, ops)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_collision_shared_memory_limit_boundary(cuda, dtype):
    """The library's shared-memory size and limit are the wrapper's; the
    most rows a block stages run in both forms and agree with the plain
    versions, one row more raises ``ValueError``."""
    lib = collision_kernel.library()
    size = torch.empty((), dtype=dtype).element_size()
    for M, T in ((1, 21), (5, 21), (16, 61), (261, 21)):
        assert collision_kernel.shared_bytes(M, T, dtype) \
            == lib.crp_collision_shared_bytes(M, T, size)
    assert collision_kernel.SHARED_BLOCK_LIMIT \
        == lib.crp_collision_shared_limit()
    ops = chip_smoke.collision_cases(torch, dtype, cuda, seeds=())
    chip_smoke.compare_largest_rows(torch, "near-touching",
                                    ops["near-touching"])


def test_collision_wrappers_launch_one_kernel_per_call(cuda):
    """One device kernel per ``obb_collision``/``obb_collision_fleet`` call
    (no conversion of the mask afterwards): the profiler sees no other
    kernel, and no more launches than calls."""
    from commonroad_rp_tpu_torch.probes.hostile_collision import \
        problem_operands

    ops = chip_smoke.collision_cases(torch, torch.float64, cuda,
                                     seeds=())["near-touching"]
    one = problem_operands(ops, 0)
    for fn, name in ((lambda: collision_kernel.obb_collision_fleet(*ops),
                      "obb_collision_fleet_kernel"),
                     (lambda: collision_kernel.obb_collision(*one),
                      "obb_collision_kernel")):
        chip_smoke.check_one_kernel_per_call(torch, name, fn, name)


def test_conformance_golden_and_drive_on_card(cuda):
    config = load_config("ZAM_Over-1_1")
    config.debug.kernel_dtype = "float64"
    planner = make_planner(config, "cuda")
    planner.set_desired_velocity(current_speed=planner.x_0.velocity)
    golden = chip_smoke.GOLDEN_FIRST_CYCLE["ZAM_Over-1_1"]
    end = planner.plan()[0].state_list[-1]
    assert planner.optimal_cost == pytest.approx(golden["cost"], rel=1e-9)
    assert end.velocity == pytest.approx(golden["end_velocity"], abs=1e-9)
    assert (planner.infeasible_count_kinematics,
            planner.infeasible_count_collision) == golden["counters"]

    planner = make_planner(config, "cuda")
    collision_kernel.obb_collision.launches = 0
    result = drive_to_goal(planner, max_steps=100)
    assert result["goal_reached"] and result["steps"] == 27
    # the warm-up's launch and the captured one per built level program;
    # one execution per level evaluation (one per call here) when replayed
    assert collision_kernel.obb_collision.launches \
        == 2 * len(planner.level_programs)
    executions, _ = chip_smoke.kernel_executions(
        torch, lambda: chip_smoke.plan_drive(
            torch, "ZAM_Over-1_1", dtype="float64",
            programs=planner.level_programs),
        chip_smoke.COLLISION_KERNEL, result["plan_calls"])
    assert executions == result["plan_calls"]


def test_fleet_collision_kernel_and_xla_fleet_on_card(cuda):
    """The fleet form of the collision kernel against its plain version on
    the 12-problem fleet's first XLA cycle (both dtypes, 0 differing
    candidates), and the XLA fleet path, captured, bit for bit its
    ``graph=False`` twin and close to the fused fleet scan: the wrapper
    counts the warm-up's launch and the captured one, the twin one launch
    per cycle, and a replay executes the kernel once per cycle
    (profiler)."""
    from commonroad_rp_tpu_torch.run_fleet import make_xla_rollout

    scene, carry, _, _ = heterogeneous_fleet(12, 4, device=cuda)
    chip_smoke.compare_fleet_collision(
        torch, "F=12", chip_smoke.captured_fleet_collision(
            lambda: make_xla_rollout(1, 1, cuda, graph=False)[0](carry,
                                                               scene)))
    run_x, _ = make_xla_rollout(4, 1, cuda)
    twin_x, _ = make_xla_rollout(4, 1, cuda, graph=False)
    collision_kernel.obb_collision_fleet.launches = 0
    final_x, metrics_x = chip_smoke.no_sync(torch,
                                            lambda: run_x(carry, scene))
    assert run_x.graph and run_x.replays == 4
    assert collision_kernel.obb_collision_fleet.launches == 2
    chip_smoke.assert_bit_identical(torch, "XLA F=12", (final_x, metrics_x),
                                    twin_x(carry, scene))
    assert collision_kernel.obb_collision_fleet.launches == 2 + 4
    executions, _ = chip_smoke.kernel_executions(
        torch, lambda: run_x(carry, scene), chip_smoke.FLEET_COLLISION_KERNEL,
        4)
    assert executions == 4
    final_f, metrics_f = make_scan(scene, 4)[0](carry)
    assert torch.equal(metrics_x.found, metrics_f[0])
    torch.testing.assert_close(final_x.x0_lon, final_f.x0_lon, rtol=2e-4,
                               atol=2e-3)


def test_captured_xla_rollout_at_route_ends_equals_uncaptured(cuda):
    """The 12-problem fleet with every member on a route shorter than the
    fleet's longest started 8 m before its route's end: the captured XLA
    rollout, its carry read after every cycle (``observe``), bit for bit
    its ``graph=False`` twin; members stop at their route's end, none is
    carried past it, and the fused fleet scan finds what it finds."""
    from commonroad_rp_tpu_torch.parallel import fleet
    from commonroad_rp_tpu_torch.run_fleet import make_xla_rollout

    scene, carry, _, _ = heterogeneous_fleet(12, 6, device=cuda)
    ends = fleet.true_path_lengths(scene.ref.s)
    short = ends < ends.max() - 1.0
    x0_lon = carry.x0_lon.clone()
    x0_lon[short, 0] = ends[short] - 8.0
    carry = carry._replace(x0_lon=x0_lon)
    seen = {}
    results = {}
    for graph in (True, False):
        run, _ = make_xla_rollout(6, 1, cuda, graph=graph)
        seen[graph] = []
        results[graph] = run(carry, scene, observe=lambda c, g=graph:
                             seen[g].append(c.x0_lon.clone()))
        assert run.graph == graph
    chip_smoke.assert_bit_identical(torch, "XLA F=12 at route ends",
                                    results[True], results[False])
    assert len(seen[True]) == 6
    assert all(torch.equal(a, b) for a, b in zip(seen[True], seen[False]))
    final, metrics = results[True]
    assert not bool(metrics.found[-1][short].all())
    assert bool(torch.all(final.x0_lon[:, 0] <= ends))
    _, metrics_f = make_scan(scene, 6)[0](carry)
    assert torch.equal(metrics.found, metrics_f[0])


@pytest.fixture(scope="module")
def fleet12_first():
    """The 12-problem fleet's scene and carry, built once for the dense
    rollout kernel's tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    scene, carry, _, _ = heterogeneous_fleet(12, 6, device="cuda")
    return scene, carry


@pytest.mark.parametrize("dtype_name", ["float32", "float64"])
@pytest.mark.parametrize("route_end", [False, True],
                         ids=["start", "route_end"])
def test_dense_rollout_kernel_matches_plain_first_cycle(fleet12_first,
                                                        route_end,
                                                        dtype_name):
    """``dense_rollout_kernel`` against its plain version on the 12-problem
    fleet's first XLA cycle, as it starts and with every member on a route
    shorter than the longest 8 m before its end (the fleet of
    ``test_captured_xla_rollout_at_route_ends_equals_uncaptured``):
    feasibility and corridor verdicts equal but for at most
    ``chip_smoke.DENSE_MAX_FLIPS`` (a margin within the last bits), costs
    within ``chip_smoke.DENSE_TOLERANCE`` (PyTorch's reduction sums in
    another order), poses bit for bit, and ``dense_winner_kernel``'s states
    the plain bundle's at the plain version's winners, bit for bit."""
    scene, carry = fleet12_first
    inp = chip_smoke.dense_first_cycle(
        torch, scene, carry, getattr(torch, dtype_name), route_end)
    readings = chip_smoke.compare_dense_rollout(
        torch, f"F=12 {'route end' if route_end else 'start'}", inp)
    assert readings["ok"] > 0


def test_dense_rollout_counts_and_one_kernel_per_cycle(fleet12_first):
    """The captured XLA rollout's wrappers count the warm-up's launch and
    the captured one (``dense_rollout.launches``, ``dense_winner.launches``:
    2 each), a replay counts nothing, and the profiler sees one
    ``dense_rollout_kernel`` per replayed cycle; the kernel's operand checks
    and its shared-memory size are the library's."""
    from commonroad_rp_tpu_torch.ops import dense_rollout as dr
    from commonroad_rp_tpu_torch.run_fleet import make_xla_rollout

    scene, carry = fleet12_first
    run, _ = make_xla_rollout(4, 1, "cuda")
    before = (dr.dense_rollout.launches, dr.dense_winner.launches)
    run(carry, scene)
    assert run.graph and run.replays == 4
    assert (dr.dense_rollout.launches, dr.dense_winner.launches) == \
        (before[0] + 2, before[1] + 2)
    executions, names = chip_smoke.kernel_executions(
        torch, lambda: run(carry, scene), chip_smoke.DENSE_KERNEL, 4)
    assert executions == 4, names
    assert (dr.dense_rollout.launches, dr.dense_winner.launches) == \
        (before[0] + 2, before[1] + 2)
    inp = chip_smoke.dense_first_cycle(torch, scene, carry)
    P = inp.ref.s.shape[1]
    lib = dr.library()
    for dtype in (torch.float32, torch.float64):
        assert lib.crp_dense_shared_bytes(P, dtype.itemsize) == \
            dr.shared_bytes(P, dtype)
    assert lib.crp_dense_shared_limit() == dr.SHARED_BLOCK_LIMIT
    with pytest.raises(ValueError, match="s_last"):
        dr.dense_rollout(inp._replace(s_last=inp.s_last.double()), 0.1, 20)
    with pytest.raises(ValueError, match="best"):
        dr.dense_winner(inp, None, torch.zeros(12, dtype=torch.int32,
                                               device="cuda"), 0.1, 20, 1, 10)


def test_fleet_programs_capture_under_nccl(cuda):
    """Under a world-size-1 NCCL group both fleet programs of the dry run
    (the XLA rollout and the fused fleet scan) capture their cycle with the
    three all-reduces in the graph, bit for bit their eager twins."""
    import torch.distributed as dist

    from commonroad_rp_tpu_torch.parallel import dryrun, mesh

    device = mesh.initialize_distributed(
        f"tcp://localhost:{dryrun.free_port()}", 1, 0, cuda)
    try:
        group = mesh.make_fleet_group()
        programs = {graph: dryrun.fleet_programs(group, 0, 1, device, graph)
                    for graph in (True, False)}
        carry, scene = programs[True][2:]
        args = {"xla": (carry, scene), "fused": (carry,)}
        for i, key in enumerate(("xla", "fused")):
            run, twin = programs[True][i], programs[False][i]
            got = run(*args[key])
            assert run.graph and run.replays == run.n_cycles
            assert not twin.graph
            chip_smoke.assert_bit_identical(torch, f"NCCL {key}", got,
                                            twin(*args[key]))
        dryrun.run_rank(group, 0, 1, device)
    finally:
        dist.destroy_process_group()


def test_probe_kernel_matches_plain_exactly(cuda):
    from commonroad_rp_tpu_torch.probes import t61_overhead

    ops = t61_overhead.probe_operands(60, cuda)
    inp = scoring.prepare_inputs(*ops["args"], 20.0, 0.0, 5.0,
                                 ops["ref_s_last"], n_steps=60)
    v = torch.full((), 20.5, dtype=torch.float32, device=cuda)
    before = scoring.trivial_probe.launches
    got = scoring.trivial_probe(inp, v)
    assert scoring.trivial_probe.launches == before + 1
    assert torch.equal(got, scoring.trivial_probe_reference(inp, v))
    for value in (20.5, -3.25):
        v = torch.full((1,), value, dtype=torch.float32, device=cuda)
        assert torch.equal(scoring.trivial_probe(inp, v),
                           scoring.trivial_probe_reference(inp, v))
    assert scoring.trivial_probe.launches == before + 3
    with pytest.raises(ValueError, match="one float32 value"):
        scoring.trivial_probe(inp, v.double())


def test_scorer_kernels_build_without_spills(cuda, tmp_path):
    """``nvcc -Xptxas -v`` with the library's flags: ``score_kernel`` and
    both sources of ``fleet_score_kernel`` spill no register (0 bytes of
    spill stores and loads each)."""
    cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o",
           str(tmp_path / "lib.so"), str(scoring.KERNEL_SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    log = proc.stdout + proc.stderr
    entries = re.split(r"Compiling entry function", log)[1:]
    scorers = [e for e in entries
               if re.match(r"\s*'[^']*score_kernel", e)]
    assert len(scorers) == 3, log
    for entry in scorers:
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                           r"loads", entry)
        assert spills and spills.groups() == ("0", "0"), entry


@pytest.fixture(scope="module")
def fleet1024():
    """fleet1024's scene and carry (the benchmark's fleet: 12 bases
    jittered to 1024 problems, level 3, K = 2754), 150 cycles of span."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    scene, carry, _, _ = heterogeneous_fleet(1024, 150, device="cuda")
    return scene, carry


def _fleet1024_scan(fleet, mode, n_cycles, **kwargs):
    """fleet1024's scan in velocity keeping (``run_fleet.make_scan``) or
    stopping (stop targets 8 m ahead of each member, windows of +-1 m)."""
    scene, carry = fleet
    if mode == "velocity_keeping":
        return make_scan(scene, n_cycles, **kwargs)[0]
    from commonroad_rp_tpu_torch.parallel import replanning_scan
    from commonroad_rp_tpu_torch.run_fleet import DT, LEVEL, N_STEPS

    desired_s = (carry.x0_lon[:, 0].cpu().numpy() + 8.0).astype(np.float32)
    g = grid.make_static_grid(LEVEL, 0.4, N_STEPS * DT, DT, -3.0, 3.0, 4)
    return replanning_scan.make_fleet_scan(
        scene, g, DT, N_STEPS, replan_offset=1, low_vel_threshold=4.0,
        horizon=N_STEPS * DT, n_cycles=n_cycles,
        longitudinal_mode="stopping", desired_s=desired_s,
        s_window=np.stack([desired_s - 1.0, desired_s + 1.0], axis=1),
        w_a=1.0, **kwargs)


def _same_bits(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.contiguous().cpu().numpy().tobytes() == \
        b.contiguous().cpu().numpy().tobytes()


@pytest.mark.parametrize("mode", ["velocity_keeping", "stopping"])
def test_lattice_source_equals_loaded_source_fleet1024(fleet1024, mode):
    """The first cycle at fleet1024's shape: ``fleet_score_kernel`` on the
    lattice and on the same candidates generated by ``ops.grid`` on the
    card and loaded give equal [3, F, K] rows, bit for bit, with members
    in and out of the low-velocity mode."""
    inp = chip_smoke.captured_operands(
        lambda scorer: _fleet1024_scan(fleet1024, mode, 1, scorer=scorer,
                                       graph=False)(fleet1024[1]))
    low_vel = inp.scalars[:, scoring._S_LOW_VEL] > 0.5
    assert bool(low_vel.any()) and not bool(low_vel.all())
    before = scoring.score_fleet.launches
    got = torch.stack(scoring.score_prepared(inp))
    want = torch.stack(scoring.score_prepared(
        scoring.lattice_scorer_inputs(inp)))
    torch.cuda.synchronize()
    assert scoring.score_fleet.launches == before + 2
    assert got.shape == (3, 1024, 2754)
    assert _same_bits(got, want)
    assert bool(torch.isfinite(got[0]).any())


@pytest.mark.parametrize("mode", ["velocity_keeping", "stopping"])
def test_lattice_candidates_kernel_equals_grid_gather(fleet1024, mode):
    """``lattice_candidates`` on the card at every candidate of fleet1024's
    first cycle (index [F, K]) and at each member's cheapest: what
    ``torch.gather`` takes from ``ops.grid``'s tensors on the card, bit for
    bit; one launch each."""
    inp = chip_smoke.captured_operands(
        lambda scorer: _fleet1024_scan(fleet1024, mode, 1, scorer=scorer,
                                       graph=False)(fleet1024[1]))
    full = scoring.lattice_scorer_inputs(inp)
    F, K = full.traj_len.shape
    every = torch.arange(K, device=inp.x0_lon.device).repeat(F, 1)
    best = torch.argmin(scoring.score_prepared(inp)[0], dim=1)[:, None]
    before = scoring.lattice_candidates.launches
    for index in (every, best):
        got = scoring.lattice_candidates(inp, index)
        J = index.shape[1]
        take = lambda a: torch.gather(a, 1, index[..., None].expand(F, J, 6))
        want = (take(full.coeffs_lon), take(full.coeffs_lat),
                torch.gather(full.traj_len, 1, index))
        for g, w in zip(got, want):
            assert _same_bits(g, w)
    assert scoring.lattice_candidates.launches == before + 2


@pytest.mark.parametrize("mode", ["velocity_keeping", "stopping"])
def test_captured_fused_scan_equals_the_grid_cycle(fleet1024, mode):
    """One 150-cycle episode of the captured fused fleet scan against the
    same scan, captured, whose cycles generate the candidates with
    ``ops.grid``, score them loaded and gather the winners from them: the
    same carry and metrics, bit for bit."""
    _, carry = fleet1024
    got = _fleet1024_scan(fleet1024, mode, 150)(carry)

    def gathered(inp, index):
        full = scoring.lattice_scorer_inputs(inp)
        take = lambda a: torch.gather(a, 1, index[..., None].expand(
            *index.shape, 6))
        return (take(full.coeffs_lon), take(full.coeffs_lat),
                torch.gather(full.traj_len, 1, index))

    run = _fleet1024_scan(
        fleet1024, mode, 150,
        scorer=lambda inp: scoring.score_prepared(
            scoring.lattice_scorer_inputs(inp)), candidates=gathered)
    want = run(carry)
    assert run.graph and run.replays == 150
    chip_smoke.assert_bit_identical(torch, f"fleet1024 {mode}", got, want)
