#!/usr/bin/env python3
"""Smoke run of the PyTorch port's main path on one CUDA card.

Run from the repository root:

    python3 chip_smoke.py [--profile DIR]

Phases (any failure raises and ends the run with a non-zero exit code):

1. environment: torch, CUDA, nvcc and triton versions, the card's name and
   power limit from nvidia-smi;
2. build: ``commonroad_rp_tpu_torch/csrc/scoring.cu`` and ``collision.cu``
   with nvcc for sm_90a, one nvcc per source, started together;
3. kernel against its plain PyTorch version on the card: ZAM_Over-1_1's
   first planning cycle (the main path's shape), then a synthetic scene with
   OBB, disc and polygon obstacles at T=21 and T=61;
4. the main path: ``ReactivePlanner(device="cuda")`` drives ZAM_Over-1_1
   (and the other three bundled scenarios) through the host replanning loop
   to the goal in the JAX fast path's step counts, each ``plan()`` one
   replay of the captured fused level program (``ops.level_program``), bit
   for bit the uncaptured twin's drive (``graph=False``: states, costs,
   counters, reason dicts); the scorer wrapper counts the warm-up's launch
   and the captured one per built program, and a warm drive executes
   ``score_kernel`` once per ``plan()`` call (profiler) and reads the
   device once per call; a replay at a desired speed 2 m/s higher equals
   the twin at that speed; each built program's first-call cost (warm-up
   and capture) and reserved memory; the first cycle's winner must match
   the CPU plain-version planner on the same inputs;
5. times: kernel and plain version at both shapes (CUDA events, warm,
   medians), and ``plan()`` p50/p90 of both forms over the drives' calls,
   two rounds in turns, with the planner's stage timers and the device busy
   share of 20 ``plan()`` calls in each form;
6. the fleet kernel against its plain version on the card: the 12-problem
   fleet (4 scenarios x 3 vehicle types, level 3, T=21), first cycle, at
   the bar of phase 3; its 3-cycle scan with the tables padded to the most
   rows a block's shared memory holds, captured bit for bit against
   uncaptured before any other launch at that size (the warm-up cycle must
   raise the kernel's shared-memory limit before the capture), then the
   kernel at that size against its plain version; the hostile operands of
   ``probes.hostile_inputs`` (the table search's edge cases, the early
   exits'); then a 10-cycle captured fleet scan through the kernel
   against the same scan through the plain version (identical ``alive``,
   states within 2e-3);
7. ``plan_scan`` on the card, as a captured CUDA graph per cycle: each of
   the four scenarios' scans (9/12/15/49 cycles) bit for bit its
   uncaptured twin (``graph=False``), both run under
   ``torch.cuda.set_sync_debug_mode("error")`` (no cycle reads the device),
   with one ``score_kernel`` execution per cycle (profiler) and a replay
   at a desired speed 2 m/s above the captured one bit for bit the twin at
   that speed (the states must move with the speed somewhere), then the
   scenario to its goal in 27/35/44/146 steps through ``plan_scan``, which
   replays the captured cycle, its recorded states certified as in
   tests/test_torch_certification.py (``utils.evaluation.certify_drive``:
   start, goal, collisions, road boundary, the reconstruction's drift;
   every transition KS-feasible but on the T-junction, whose failing
   transitions must be exactly the JAX package's 27 of 146,
   ``probes.divergence7.TJUNCTION_FAILING``, no allowance); the
   single-problem scan captured against
   uncaptured; ZAM_Over at T=61 captured against uncaptured, and through
   the kernel against the plain version (same found flags, states within
   5e-3); ms/cycle and device busy share of both forms at T=21 and T=61;
   for every captured scan, the first call's extra time over a warm call
   (warm-up cycle and capture) and the device memory it reserved;
8. the 1024-problem heterogeneous fleet at full width (K=2754 per problem,
   150 cycles at replanning frequency 1), captured: bit for bit the
   uncaptured twin (carry, metrics, member outcomes), one fleet-kernel
   execution per cycle, no device read between cycles, the JAX package's
   per-scenario goal counts; both forms' ms/cycle, candidate-evals/s and
   busy share; the fleet kernel against the plain version, how the first
   cycle's candidates end (prefiltered, first violation, colliding,
   selectable), the fleet kernel's and the plain version's times;
9. the OBB collision kernel (``csrc/collision.cu``) against its plain
   version in float32 and float64: synthetic scenes (K=3414, T=21 and 61,
   M=16 with disc rows and padded invalid rows) and every sampling level of
   the four scenarios' first cycles on the conformance path; then both
   forms on the hostile operands of ``probes.hostile_collision`` (skip
   boundaries, touching boxes and discs, NaN, inf, huge and subnormal poses;
   the horizon and each step alone) and its near-touching scene, and with
   the rows padded to the most a block's shared memory holds (one row more
   must raise); 0 differing candidates everywhere (and none whose tightest
   SAT margin is 1e-5 m (float32) or 1e-12 m (float64) or more); one device
   kernel per ``obb_collision`` call; kernel and plain times;
10. the conformance level program (``kernel_dtype: float64``) on the card:
   the four first-cycle goldens of tests/test_precision_and_golden.py, the
   four drives to their goals in 27/35/44/146 steps through the captured
   level programs, bit for bit their uncaptured twins, with one collision
   kernel execution per level evaluation that has obstacles (profiler) and
   one device read per level evaluation, a replay at a new desired speed
   against the twin, ``plan()`` p50/p90 and busy share of both forms (and
   with the plain obstacle pass in the kernel's place), and
   the four scenarios through ``segments`` and continuous ``plan_scan`` to
   their goals, each scan captured and bit for bit its uncaptured twin,
   with no device read between cycles and the largest per-cycle
   re-selection count of the scan's exact refinement;
11. the XLA fleet path (``parallel.fleet.make_fleet_rollout``) on the card,
   captured (one cycle as a CUDA graph, replayed per cycle): the bench shape
   (16 copies of ZAM_Over-1_1, K=2754, T=21, 10 cycles), the 12-problem
   heterogeneous fleet (10 cycles; and a second scene of the same shapes
   through the same program) and ``run_fleet --xla``'s 1024-problem fleet
   (150 cycles) each bit for bit its ``graph=False`` twin (every metric of
   every cycle, fleet1024's member outcomes), with no device read between
   cycles, the wrapper counting the warm-up's and the captured launch, one
   ``obb_collision_fleet_kernel`` execution per cycle (profiler: F=16,
   F=12, and a 3-cycle fleet1024 program), the graph's pool, the first
   call's extra time, both forms' ms/cycle, candidate-evals/s and busy
   share; the fleet form of the collision kernel (``obb_collision_fleet``)
   against its plain version in float32 and float64, 0 differing
   candidates; the 12-problem fleet through the XLA path and the fused
   fleet scan at the bars of tests/test_torch_xla_fleet.py; fleet1024 beside
   the fused scan's goal counts (phase 8), the kernel's time (one device
   kernel per call), the share of pair tests its bounding-circle skip
   removes and the peak device memory of both forms;
12. the NCCL dry run in this process (a world-size-1 NCCL group,
   ``dryrun.run_rank``: two XLA fleet cycles and one fused fleet-scan
   cycle, global success count = F); its two programs
   (``dryrun.fleet_programs``) captured with their all-reduces in the
   graph and bit for bit their ``graph=False`` twins; three
   one-element ``fleet_all_reduce`` calls recorded per captured step and per
   eager cycle, a replay launching as many device operations as the eager
   twin (profiler), what one all-reduce launches eager and replayed; and
   the n=1 row of ``measure_scaling``;
13. the T=61 launch-overhead probe (``probes.t61_overhead``): phases A, C and
   D, 150 launches each; the probe kernel against its plain version
   (exactly equal), and the time of one ``scoring.trivial_probe`` call
   beside one ``torch.add``, the same call through the same launch path with
   nothing launched, and the event pair alone;
14. trajectory-set capture: ZAM_Over to the goal through ``plan()`` with
   ``draw_traj_set`` and ``save_plots`` in the JAX package's 27 steps, with
   the selected states, counters and reasons of the same drive without
   capture; the bundles through the captured level program, bit for bit
   the uncaptured twin's, with one collision-kernel execution per capture
   with obstacles (profiler) and a replay at a new desired speed against
   the twin; the first bundle against the card's float32 conformance
   bundle (the CPU
   test's bar); the capture's extra time per cycle (CUDA events); three
   timestep plots, the final trajectory, the state and input plots and a
   solution file that reads back and passes ``run_evaluation``, all under
   ``output/chip_smoke/``;
15. the checkpointed fleet1024: the captured fused scan for 75 cycles,
   ``save_fleet_carry``, ``load_fleet_carry(device="cuda")``, 75 more, bit
   for bit the uninterrupted 150-cycle scan (final carry, per-cycle metrics,
   member outcomes);
16. the numpy oracle at full width: every sampling level of ZAM_Over's
   first cycle through the card's float64 rollout and cost and through
   ``baseline.oracle`` on the host (feasibility and reasons identical,
   arrays and costs within 1e-9, the same argmin);
17. the six device primitives on the card against their CPU results, and
   the C++ host module (``native``), which must build.

Every kernel's entry in the JSON line carries its launches on its path (the
wrappers count eager launches and captures, not the replays of a captured
program: the entry of a captured path adds ``executions``, the profiler's
count), its
time per call beside its plain version's (and the scorers' and the probe's
``device_ms``, the profiler's device time per call), the least time the card
could take for the same work (``bound_ms``: the larger of the bytes over
3.35 TB/s and the operations over the card's peak for their type, from this
run's inputs) and, where one PyTorch call computes the same function, that
call's time.

The card's name and power limit, then a JSON object of per-kernel results,
come on the two lines before the last; the last line is ``{"ok": true,
"device": {...}}``.  Without a card, or outside a checkout of the
repository, the run fails before printing any of them.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import os
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
RTOL, ATOL = 2e-4, 1e-2
# steps to the goal on the JAX package's fast path
EXPECTED_STEPS = {"ZAM_Over-1_1": 27, "DEU_Test-1_1_T-1": 35,
                  "ZAM-Ramp-1_1-T-1": 44, "ZAM_Tjunction-1_42_T-1": 146}
# plan_scan cycles to the goal (replanning frequency 3), the JAX package's
EXPECTED_CYCLES = {"ZAM_Over-1_1": 9, "DEU_Test-1_1_T-1": 12,
                   "ZAM-Ramp-1_1-T-1": 15, "ZAM_Tjunction-1_42_T-1": 49}
# fleet1024 goal counts of the JAX package on the TPU (BENCH_r05.json)
JAX_FLEET1024 = {"ZAM_Over-1_1": "258/258", "DEU_Test-1_1_T-1": "256/256",
                 "ZAM_Tjunction-1_42_T-1": "201/255 (54 dead)",
                 "ZAM-Ramp-1_1-T-1": "255/255"}
PLAIN_REPS, KERNEL_REPS = 20, 200
SCAN_ATOL, SCAN61_ATOL = 2e-3, 5e-3
# the collision kernel may disagree with its plain version only on a
# candidate whose tightest SAT margin is below this (metres)
MARGIN_TOL = {"float32": 1e-5, "float64": 1e-12}
TIMED_COLLISION_CASES = ("synthetic", "ZAM_Over-1_1 level",
                         "ZAM_Tjunction-1_42_T-1 level")
# published peaks of one H100 SXM (NVIDIA's data sheet, dense, at the 700 W
# limit): float32 and float64 outside the tensor cores, device memory rate
PEAK_OPS = {"float32": 67e12, "float64": 34e12}
PEAK_BYTES = 3.35e12
# operations of the fused scorer that every candidate-step runs whatever the
# data (cost sums, the extension), and those an active step adds (rollout,
# table lookup, Werling transform, kinematic checks), counted in
# csrc/scoring.cu with a transcendental as one operation; each halving of a
# binary table search adds 3.  The corridor and obstacle tests, which stop at
# a candidate's first collision, are not counted: the bound is a lower bound
SCORER_STEP_OPS, SCORER_ACTIVE_OPS = 60, 190
# float operations of one lattice candidate's coefficient rows that run
# whatever the mode (csrc/scoring.cu lattice_candidate: the linspace target
# 7, the quartic row 16 (the stop quintic's 34 counted as the quartic's),
# the lateral quintic 34, the goal test 1): the fleet kernel's lattice form
# builds each candidate at least once, lattice_candidates_kernel each chosen
# one
LATTICE_OPS = 58
# collision kernels (csrc/collision.cu): an ego step whose heading is
# computed (cos/sin, once a row of the step survives the skip), a valid
# (step, row) pair's skip test (two differences, two squares, their sum) and
# a pair's full test once it survives the skip
COLLISION_STEP_OPS, COLLISION_SKIP_OPS, COLLISION_PAIR_OPS = 2, 5, 40
# the dense XLA cycle's kernel (csrc/dense_rollout.cu walk_candidate), a
# transcendental as one operation: every step's cost sums, corridor probes
# and pose centres; an active step's polynomials, table interpolation,
# Werling transform, the five checks, the position and the domain test; an
# extension step's constant-acceleration update; each table search counted
# as one halving (3: the hint brackets most at once)
DENSE_STEP_OPS, DENSE_ACTIVE_OPS, DENSE_EXT_OPS, DENSE_SEARCH_OPS = \
    50, 180, 18, 3
# the dense kernel against its plain version on the card: verdicts that may
# differ (a feasibility or corridor margin within the last bits; none has),
# the costs' relative gap (PyTorch's reduction sums in another order: 1.2e-6
# and 2e-15 measured) and the poses' absolute gap (bit for bit: both sides
# call the same CUDA functions in the same order); the winner kernel's
# states must equal the plain bundle's
DENSE_MAX_FLIPS = 2
DENSE_TOLERANCE = {"float32": dict(cost=1e-5, pose=0.0),
                   "float64": dict(cost=1e-12, pose=0.0)}
# steps to the goal on the JAX package's float64 conformance path (ramp and
# T-junction pinned in tests/test_planner_e2e.py, the other two recorded
# from the JAX package on the CPU): the same as its fast path's
CONFORMANCE_STEPS = dict(EXPECTED_STEPS)
# first-cycle goldens of the float64 conformance path, copied from
# tests/test_precision_and_golden.py (_GOLDEN_FIRST_CYCLE): winner cost (rtol
# 1e-9), end state (position 1e-7, velocity and orientation 1e-9),
# (kinematic, colliding) rejection counters and the reason histogram
GOLDEN_FIRST_CYCLE = {
    "ZAM_Over-1_1": dict(
        cost=3733.4777003862982,
        end_position=(67.81315751831903, 4.149639636126384),
        end_velocity=19.508531368656065,
        end_orientation=0.08752291224665676, counters=(45, 44),
        reasons={"acceleration": 2, "kappa_dot": 43}),
    "DEU_Test-1_1_T-1": dict(
        cost=79.28082121119598,
        end_position=(57.224441656399875, 2.0000000000000067),
        end_velocity=11.606224999999998,
        end_orientation=3.297691703707007e-16, counters=(76, 0),
        reasons={"acceleration": 18, "kappa_dot": 52, "yaw_rate": 6}),
    "ZAM-Ramp-1_1-T-1": dict(
        cost=305733.87850203505,
        end_position=(6.327282906400004, 1.7499999999999991),
        end_velocity=5.000000000000005,
        end_orientation=6.86410096761853e-17, counters=(68, 0),
        reasons={"acceleration": 12, "kappa": 12, "kappa_dot": 44}),
    "ZAM_Tjunction-1_42_T-1": dict(
        cost=43.12236764498027,
        end_position=(-0.6221825578422608, 0.021638369718770756),
        end_velocity=5.240995600000005,
        end_orientation=-0.03976196117155634, counters=(63, 0),
        reasons={"kappa_dot": 63}),
}


def log(msg):
    print(msg, flush=True)


def check(ok, msg):
    if not ok:
        raise AssertionError(msg)


def run(cmd):
    try:
        return subprocess.run(cmd, capture_output=True, text=True,
                              timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"unavailable ({exc})"


def environment(torch):
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}")
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    log("nvcc: " + run([nvcc, "--version"]).splitlines()[-1])
    try:
        import triton
        log(f"triton {triton.__version__}")
    except ImportError:
        log("triton not installed")
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"])
    log(f"device: {torch.cuda.get_device_name(0)} "
        f"(count {torch.cuda.device_count()}); nvidia-smi: {smi}")
    return smi


def cuda_time_ms(torch, fn, reps):
    """Median of per-call times (ms) over ``reps`` warm calls, CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def build_all():
    """Build every kernel library of the port in parallel (one nvcc per
    source), then print each build's ptxas lines."""
    from concurrent.futures import ThreadPoolExecutor

    from commonroad_rp_tpu_torch.ops import collision_kernel, cuda_build
    from commonroad_rp_tpu_torch.ops import dense_rollout, scoring

    t0 = time.time()
    sources = (scoring.KERNEL_SOURCE, collision_kernel.KERNEL_SOURCE,
               dense_rollout.KERNEL_SOURCE)
    with ThreadPoolExecutor(len(sources)) as pool:
        paths = list(pool.map(cuda_build.build, sources))
    for source, path in zip(sources, paths):
        log(f"build: {path.relative_to(HERE)} (from {source.name})")
        build_log = cuda_build.build_log(source) or ""
        for line in build_log.splitlines():
            if "ptxas" in line or "spill" in line or "error" in line.lower():
                log("  " + line.strip())
        spilled = re.findall(r"([1-9]\d*) bytes spill (?:stores|loads)",
                             build_log)
        check(not spilled, f"{source.name}: ptxas reports register spills "
              f"({', '.join(spilled)} bytes)")
    log(f"build: {len(sources)} libraries in {time.time() - t0:.1f} s")


def in_domain(torch, args, n_steps):
    """Candidates whose active steps all lie in [0, s_last]."""
    cl, tl, s_last = args[0], args[2], args[13]
    T = n_steps + 1
    t = (torch.arange(T, dtype=torch.float32, device=cl.device)
         * float(args[8]))[:, None]
    t2 = t * t
    s = (cl[:, 0] + cl[:, 1] * t + cl[:, 2] * t2 + cl[:, 3] * (t2 * t)
         + cl[:, 4] * (t2 * t2) + cl[:, 5] * (t2 * t2 * t))
    active = torch.arange(T, device=cl.device)[:, None] < tl[None, :]
    return torch.all(((s >= 0) & (s <= s_last)) | ~active, dim=0)


def compare(torch, label, kernel_out, plain_out, domain):
    """Kernel rows against the plain version's (rows [K], or [F, K] for a
    fleet: argmin per problem); returns max |cost error|."""
    rows = [[x.cpu().numpy().reshape(-1, x.shape[-1]) for x in out]
            for out in (kernel_out, plain_out)]
    (km, kk, kr), (pm, pk, pr) = rows
    nan_inf = lambda x: np.where(np.isnan(x), np.inf, x)
    max_err = 0.0
    flips = 0
    for name, g, w in (("masked", nan_inf(km), nan_inf(pm)),
                       ("kin", nan_inf(kk), nan_inf(pk))):
        differ = np.isfinite(g) != np.isfinite(w)
        flips += int(differ.sum())
        for f, i in np.argwhere(differ)[:10]:
            log(f"  {label} {name} flip at {f},{i}: kernel {g[f, i]!r} "
                f"reason {kr[f, i]:.0f}, plain {w[f, i]!r} reason "
                f"{pr[f, i]:.0f}")
        fin = np.isfinite(g) & np.isfinite(w)
        if fin.any():
            err = np.abs(g[fin] - w[fin])
            max_err = max(max_err, float(err.max()))
            np.testing.assert_allclose(g[fin], w[fin], rtol=RTOL, atol=ATOL,
                                       err_msg=f"{label}: {name} costs")
    dom = domain.cpu().numpy().reshape(km.shape)
    reason_diff = int(np.sum(kr[dom] != pr[dom]))
    gm, wm = nan_inf(km), nan_inf(pm)
    tie = True
    for f in range(gm.shape[0]):
        if np.isfinite(wm[f]).any():
            ig, iw = int(np.argmin(gm[f])), int(np.argmin(wm[f]))
            tie = tie and (ig == iw or bool(np.isclose(
                gm[f, ig], wm[f, iw], rtol=RTOL, atol=ATOL)))
    shape = "K" if km.shape[0] == 1 else "F x K"
    log(f"{label}: {shape}={'x'.join(map(str, kernel_out[0].shape))} "
        f"feasible={int(np.isfinite(pk).sum())} "
        f"selectable={int(np.isfinite(pm).sum())} finite-pattern flips="
        f"{flips} reason mismatches (in domain)={reason_diff} "
        f"max|cost err|={max_err:.3e} argmin agrees={tie}")
    if flips or reason_diff or not tie:
        raise AssertionError(f"{label}: kernel disagrees with the plain "
                             "version")
    return max_err


def loaded_operands(inp):
    """Prepared operands with the candidates as tensors: a lattice's
    expanded by ``ops.grid``, others as they are."""
    from commonroad_rp_tpu_torch.ops import scoring

    if isinstance(inp, scoring.FleetLatticeInputs):
        return scoring.lattice_scorer_inputs(inp)
    return inp


def prepared_in_domain(torch, inp):
    """Candidates of prepared operands (one problem or a fleet) whose
    active steps all lie in [0, s_last]."""
    from commonroad_rp_tpu_torch.ops import scoring

    inp = loaded_operands(inp)
    if not isinstance(inp, scoring.FleetScorerInputs):
        inp = scoring._as_fleet(inp)
    cl, tl, sc = inp.coeffs_lon, inp.traj_len, inp.scalars
    T = inp.n_steps + 1
    t = (torch.arange(T, dtype=torch.float32, device=cl.device)[:, None, None]
         * sc[:, scoring._S_DT][None, :, None])
    t2 = t * t
    c = [cl[..., i][None] for i in range(6)]
    s = (c[0] + c[1] * t + c[2] * t2 + c[3] * (t2 * t) + c[4] * (t2 * t2)
         + c[5] * (t2 * t2 * t))
    active = torch.arange(T, device=cl.device)[:, None, None] < tl[None]
    last = sc[:, scoring._S_REF_S_LAST][None, :, None]
    return torch.all(((s >= 0) & (s <= last)) | ~active, dim=0)


def lattice_equals_loaded(torch, label, inp, out_k):
    """The fleet kernel's rows ``out_k`` on lattice operands ``inp`` against
    its rows on the same candidates loaded (``ops.grid`` on the card): bit
    for bit.  Returns the loaded operands; launches not counted."""
    from commonroad_rp_tpu_torch.ops import scoring

    loaded = loaded_operands(inp)
    with uncounted():
        out_l = scoring.score_prepared(loaded)
    torch.cuda.synchronize()
    same = all(bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))
               for a, b in zip(out_k, out_l))
    log(f"{label}: the lattice's rows equal the loaded candidates' bit for "
        f"bit: {same}")
    check(same, f"{label}: the lattice and the loaded candidates differ")
    return loaded


def captured_operands(run_scan):
    """The scorer operands of a scan's first cycle (the fleet scan's are
    ``FleetLatticeInputs``): ``run_scan(scorer)`` runs a one-cycle
    uncaptured scan with the given scoring function."""
    from commonroad_rp_tpu_torch.ops import scoring

    captured = []

    def capture(inp):
        captured.append(inp)
        return scoring.score_prepared_reference(inp)

    run_scan(capture)
    return captured[0]


@contextlib.contextmanager
def uncounted():
    """Launches made inside (to compare or time a kernel) leave the scorer
    wrappers' counts as they were."""
    from commonroad_rp_tpu_torch.ops import scoring

    wrappers = (scoring.score_candidates, scoring.score_fleet,
                scoring.lattice_candidates, scoring.trivial_probe)
    saved = [w.launches for w in wrappers]
    try:
        yield
    finally:
        for w, n in zip(wrappers, saved):
            w.launches = n


def time_prepared(torch, inp, kernel_reps, plain_reps):
    """(kernel ms, plain ms) of ``score_prepared`` and its plain version on
    prepared operands; launches not counted."""
    from commonroad_rp_tpu_torch.ops import scoring

    with uncounted():
        k_ms = cuda_time_ms(torch, lambda: scoring.score_prepared(inp),
                            kernel_reps)
        p_ms = cuda_time_ms(
            torch, lambda: scoring.score_prepared_reference(inp), plain_reps)
    return k_ms, p_ms


def compare_largest_table(torch, label, inp, plain_out):
    """The kernel on ``inp`` with every table padded to the most rows a
    block's shared memory holds (``scoring.SHARED_BLOCK_LIMIT``; far above
    the 48 KB a kernel gets unasked) against ``plain_out``, the plain
    version's rows on ``inp``: the padding, copies of the last row at
    arclengths stepping 1e6 further, leaves the scorer's function unchanged
    (no query reaches the new rows' intervals).  One row more must raise.
    Returns max |cost error|; launches not counted."""
    from commonroad_rp_tpu_torch.ops import scoring

    fleet = hasattr(inp, "tables")
    tables = inp.tables if fleet else inp.table[None]
    M, T = inp.obs.shape[-3:-1]
    n_rows = (scoring.SHARED_BLOCK_LIMIT - scoring.shared_bytes(0, M, T)) // 4
    pad = tables[:, -1:].repeat(1, n_rows + 1 - tables.shape[1], 1)
    pad[..., 0] += 1e6 * torch.arange(1, pad.shape[1] + 1,
                                      dtype=torch.float32,
                                      device=tables.device)
    padded = torch.cat([tables, pad], dim=1)
    with_rows = lambda n: inp._replace(tables=padded[:, :n].contiguous()) \
        if fleet else inp._replace(table=padded[0, :n].contiguous())
    with uncounted():
        out_k = scoring.score_prepared(with_rows(n_rows))
        torch.cuda.synchronize()
        try:
            scoring.score_prepared(with_rows(n_rows + 1))
        except ValueError as exc:
            check("bytes of shared memory per block" in str(exc), str(exc))
        else:
            raise AssertionError(f"{label}: {n_rows + 1} table rows did not "
                                 "raise")
    return compare(torch, f"{label}, tables padded to {n_rows} rows "
                   f"({scoring.shared_bytes(n_rows, M, T)} B shared)", out_k,
                   plain_out, prepared_in_domain(torch, inp))


def single_problem_scan(torch, n_cycles, device, graph=True, n_steps=20):
    """(run, carry) of ``make_replanning_scan`` on ZAM_Over-1_1: sampling
    level 2, replanning offset 3, the scenario's desired speed."""
    from commonroad_rp_tpu_torch.ops import grid
    from commonroad_rp_tpu_torch.parallel import replanning_scan
    from commonroad_rp_tpu_torch.parallel.dryrun import (over_problem,
                                                         shared_vehicle)

    p = over_problem(n_steps, horizon_pad=60, root=HERE)
    on = lambda tup: type(tup)(*(x.to(device) if isinstance(x, torch.Tensor)
                                 else x for x in tup))
    run = replanning_scan.make_replanning_scan(
        on(p["ref_tables"]), on(p["corridor"]), on(p["obstacles"]),
        shared_vehicle(),
        grid.make_static_grid(2, 0.4, n_steps * 0.1, 0.1, -3.0, 3.0, 4),
        0.1, n_steps, replan_offset=3, low_vel_threshold=4.0,
        horizon=n_steps * 0.1, desired_speed=float(p["desired_speed"]),
        n_cycles=n_cycles, graph=graph)
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    carry = replanning_scan.ReplanningCarry(
        x0_lon=f32(p["x0_lon"]), x0_lat=f32(p["x0_lat"]),
        orientation=f32(p["orientation"]), velocity=f32(p["velocity"]),
        time_step=torch.zeros((), dtype=torch.int32, device=device),
        alive=torch.ones((), dtype=torch.bool, device=device))
    return run, carry


def assert_bit_identical(torch, label, got, want):
    """Two scan results (carry, metrics) bit for bit: the same dtypes,
    shapes and bytes in every carry field and metric."""
    raw = lambda t: t.detach().cpu().numpy().tobytes()
    (carry_g, metrics_g), (carry_w, metrics_w) = got, want
    for name, a, b in zip(carry_w._fields, carry_g, carry_w):
        check(a.dtype == b.dtype and a.shape == b.shape and raw(a) == raw(b),
              f"{label}: carry field {name} differs")
    check(len(metrics_g) == len(metrics_w), f"{label}: metric counts differ")
    for i, (a, b) in enumerate(zip(metrics_g, metrics_w)):
        check(a.dtype == b.dtype and a.shape == b.shape and raw(a) == raw(b),
              f"{label}: metric {i} differs")


def captured_and_twin(torch, label, run, twin, carry, *args):
    """The first call of a captured scan program (warm-up, capture, one
    replay per cycle) against its uncaptured twin, both without a device
    read between cycles: bit for bit, and the replay count; then a second,
    warm call of the program, bit for bit the first.  Logs the first
    call's extra time over the warm one (the warm-up cycle and the
    capture, host clock) and the device memory the first call reserved
    (``memory_reserved`` delta after ``empty_cache``: the static buffers,
    the warm-up's blocks and the graph's pool).  Returns (captured result,
    uncaptured result, the scorer wrappers' counts of the first call: the
    warm-up's launch and the captured one)."""
    from commonroad_rp_tpu_torch.ops import scoring

    check(run.graph and not twin.graph and run.replays == 0,
          f"{label}: not a fresh captured program and its twin")
    reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    got = no_sync(torch, lambda: run(carry, *args))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    pool = torch.cuda.memory_reserved() - reserved
    counts = {"score_candidates": scoring.score_candidates.launches,
              "score_fleet": scoring.score_fleet.launches,
              "lattice_candidates": scoring.lattice_candidates.launches}
    want = no_sync(torch, lambda: twin(carry, *args))
    assert_bit_identical(torch, label, got, want)
    check(run.replays == run.n_cycles, f"{label}: {run.replays} replays "
          f"for {run.n_cycles} cycles")
    t0 = time.perf_counter()
    again = run(carry, *args)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    assert_bit_identical(torch, f"{label}, warm call", again, got)
    log(f"{label}: captured == uncaptured bit for bit ({run.n_cycles} "
        f"cycles, {len(got[1])} metrics), a warm call too; first call "
        f"{first_s * 1e3:.1f} ms, warm {warm_s * 1e3:.1f} ms (warm-up cycle "
        f"and capture {(first_s - warm_s) * 1e3:.1f} ms); first call "
        f"reserved {pool} B ({pool / 2**20:.1f} MiB); wrapper counts of the "
        f"first call {counts}")
    return got, want, counts


def kernel_executions(torch, fn, pattern, expected, attempts=8, warm=True):
    """Executions of the device kernels whose name matches ``pattern`` (a
    regular expression) in one warm call of ``fn`` under ``torch.profiler``,
    and ``{name: executions}`` of every device operation traced (kernels,
    copies, sets; ``warm=False``: ``fn`` builds nothing, so no untraced
    call comes first).  The profiler drops events
    now and then (a trace may hold none), so a trace that holds fewer than
    ``expected`` is taken again, up to ``attempts`` times (logged when more
    than one was needed); the largest count is returned."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if warm:
        fn()
    torch.cuda.synchronize()
    best, counts = 0, {}
    for attempt in range(attempts):
        if attempt:
            log(f"  {attempt} trace(s) held at most {best} of {expected} "
                f"executions of {pattern}: traced again")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = [evt for evt in prof.key_averages()
                   if evt.device_type == DeviceType.CUDA]
        count = sum(evt.count for evt in kernels
                    if re.search(pattern, evt.key))
        if count >= best:
            best, counts = count, {evt.key: evt.count for evt in kernels}
        if best >= expected:
            break
    return best, counts


# the scorers' device kernels by name (fleet_score_kernel also ends in
# score_kernel), and the single-problem collision kernel's
SCORE_KERNEL, FLEET_SCORE_KERNEL = r"(?<!fleet_)score_kernel", \
    r"fleet_score_kernel"
COLLISION_KERNEL = r"obb_collision_kernel"
FLEET_COLLISION_KERNEL = r"obb_collision_fleet_kernel"
DENSE_KERNEL = r"dense_rollout_kernel"


def padded_fleet_scene(torch, scene, n_rows):
    """``scene`` with every reference table padded to ``n_rows`` rows the
    way ``parallel.fleet.build_fleet_scene`` pads a short path: arclength
    sentinels 1e6 apart along the final tangent, every other row a copy of
    the last, the corridor band repeated."""
    ref = scene.ref
    pad = n_rows - ref.s.shape[1]
    steps = 1e6 * torch.arange(1, pad + 1, dtype=ref.s.dtype,
                               device=ref.s.device)
    rep = lambda a: torch.cat([a, a[:, -1:].expand(
        (a.shape[0], pad) + a.shape[2:])], dim=1).contiguous()
    fields = {f: rep(getattr(ref, f)) for f in ref._fields}
    fields["s"] = torch.cat([ref.s, ref.s[:, -1:] + steps], dim=1)
    fields["points"] = torch.cat(
        [ref.points, ref.points[:, -1:] + steps[None, :, None]
         * ref.tangent[:, -1:]], dim=1)
    padded = ref._replace(**fields)
    return scene._replace(ref=padded, corridor_lo=rep(scene.corridor_lo),
                          corridor_hi=rep(scene.corridor_hi))


def largest_table_rows(fleet_scene, n_steps=20):
    """Reference rows that give a fleet scan's packed tables (one sentinel
    row more) the most rows a scorer block's shared memory holds."""
    from commonroad_rp_tpu_torch.ops import scoring

    M = fleet_scene.obs_pose.shape[1]
    most = (scoring.SHARED_BLOCK_LIMIT
            - scoring.shared_bytes(0, M, n_steps + 1)) // 4
    return most - 1


def no_sync(torch, fn):
    """fn() with every synchronizing CUDA call raising (the scan loops must
    not read the device between cycles)."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)


def plan_drive(torch, name, graph=True, dtype=None, programs=None,
               configure=None, device="cuda", before=None):
    """``name`` to its goal through ``plan()`` (``drive_to_goal``):
    (planner, result, record), the record holding each step's rejection
    counters, reason dict and optimal cost.  ``graph=False`` drives the
    uncaptured twin; ``programs`` (a planner's ``level_programs``) makes the
    drive reuse built level programs, so that it builds and captures
    nothing; ``configure(config)`` edits the configuration first and
    ``before(planner)`` sees the planner before the drive."""
    from commonroad_rp_tpu_torch.run_planner import (drive_to_goal,
                                                     load_config,
                                                     make_planner)

    config = load_config(name, HERE)
    if dtype is not None:
        config.debug.kernel_dtype = dtype
    if configure is not None:
        configure(config)
    planner = make_planner(config, device=device, graph=graph)
    if programs is not None:
        planner.level_programs = programs
    if before is not None:
        before(planner)
    record = []
    result = drive_to_goal(planner, max_steps=300, on_step=lambda _: (
        record.append((planner.infeasible_count_kinematics,
                       planner.infeasible_count_collision,
                       dict(planner.infeasible_reason_dict),
                       planner.optimal_cost))))
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return planner, result, record


def drive_states(planner):
    """A drive's recorded states as one float64 array (time step,
    position, orientation, velocity, acceleration, yaw rate, steering
    angle; NaN where a value is unset)."""
    value = lambda x: np.nan if x is None else float(x)
    return np.array([[value(getattr(s, f)) for f in (
        "time_step", "orientation", "velocity", "acceleration", "yaw_rate",
        "steering_angle")] + [float(x) for x in s.position]
        for s in planner.record_state_list])


def assert_drives_identical(label, got, want):
    """Two ``plan_drive`` results bit for bit: steps, calls, every recorded
    state, each step's counters, reason dict and cost."""
    (pg, rg, recg), (pw, rw, recw) = got, want
    check(rg["steps"] == rw["steps"]
          and rg["plan_calls"] == rw["plan_calls"],
          f"{label}: {rg['steps']} steps / {rg['plan_calls']} calls against "
          f"{rw['steps']} / {rw['plan_calls']}")
    check(np.array_equal(drive_states(pg), drive_states(pw), equal_nan=True),
          f"{label}: the selected states differ")
    check(recg == recw, f"{label}: counters, reasons or costs differ")


def device_reads(torch, fn):
    """(fn(), the device reads it made): host reads of CUDA tensor values
    (``_local_scalar_dense``) and copies from the card to the host,
    counted under a ``TorchDispatchMode``."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Reads(TorchDispatchMode):
        count = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            name = func.overloadpacket.__name__
            if name == "_local_scalar_dense" and args[0].is_cuda:
                self.count += 1
            elif name == "copy_" and args[1].is_cuda and not args[0].is_cuda:
                self.count += 1
            elif name == "_to_copy" and args[0].is_cuda and torch.device(
                    kwargs.get("device") or args[0].device).type == "cpu":
                self.count += 1
            return func(*args, **kwargs)

    with Reads() as reads:
        out = fn()
    return out, reads.count


def reads_per_plan(torch, name, **kwargs):
    """(device reads, level-program readbacks) of each ``plan()`` call of
    a drive (``plan_drive``'s keyword arguments).  A planner's first call
    also compiles the scene's corridor bands on the host from the card's
    tables, once per planner and reference path."""
    rows = []

    def counting(planner):
        inner = planner.plan
        readbacks = lambda: sum(p.readbacks
                                for p in planner.level_programs.values())

        def plan(*args):
            before = readbacks()
            out, reads = device_reads(torch, lambda: inner(*args))
            rows.append((reads, readbacks() - before))
            return out
        planner.plan = plan

    plan_drive(torch, name, before=counting, **kwargs)
    return rows


def check_reads(label, rows, per_call=None):
    """Every ``plan()`` call after the first reads the device exactly as
    often as its level programs read back (``per_call`` each, where
    given); logs the first call's reads."""
    later = rows[1:]
    check(all(reads == back for reads, back in later)
          and (per_call is None or all(back == per_call
                                       for _, back in rows)),
          f"{label}: device reads and program readbacks per plan() call "
          f"{rows}")
    log(f"{label}: {sum(r for r, _ in later)} device reads in "
        f"{len(later)} plan() calls after the first, one per level-program "
        f"readback; the first call {rows[0][0]} (its readbacks "
        f"{rows[0][1]} and the corridor's compilation)")


@contextlib.contextmanager
def program_calls():
    """Records every level-program call made inside as (program, host
    seconds up to its readback, whether its window had obstacles)."""
    from commonroad_rp_tpu_torch.ops import level_program

    calls = []
    inner = level_program.LevelProgram.__call__

    def timed(self, args):
        t0 = time.perf_counter()
        out = inner(self, args)
        calls.append((self, time.perf_counter() - t0,
                      args.obstacles.pose.shape[0] > 0))
        return out

    level_program.LevelProgram.__call__ = timed
    try:
        yield calls
    finally:
        level_program.LevelProgram.__call__ = inner


def log_builds(label, calls):
    """Per built level program: its first call's extra time over the
    median of its warm calls (the warm-up and the capture, host clock), its
    graph's pool and its static buffers."""
    by_program = {}
    for program, seconds, _ in calls:
        by_program.setdefault(id(program), (program, []))[1].append(seconds)
    for program, times in by_program.values():
        warm = statistics.median(times[1:]) if len(times) > 1 else None
        extra = "no warm call" if warm is None else (
            f"{(times[0] - warm) * 1e3:.1f} ms more than a warm call "
            f"({warm * 1e3:.3f} ms)")
        pool = program.pool_bytes
        log(f"{label}: {'captured' if program.graph else 'uncaptured'} "
            f"{program.kind} program K={program.K} T={program.T}, "
            f"{len(times)} calls: first call {extra}; graph pool "
            + ("none" if pool is None else
               f"{pool} B ({pool / 2**20:.2f} MiB)")
            + f", static buffers {program.buffer_bytes} B")


def plan_busy(torch, name, graph, programs, dtype=None, calls=20):
    """Device busy share (``device_busy_share``) of ``calls`` ``plan()``
    calls at the scenario's start on built level programs (the obstacle
    window and the corridor are compiled by a call before)."""
    from commonroad_rp_tpu_torch.run_planner import load_config, make_planner

    config = load_config(name, HERE)
    if dtype is not None:
        config.debug.kernel_dtype = dtype
    planner = make_planner(config, device="cuda", graph=graph)
    planner.level_programs = programs[name]
    planner.set_desired_velocity(current_speed=planner.x_0.velocity)
    planner.plan()
    return device_busy_share(torch, lambda: [planner.plan()
                                             for _ in range(calls)])


def first_plans(torch, name, graph, dtype=None, configure=None, delta=2.0):
    """Two ``plan()`` calls at the scenario's start: at the desired speed,
    then at ``delta`` m/s above it.  Returns (per call: the plan's states,
    cost, counters, reasons, stored bundle, level programs built so far;
    the planner)."""
    from commonroad_rp_tpu_torch.run_planner import load_config, make_planner

    config = load_config(name, HERE)
    if dtype is not None:
        config.debug.kernel_dtype = dtype
    if configure is not None:
        configure(config)
    planner = make_planner(config, device="cuda", graph=graph)
    planner.set_desired_velocity(current_speed=planner.x_0.velocity)
    rows = []
    for step in range(2):
        if step:
            planner.set_desired_velocity(planner._desired_speed + delta,
                                         current_speed=planner.x_0.velocity)
        plan = planner.plan()
        bundle = planner.stored_trajectories
        rows.append((np.array([[s.position[0], s.position[1], s.velocity,
                                s.orientation, s.acceleration]
                               for s in plan[0].state_list]),
                     planner.optimal_cost,
                     (planner.infeasible_count_kinematics,
                      planner.infeasible_count_collision),
                     dict(planner.infeasible_reason_dict),
                     None if bundle is None else bundle_arrays(bundle),
                     len(planner.level_programs)))
    return rows, planner


def bundle_arrays(bundle):
    """A stored ``BundleSummary``'s arrays: x, y, costs and the labels."""
    return (bundle.x, bundle.y, bundle.costs, bundle.feasible,
            bundle.collides)


def replay_at_new_speed(torch, label, name, dtype=None, configure=None):
    """A replay at a changed desired speed equals the twin at that speed:
    the captured planner's second ``plan()`` (2 m/s above the first's
    speed) replays the programs the first built, and both calls equal the
    uncaptured twin's bit for bit; the speed moves the plan."""
    got, planner = first_plans(torch, name, True, dtype, configure)
    want, _ = first_plans(torch, name, False, dtype, configure)
    programs = list(planner.level_programs.values())
    replays = sum(p.replays for p in programs)
    check(all(p.graph for p in programs) and got[0][5] == got[1][5]
          and replays == sum(p.calls for p in programs) >= 2,
          f"{label}: the second plan() did not replay the first's programs")
    for g, w in zip(got, want):
        check(np.array_equal(g[0], w[0]) and g[1:4] == w[1:4],
              f"{label}: a replay differs from the twin")
        check((g[4] is None) == (w[4] is None) and all(
            np.array_equal(a, b) for a, b in zip(g[4] or (), w[4] or ())),
            f"{label}: a replay's stored bundle differs from the twin's")
    moved = not np.array_equal(got[0][0], got[1][0]) \
        or got[0][1] != got[1][1]
    check(moved, f"{label}: the desired speed did not move the plan")
    log(f"{label}: plan() at the desired speed and 2 m/s above it, "
        f"{len(programs)} captured program(s), {replays} replays: both "
        f"calls bit for bit the twin's (costs {got[0][1]:.6f} and "
        f"{got[1][1]:.6f})")


def synthetic_args(torch, n_steps, device):
    """A scene the bundled scenarios lack: OBB, disc and polygon obstacles
    on a curved 200 m reference path, candidates from the port's own
    sampling (levels 1..3 of the fixed-interval grid)."""
    from commonroad_rp_tpu_torch.models.sampling import FixedIntervalSampling
    from commonroad_rp_tpu_torch.ops import cycle as cycle_ops
    from commonroad_rp_tpu_torch.ops import frenet as frenet_ops
    from commonroad_rp_tpu_torch.ops.collision import (CorridorArrays,
                                                       ObstacleArrays)
    from commonroad_rp_tpu_torch.ops.kinematics import VehicleArrays
    from commonroad_rp_tpu_torch.utils.config import (
        ReactivePlannerConfiguration, VehicleConfiguration)

    f32 = torch.float32
    xs = np.linspace(0.0, 200.0, 400)
    ref = frenet_ops.from_polyline(
        np.stack([xs, 6.0 * np.sin(xs / 70.0)], axis=1), f32, device)
    P = ref.s.shape[0]
    corridor = CorridorArrays(d_lo=torch.full((P,), -4.0, dtype=f32,
                                              device=device),
                              d_hi=torch.full((P,), 4.0, dtype=f32,
                                              device=device))
    config = ReactivePlannerConfiguration()
    config.planning.time_steps_computation = n_steps
    space = FixedIntervalSampling(config)
    space.samples_v = type(space.samples_v)(11.0, 19.0, 4)
    x0_lon, x0_lat = np.array([40.0, 15.0, 0.2]), np.array([0.4, 0.05, 0.0])
    batches = [space.generate_trajectories_at_level(
        level, x0_lon, x0_lat, "velocity_keeping", False)
        for level in (1, 2, 3)]
    cat = lambda field, dtype: torch.as_tensor(
        np.concatenate([getattr(b, field) for b in batches]), dtype=dtype,
        device=device)
    T = n_steps + 1
    steps = np.arange(T)
    pose = np.zeros((2, T, 3))
    pose[0, :, :2] = [70.0, 4.5]                       # static OBB
    pose[1, :, 0] = 52.0 + 0.8 * steps                  # moving disc
    pose[1, :, 1] = 0.9
    valid = np.ones((2, T), bool)
    valid[1, :3] = False
    body = np.array([[-1.5, -1.0], [1.5, -1.2], [2.0, 0.4], [0.0, 1.5],
                     [-1.8, 0.6], [-1.8, 0.6]])
    verts = body[None, None] + np.stack(
        [58.0 + 0.5 * steps, 2.2 - 0.05 * steps], axis=1)[None, :, None, :]
    dev = lambda a, dtype=f32: torch.as_tensor(a, dtype=dtype, device=device)
    obstacles = ObstacleArrays(
        pose=dev(pose), half_ext=dev([[2.5, 1.0], [0.0, 0.0]]),
        valid=dev(valid, torch.bool), radius=dev([0.0, 1.2]),
        poly_verts=dev(verts), poly_valid=dev(np.ones((1, T), bool),
                                              torch.bool))
    vc = VehicleConfiguration()
    veh = VehicleArrays(*(float(np.float32(x)) for x in (
        vc.wheelbase, vc.wb_rear_axle, vc.a_max, vc.v_switch,
        np.tan(vc.delta_max) / vc.wheelbase, vc.v_delta_max,
        vc.length / 2, vc.width / 2)))
    args, kwargs = cycle_ops.scorer_arguments(
        cat("coeffs_lon", f32), cat("coeffs_lat", f32),
        cat("traj_len", torch.int32),
        torch.ones(sum(b.size for b in batches), dtype=torch.bool,
                   device=device),
        ref, veh, obstacles, corridor, 0.08,
        cycle_ops.CostParams(w_a=5.0, desired_d=0.0, desired_speed=15.0,
                             desired_s=0.0),
        dt=0.1, n_steps=n_steps, low_vel_mode=False,
        cost_structure=("default", True, False),
        constraint_flags=(True,) * 5)
    return args, kwargs


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", metavar="DIR", default=None,
                        help="also trace three plan() calls with "
                             "torch.profiler into DIR")
    opts = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    import commonroad_rp_tpu_torch
    from commonroad_rp_tpu_torch.ops import cycle as cycle_ops
    from commonroad_rp_tpu_torch.ops import scoring
    from commonroad_rp_tpu_torch.run_planner import load_config, make_planner

    pkg_root = pathlib.Path(commonroad_rp_tpu_torch.__file__).resolve()
    if pkg_root.parent.parent != HERE:
        raise RuntimeError(f"commonroad_rp_tpu_torch imported from "
                           f"{pkg_root}, not from this checkout {HERE}")
    logging_off()
    memoize_road_boundaries(torch)
    started = time.time()
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. environment
    smi = environment(torch)

    # ---- 2. build: both libraries at once, one nvcc each
    build_all()

    # ---- 3. kernel against the plain version on the card
    config = load_config("ZAM_Over-1_1", HERE)
    planner = make_planner(config, device="cuda")
    planner.set_desired_velocity(current_speed=planner.x_0.velocity)
    x0_lon, x0_lat = planner.begin_cycle()
    batches = [planner._create_trajectory_bundle(x0_lon, x0_lat, level)
               for level in range(1, planner.sampling_level)]
    inputs = planner.cycle_inputs(batches)
    n_levels = inputs.pop("n_levels")
    inputs.pop("level_ids")
    args_main, kw_main = cycle_ops.scorer_arguments(**inputs)
    shapes = {"main": (args_main, kw_main)}
    for n_steps in (20, 60):
        shapes[f"synthetic_T{n_steps + 1}"] = synthetic_args(torch, n_steps,
                                                             device)
    max_err = 0.0
    for label, (args, kw) in shapes.items():
        out_k = scoring.score_candidates(*args, **kw)
        out_p = scoring.score_candidates_reference(*args, **kw)
        torch.cuda.synchronize()
        max_err = max(max_err, compare(torch, label, out_k, out_p,
                                       in_domain(torch, args, kw["n_steps"])))
    log(f"main-path shape: K={args_main[0].shape[0]} "
        f"T={kw_main['n_steps'] + 1} table rows={args_main[4].shape[0]} "
        f"obstacles={args_main[5].pose.shape[0]} levels={n_levels}")

    # ---- 4. the main path on the card: each bundled scenario to its goal
    # through the captured plan(), bit for bit its uncaptured twin
    plan_ms = {True: [], False: []}
    first_ms = []
    programs = {True: {}, False: {}}
    launches = executions = None
    with program_calls() as calls:
        for name, want_steps in EXPECTED_STEPS.items():
            reset_launch_counts()
            got = plan_drive(torch, name)
            n_launch = scoring.score_candidates.launches
            planner, result, _ = got
            built = list(planner.level_programs.values())
            log(f"drive {name}: goal_reached={result['goal_reached']} steps="
                f"{result['steps']} plan() calls={result['plan_calls']} "
                f"built programs={len(built)} kernel launches={n_launch} "
                f"(the warm-ups' and the captured ones)")
            check(result["goal_reached"], f"{name} did not reach its goal")
            check(result["steps"] == want_steps,
                  f"{name}: expected {want_steps} steps, got "
                  f"{result['steps']}")
            check(all(p.graph and p.kind == "fast" for p in built)
                  and n_launch == 2 * len(built) > 0,
                  f"{name}: {n_launch} scorer launches for {len(built)} "
                  "captured fused programs")
            want = plan_drive(torch, name, graph=False)
            assert_drives_identical(f"drive {name}", got, want)
            programs[True][name] = planner.level_programs
            programs[False][name] = want[0].level_programs
            again = lambda: plan_drive(torch, name,
                                       programs=programs[True][name])
            n_exec, names = kernel_executions(torch, again, SCORE_KERNEL,
                                              result["plan_calls"],
                                              warm=False)
            check(n_exec == result["plan_calls"],
                  f"{name}: {n_exec} score_kernel executions for "
                  f"{result['plan_calls']} plan() calls ({names})")
            rows = reads_per_plan(torch, name, programs=programs[True][name])
            check(len(rows) == result["plan_calls"],
                  f"{name}: the warm drive made {len(rows)} plan() calls")
            check_reads(f"drive {name}", rows, per_call=1)
            log(f"drive {name}: captured == uncaptured bit for bit (states, "
                f"costs, counters, reasons); a warm drive: {n_exec} "
                f"score_kernel executions (profiler) for "
                f"{result['plan_calls']} plan() calls")
            if name == "ZAM_Over-1_1":
                launches, executions = n_launch, n_exec
            first_ms.append(1e3 * result["planning_times"][0])
            for graph, (_, res, _) in ((True, got), (False, want)):
                plan_ms[graph] += [1e3 * t for t in res["planning_times"][1:]]
    log_builds("main path", [c for c in calls if c[0].graph])
    replay_at_new_speed(torch, "main path replay at a new speed",
                        "ZAM_Over-1_1")

    # the first cycle's winner: card kernel against the CPU plain version
    first = {}
    for dev in ("cuda", "cpu"):
        planner = make_planner(load_config("ZAM_Over-1_1", HERE), device=dev)
        planner.set_desired_velocity(current_speed=planner.x_0.velocity)
        plan = planner.plan()
        first[dev] = (np.array([s.position for s in plan[0].state_list]),
                      np.array([s.velocity for s in plan[0].state_list]),
                      planner.optimal_cost,
                      (planner.infeasible_count_kinematics,
                       planner.infeasible_count_collision))
    np.testing.assert_allclose(first["cuda"][0], first["cpu"][0], atol=1e-4)
    np.testing.assert_allclose(first["cuda"][1], first["cpu"][1], atol=1e-4)
    np.testing.assert_allclose(first["cuda"][2], first["cpu"][2], rtol=2e-4)
    check(first["cuda"][3] == first["cpu"][3], "first-cycle counters differ")
    log(f"first cycle winner: card cost {first['cuda'][2]:.6f}, cpu plain "
        f"cost {first['cpu'][2]:.6f}; rejected (kinematic, colliding) "
        f"{first['cuda'][3]}; max |position diff| "
        f"{np.abs(first['cuda'][0] - first['cpu'][0]).max():.3e} m")

    # ---- 5. times
    timing = {}
    for label, (args, kw) in shapes.items():
        # operands prepared once: the times are the kernel's and the plain
        # version's alone, without the wrapper's input layout
        inp = scoring.prepare_inputs(*args, **kw)
        if label == "main":
            main_bound = scorer_bound(torch, inp)
        k_ms, p_ms = time_prepared(torch, inp, KERNEL_REPS, PLAIN_REPS)
        with uncounted():
            dev_ms = device_kernel_ms(
                torch, lambda: scoring.score_prepared(inp), "score_kernel")
        K = args[0].shape[0]
        timing[label] = (k_ms, p_ms, dev_ms)
        log(f"time {label}: K={K} T={kw['n_steps'] + 1} kernel "
            f"{k_ms:.4f} ms per call ({K / k_ms * 1e3:.6g} "
            f"candidate-evals/s; device time {dev_text(dev_ms)}), plain "
            f"{p_ms:.4f} ms")
    # plan() in both forms, in turns: phase 4's drives (captured, then the
    # twin) and one more round the other way on the built programs
    stages = {True: {}, False: {}}
    for graph in (False, True):
        for name in EXPECTED_STEPS:
            planner, result, _ = plan_drive(torch, name, graph=graph,
                                            programs=programs[graph][name])
            plan_ms[graph] += [1e3 * t for t in result["planning_times"][1:]]
            for stage, values in planner.stage_timers.history.items():
                stages[graph].setdefault(stage, []).extend(values[1:])
    for graph in (True, False):
        q = np.percentile(plan_ms[graph], [50, 90])
        log(f"plan() {'captured' if graph else 'uncaptured'}: p50 "
            f"{q[0]:.3f} ms, p90 {q[1]:.3f} ms over {len(plan_ms[graph])} "
            f"calls of the four drives, two rounds in turns (first call "
            f"of each drive excluded)")
    log(f"plan() first calls of phase 4's captured drives (build, warm-up "
        f"and capture): {', '.join(f'{x:.1f}' for x in first_ms)} ms")
    for graph in (True, False):
        log(f"plan() {'captured' if graph else 'uncaptured'} stages, p50 "
            f"over the second round (first call of each drive excluded): "
            + ", ".join(f"{stage} {1e3 * statistics.median(v):.3f} ms"
                        for stage, v in sorted(stages[graph].items())))
        log(f"plan() {'captured' if graph else 'uncaptured'}, ZAM_Over's "
            f"first cycle planned 20 times: device busy share "
            f"{plan_busy(torch, 'ZAM_Over-1_1', graph, programs[graph])}")

    if opts.profile:
        profile_plans(torch, opts.profile)

    results = {}
    for name, phase in (("fleet_k", phase_fleet_kernel),
                        ("scan", phase_plan_scan),
                        ("fleet1024", phase_fleet1024),
                        ("collision", phase_collision_kernel),
                        ("conformance", phase_conformance),
                        ("xla", lambda t: phase_xla_fleet(t, results[
                            "fleet1024"])),
                        ("nccl", phase_nccl_dryrun), ("probe", phase_probe),
                        ("capture", phase_capture),
                        ("resume", lambda t: phase_fleet_resume(t, results[
                            "fleet1024"])),
                        ("oracle", phase_oracle),
                        ("primitives", phase_primitives_native)):
        log(f"[{time.time() - started:.0f} s] phase {name}")
        results[name] = phase(torch)
    log(f"[{time.time() - started:.0f} s] phases done")
    fleet_k, scan, fleet1024, collision, conformance, xla, _, probe = \
        list(results.values())[:8]

    k_ms, p_ms, dev_ms = timing["main"]
    # ``device_ms``: the kernel's device time per call (profiler), beside
    # the per-call time of the Python launch path; ``executions``: the
    # kernel's executions in a traced call of a captured program (the
    # wrappers count the warm-up's launch and the captured one, not the
    # replays; the fleet collision kernel's from a 3-cycle fleet1024
    # rollout, ``executions_of_cycles``, its 150-cycle run untraced)
    entry = lambda name, source, replaces, launches, max_abs_err, ms, \
        plain_ms, bound, library_ms=None, **extra: {
            "name": name, "route": "cuda",
            "source": f"commonroad_rp_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches,
            "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": library_ms, **extra}
    log(smi)
    log(json.dumps({"kernels": [
        entry("score_candidates", "scoring.cu",
              "commonroad_rp_tpu/ops/pallas_cycle.py:490", launches,
              max_err, k_ms, p_ms, main_bound, device_ms=dev_ms,
              executions=executions),
        entry("score_candidates (plan_scan, T=61)", "scoring.cu",
              "commonroad_rp_tpu/ops/pallas_cycle.py:420",
              scan["launches61"], scan["max_err61"], scan["ms61"],
              scan["plain_ms61"], scan["bound61"], device_ms=scan["dev61"],
              executions=scan["executions61"]),
        entry("score_fleet", "scoring.cu",
              "commonroad_rp_tpu/ops/pallas_cycle.py:455",
              fleet1024["launches"],
              max(fleet_k["max_err"], fleet1024["max_err"]),
              fleet1024["ms"], fleet1024["plain_ms"], fleet1024["bound"],
              device_ms=fleet1024["dev_ms"],
              executions=fleet1024["executions"]),
        entry("lattice_candidates", "scoring.cu",
              "commonroad_rp_tpu/parallel/pallas_fleet.py:289",
              fleet1024["win"]["launches"], 0.0, fleet1024["win"]["ms"],
              fleet1024["win"]["plain_ms"], fleet1024["win"]["bound"],
              device_ms=fleet1024["win"]["dev_ms"],
              executions=fleet1024["win"]["executions"]),
        entry("obb_collision", "collision.cu",
              "commonroad_rp_tpu/ops/pallas_kernels.py:33",
              conformance["launches"], collision["max_err"],
              collision["ms"], collision["plain_ms"], collision["bound"],
              executions=conformance["executions"]),
        entry("obb_collision_fleet", "collision.cu",
              "commonroad_rp_tpu/ops/pallas_kernels.py:33",
              xla["launches"], 0.0, xla["ms"], xla["plain_ms"],
              (xla["bound_ms"], xla["bound_by"]), device_ms=xla["dev_ms"],
              executions=xla["executions"], executions_of_cycles=3),
        entry("dense_rollout", "dense_rollout.cu",
              "none: XLA's fusion of commonroad_rp_tpu/parallel/fleet.py "
              "_single_problem_cycle", xla["dense"]["launches"],
              xla["dense"]["readings"]["pose_gap"], xla["dense"]["ms"],
              xla["dense"]["plain_ms"], xla["dense"]["bound"],
              device_ms=xla["dense"]["dev_ms"],
              executions=xla["executions"], executions_of_cycles=3),
        entry("trivial_probe", "scoring.cu",
              "scripts/t61_overhead_probe.py:200", probe["launches"],
              probe["max_err"], probe["ms"], probe["plain_ms"],
              (probe["bound_ms"], probe["bound_by"]),
              probe["library_ms"], device_ms=probe["dev_ms"])]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def phase_fleet_kernel(torch):
    """6. The fleet kernel against its plain version: the 12-problem fleet's
    first cycle, then a 10-cycle scan through each."""
    from commonroad_rp_tpu_torch.ops import scoring
    from commonroad_rp_tpu_torch.run_fleet import heterogeneous_fleet, \
        make_scan

    scene, carry, _, _ = heterogeneous_fleet(12, 10, device="cuda",
                                             root=HERE)
    inp = captured_operands(
        lambda scorer: make_scan(scene, 1, scorer=scorer,
                                        graph=False)[0](carry))
    out_k = scoring.score_prepared(inp)
    out_p = scoring.score_prepared_reference(inp)
    torch.cuda.synchronize()
    max_err = compare(torch, "fleet F=12 first cycle", out_k, out_p,
                      prepared_in_domain(torch, inp))
    lattice_equals_loaded(torch, "fleet F=12 first cycle", inp, out_k)
    largest_table_scan(torch, scene, carry)
    max_err = max(max_err, compare_largest_table(
        torch, "fleet F=12 first cycle", inp, out_p))
    max_err = max(max_err, hostile_cases(torch))
    k_ms, p_ms = time_prepared(torch, inp, KERNEL_REPS, PLAIN_REPS)
    log(f"time fleet F=12: F x K={inp.tables.shape[0]}x{inp.grid.size} "
        f"T={inp.n_steps + 1} kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")

    run_k, _ = make_scan(scene, 10)
    run_p, _ = make_scan(scene, 10,
                         scorer=scoring.score_prepared_reference)
    scoring.score_fleet.launches = 0
    final_k, metrics_k = no_sync(torch, lambda: run_k(carry))
    n_launch = scoring.score_fleet.launches
    final_p, metrics_p = run_p(carry)
    check(n_launch == 2 and run_k.replays == 10,
          f"fleet scan: {n_launch} kernel launches (the warm-up's and the "
          f"captured one) and {run_k.replays} replays for 10 cycles")
    check(bool(torch.equal(metrics_k[0], metrics_p[0])),
          "fleet scan: alive flags differ between kernel and plain")
    worst = 0.0
    for name in ("x0_lon", "x0_lat", "orientation", "velocity", "px", "py"):
        a, b = getattr(final_k, name), getattr(final_p, name)
        worst = max(worst, float((a - b).abs().max()))
    for i in (2, 3, 8, 9):
        worst = max(worst, float((metrics_k[i] - metrics_p[i]).abs().max()))
    log(f"fleet scan F=12, 10 cycles: alive {int(metrics_k[0][-1].sum())}/12 "
        f"at the end, identical in both; max |state diff| kernel vs plain "
        f"{worst:.3e}")
    check(worst <= SCAN_ATOL, f"fleet scan states differ by {worst}")
    return dict(max_err=max_err, ms12=k_ms, plain_ms12=p_ms)


def largest_table_scan(torch, scene, carry, n_cycles=3):
    """The 12-problem fleet's scan with its tables padded to the most rows
    a scorer block's shared memory holds, captured against uncaptured, bit
    for bit, before any other launch at that size: the warm-up cycle must
    raise the fleet kernel's shared-memory limit (``cudaFuncSetAttribute``
    in ``csrc/scoring.cu::launch_scorer``) before the capture.  The padding
    changes no found flag."""
    from commonroad_rp_tpu_torch.ops import scoring
    from commonroad_rp_tpu_torch.run_fleet import make_scan

    n_rows = largest_table_rows(scene)
    M, T = scene.obs_pose.shape[1], 21
    nbytes = scoring.shared_bytes(n_rows + 1, M, T)
    natural = scoring.shared_bytes(scene.ref.s.shape[1] + 1, M, T)
    check(nbytes > max(natural, 48 * 1024),
          f"largest table: {nbytes} B of shared memory, not above the "
          f"scene's own {natural} B and 48 KB")
    padded = padded_fleet_scene(torch, scene, n_rows)
    label = f"fleet F=12 scan, tables padded to {n_rows} rows ({nbytes} B " \
        f"shared, the scene's own {natural} B)"
    got, _, counts = captured_and_twin(
        torch, label, make_scan(padded, n_cycles)[0],
        make_scan(padded, n_cycles, graph=False)[0], carry)
    check(counts == {"score_candidates": 0, "score_fleet": 2,
                     "lattice_candidates": 2},
          f"{label}: wrapper counts {counts}")
    _, metrics = make_scan(scene, n_cycles, graph=False)[0](carry)
    check(bool(torch.equal(got[1][0], metrics[0])),
          f"{label}: found flags differ from the unpadded scan's")


def hostile_cases(torch, seeds=(0, 1, 2)):
    """The fleet kernel against its plain version on the hostile operands of
    ``probes.hostile_inputs`` (the search's edge cases, the early exits');
    returns max |cost error|."""
    from commonroad_rp_tpu_torch.ops import scoring
    from commonroad_rp_tpu_torch.probes import hostile_inputs

    max_err = 0.0
    for seed in seeds:
        case = hostile_inputs.hostile_fleet(seed)
        args, kwargs = hostile_inputs.score_fleet_arguments(
            case, lambda a: torch.as_tensor(a, device="cuda"))
        inp = scoring.prepare_fleet_inputs(*args, **kwargs)
        with uncounted():
            out_k = scoring.score_prepared(inp)
            out_p = scoring.score_prepared_reference(inp)
            torch.cuda.synchronize()
        nan_group = torch.as_tensor(
            case["group"] == hostile_inputs.GROUPS.index("nan"),
            device="cuda")
        check(all(bool(torch.isinf(row[nan_group]).all())
                  for out in (out_k, out_p) for row in out[:2]),
              "hostile: a candidate with a NaN coefficient has a cost")
        label = f"hostile operands, seed {seed}"
        max_err = max(max_err, compare(torch, label, out_k, out_p,
                                       prepared_in_domain(torch, inp)))
        reasons = int((out_k[2] != out_p[2]).sum())
        log(f"{label}: reason codes differing anywhere (in or out of the "
            f"domain): {reasons}")
    return max_err


def certify_drive(label, planner, failing=()):
    """The physics certificate (``utils.evaluation.certify_drive``) of a
    drive's recorded states: raises unless start, goal, collision,
    road-boundary compliance and the open-loop drift hold and the
    transitions that fail the KS reconstruction are exactly ``failing``
    (none but the T-junction's divergence 7).  Returns the certificate."""
    from commonroad_rp_tpu_torch.utils import evaluation as ev

    cert = ev.certify_drive(planner.config, planner.record_state_list)
    n = len(cert["transitions"])
    log(f"{label}: certificate start={cert['start']} goal={cert['goal']} "
        f"collision_free={cert['collision_free']} boundary_ok="
        f"{cert['boundary_ok']}, {n - len(cert['failing'])}/{n} transitions "
        f"KS-feasible (failing {cert['failing']}, expected {list(failing)}), "
        f"open-loop drift {cert['drift']:.4f} m (bound "
        f"{cert['drift_bound']:.2f})")
    check(cert["certified"], f"{label}: the certificate failed: {cert}")
    check(cert["failing"] == list(failing), f"{label}: transitions "
          f"{cert['failing']} fail the KS reconstruction, expected "
          f"{list(failing)}")
    return cert


def phase_plan_scan(torch):
    """7. plan_scan on the card, captured: each scenario's scan bit for bit
    its uncaptured twin with one ``score_kernel`` execution per cycle, then
    the scenario to its goal through ``plan_scan`` (which replays the
    cached captured program); the single-problem scan; ZAM_Over at T=61
    captured against uncaptured and through the kernel against the plain
    version; ms/cycle and busy share of both forms at T=21 and T=61, the
    capture's time and its graph pool."""
    from commonroad_rp_tpu_torch.ops import scoring
    from commonroad_rp_tpu_torch.probes import divergence7
    from commonroad_rp_tpu_torch.run_planner import load_config, make_planner

    moved = {}
    for name, cycles in EXPECTED_CYCLES.items():
        planner = make_planner(load_config(name, HERE), device="cuda")
        planner.set_desired_velocity(current_speed=planner.x_0.velocity)
        ds = float(planner._desired_speed)
        run, carry = planner.scan_program(cycles)
        twin, _ = planner.scan_program(cycles, graph=False)
        got, _, counts = captured_and_twin(torch, f"plan_scan {name}", run,
                                           twin, carry, ds)
        check(counts == {"score_candidates": 2, "score_fleet": 0,
                         "lattice_candidates": 0},
              f"plan_scan {name}: wrapper counts {counts}")
        # the desired speed is read from device memory, not frozen in the
        # graph: a replay at another speed equals the twin at that speed
        other = no_sync(torch, lambda: run(carry, ds + 2.0))
        assert_bit_identical(torch, f"plan_scan {name} at {ds + 2.0} m/s",
                             other, twin(carry, ds + 2.0))
        moved[name] = (other[1][4].cpu().numpy().tobytes()
                       != got[1][4].cpu().numpy().tobytes())
        log(f"plan_scan {name}: a replay at {ds + 2.0} m/s (captured at "
            f"{ds} m/s) == uncaptured at {ds + 2.0} m/s bit for bit; the "
            f"recorded states {'differ from' if moved[name] else 'equal'} "
            f"those at {ds} m/s")
        executions, names = kernel_executions(
            torch, lambda: run(carry, ds), SCORE_KERNEL, cycles)
        check(executions == cycles, f"plan_scan {name}: {executions} "
              f"score_kernel executions for {cycles} cycles ({names})")
        replays = run.replays
        planner.record_state_and_input(planner.x_0)
        info = planner.plan_scan(cycles)
        log(f"plan_scan {name}: goal_reached={info['goal_reached']} "
            f"steps={info['steps']} cycles_run={info['cycles_run']}, "
            f"{executions} score_kernel executions in a traced call "
            f"(profiler), {run.replays - replays} replays of the captured "
            f"cycle ({info['wall_time'] * 1e3:.1f} ms)")
        check(info["goal_reached"], f"plan_scan {name}: goal not reached")
        check(info["steps"] == EXPECTED_STEPS[name],
              f"plan_scan {name}: {info['steps']} steps, expected "
              f"{EXPECTED_STEPS[name]}")
        check(run.replays - replays == info["cycles_run"] == cycles,
              f"plan_scan {name}: not the captured program's replays")
        certify_drive(f"plan_scan {name}", planner,
                      divergence7.TJUNCTION_FAILING
                      if name == divergence7.TJUNCTION else ())

    check(any(moved.values()), "plan_scan: no scenario's states moved with "
          "the desired speed, so the replays at another speed show nothing")
    run, carry = single_problem_scan(torch, 12, "cuda")
    twin, _ = single_problem_scan(torch, 12, "cuda", graph=False)
    captured_and_twin(torch, "single-problem scan ZAM_Over", run, twin,
                      carry)

    def t61_planner():
        config = load_config("ZAM_Over-1_1", HERE)
        config.planning.time_steps_computation = 60
        planner = make_planner(config, device="cuda")
        planner.set_desired_velocity(current_speed=planner.x_0.velocity)
        return planner

    n61 = 12
    planner = t61_planner()
    ds = float(planner._desired_speed)
    run_k, carry = planner.scan_program(n61)
    twin, _ = planner.scan_program(n61, graph=False)
    (_, metrics_k), _, _ = captured_and_twin(
        torch, "plan_scan T=61 ZAM_Over", run_k, twin, carry, ds)
    run_p, _ = planner.scan_program(
        n61, scorer=scoring.score_prepared_reference)
    _, metrics_p = run_p(carry, ds)
    found_k, found_p = metrics_k[0].cpu(), metrics_p[0].cpu()
    diff = float((metrics_k[4] - metrics_p[4]).abs().max())
    log(f"plan_scan T=61 ZAM_Over, {n61} cycles: found "
        f"{int(found_k.sum())}/{n61} (kernel) {int(found_p.sum())}/{n61} "
        f"(plain); max |state diff| {diff:.3e}")
    check(bool(torch.equal(found_k, found_p)) and bool(found_k.all()),
          "plan_scan T=61: found flags differ or a cycle failed")
    check(diff <= SCAN61_ATOL, f"plan_scan T=61: states differ by {diff}")

    inp61 = captured_operands(
        lambda scorer: t61_planner().scan_program(
            1, scorer=scorer, graph=False)[0](carry, ds))
    out_k = scoring.score_prepared(inp61)
    out_p = scoring.score_prepared_reference(inp61)
    torch.cuda.synchronize()
    max_err61 = compare(torch, "plan_scan T=61 union", out_k, out_p,
                        prepared_in_domain(torch, inp61))
    ms61, plain_ms61 = time_prepared(torch, inp61, KERNEL_REPS, PLAIN_REPS)
    with uncounted():
        dev61 = device_kernel_ms(torch, lambda: scoring.score_prepared(inp61),
                                 "score_kernel")
    bound61 = scorer_bound(torch, inp61)
    log(f"time plan_scan T=61 union: K={inp61.coeffs_lon.shape[0]} kernel "
        f"{ms61:.4f} ms per call (device time {dev_text(dev61)}), plain "
        f"{plain_ms61:.4f} ms")

    planner = t61_planner()
    run61, carry61 = planner.scan_program(n61)
    planner.record_state_and_input(planner.x_0)
    reset_launch_counts()
    info = planner.plan_scan(n61)
    launches61 = scoring.score_candidates.launches
    executions61, names = kernel_executions(
        torch, lambda: run61(carry61, ds), SCORE_KERNEL, n61)
    log(f"plan_scan T=61 drive: goal_reached={info['goal_reached']} "
        f"steps={info['steps']} cycles_run={info['cycles_run']}, wrapper "
        f"launches {launches61} (warm-up and capture), {run61.replays} "
        f"replays, {executions61} score_kernel executions in a traced call")
    check(launches61 == 2 and executions61 == n61
          and run61.replays >= n61 and info["cycles_run"] == n61,
          f"plan_scan T=61: {launches61} launches, {executions61} "
          f"executions for {n61} cycles ({names})")

    forms = {}
    for label, make in (("T=21", lambda: make_planner(
            load_config("ZAM_Over-1_1", HERE), device="cuda")),
            ("T=61", t61_planner)):
        planner = make()
        planner.set_desired_velocity(current_speed=planner.x_0.velocity)
        ds = float(planner._desired_speed)
        run, carry = planner.scan_program(12)
        twin, _ = planner.scan_program(12, graph=False)
        forms[label] = scan_forms_timed(torch, f"plan_scan {label} ZAM_Over",
                                        {"captured": run,
                                         "uncaptured": twin},
                                        lambda fn: fn(carry, ds), 12)
        planner.plan_scan(12, record=False)
        times = []
        for _ in range(5):
            t0 = time.time()
            planner.plan_scan(12, record=False)
            times.append(time.time() - t0)
        log(f"plan_scan ms/cycle {label} ZAM_Over (captured, 12 cycles per "
            f"call, warm, median of 5, host clock incl. readback and the "
            f"host's state reconstruction): "
            f"{statistics.median(times) / 12 * 1e3:.3f} "
            f"(min {min(times) / 12 * 1e3:.3f})")
    return dict(launches61=launches61, executions61=executions61,
                max_err61=max_err61, ms61=ms61, dev61=dev61,
                plain_ms61=plain_ms61, bound61=bound61, forms=forms)


def scan_forms_timed(torch, label, forms, call, n_cycles, rounds=3):
    """Warm wall time per cycle (host clock around a call and a
    synchronize; each form once per turn, the order alternating) and the
    device busy share of each form of a scan; logs them.  Returns {form:
    (median ms/cycle, busy share text)}."""
    for fn in forms.values():
        call(fn)
    torch.cuda.synchronize()
    walls = {form: [] for form in forms}
    order = list(forms)
    for r in range(2 * rounds):
        for form in (order if r % 2 == 0 else order[::-1]):
            t0 = time.time()
            call(forms[form])
            torch.cuda.synchronize()
            walls[form].append(time.time() - t0)
    out = {}
    for form, fn in forms.items():
        ms = [w / n_cycles * 1e3 for w in walls[form]]
        busy = device_busy_share(torch, lambda: call(fn))
        out[form] = (statistics.median(ms), busy)
        log(f"{label} {form}: {statistics.median(ms):.3f} ms/cycle (median "
            f"of {len(ms)} warm calls of {n_cycles} cycles in turns, min "
            f"{min(ms):.3f}, host clock and synchronize); device busy share "
            f"{busy}")
    return out


def dev_text(ms):
    return "not measured" if ms is None else f"{ms:.4f} ms"


def candidate_fates(torch, inp, plain_out, chunk: int = 128):
    """{fate: count} over all candidates of fleet operands, from the plain
    version's rows and the prefilter's two derivatives, and the share of
    warps (32 neighbours in K) whose candidates all share one fate."""
    from commonroad_rp_tpu_torch.ops import scoring

    masked, kin, reason = plain_out
    cl, sc = inp.coeffs_lon, inp.scalars
    T = inp.n_steps + 1
    step = torch.arange(T, dtype=torch.float32, device=cl.device)
    pre = []
    for f0 in range(0, cl.shape[0], chunk):
        c = cl[f0:f0 + chunk, :, None, :]
        tau = (step[None, None] * sc[f0:f0 + chunk, scoring._S_DT,
                                     None, None])
        tau2 = tau * tau
        s_dot = (c[..., 1] + 2.0 * c[..., 2] * tau + 3.0 * c[..., 3] * tau2
                 + 4.0 * c[..., 4] * (tau2 * tau)
                 + 5.0 * c[..., 5] * (tau2 * tau2))
        s_ddot = (2.0 * c[..., 2] + 6.0 * c[..., 3] * tau
                  + 12.0 * c[..., 4] * tau2 + 20.0 * c[..., 5] * (tau2 * tau))
        active = step[None, None] < inp.traj_len[f0:f0 + chunk, :, None]
        a_max = sc[f0:f0 + chunk, scoring._S_A_MAX, None, None]
        pre.append(torch.any(active & ((torch.abs(s_ddot) > a_max)
                                       | (s_dot < -1e-5)), dim=-1))
    pre = torch.cat(pre)
    fate = torch.full(reason.shape, 4, dtype=torch.int64,
                      device=reason.device)            # selectable
    fate[torch.isinf(masked)] = 3                       # colliding
    fate[torch.isinf(kin)] = 2                          # domain or goal
    fate[(reason >= 0) & (reason <= 4)] = 1             # first violation
    fate[pre] = 0
    names = ("prefiltered", "first violation", "out of domain or goal",
             "colliding", "selectable")
    counts = {name: int((fate == i).sum()) for i, name in enumerate(names)}
    F, K = fate.shape
    full = fate[:, :K // 32 * 32].reshape(F, K // 32, 32)
    uniform = (full == full[..., :1]).all(dim=-1)
    dead = (full <= 1).all(dim=-1)
    return counts, float(uniform.float().mean()), float(dead.float().mean())


def phase_fleet1024(torch):
    """8. The 1024-problem heterogeneous fleet at full width: the captured
    scan bit for bit its uncaptured twin (carry, metrics, member outcomes)
    with one fleet-kernel execution per cycle and the JAX package's goal
    counts; both forms' ms/cycle and busy share; the fleet kernel against
    its plain version on the first cycle and their times."""
    from commonroad_rp_tpu_torch.ops import scoring
    from commonroad_rp_tpu_torch.run_fleet import (goal_counts,
                                                   heterogeneous_fleet,
                                                   make_scan,
                                                   member_outcomes,
                                                   winner_trace)

    F, cycles = 1024, 150
    t0 = time.time()
    scene, carry, goals, base_idx = heterogeneous_fleet(F, cycles,
                                                        device="cuda",
                                                        root=HERE)
    run, K = make_scan(scene, cycles)
    twin, _ = make_scan(scene, cycles, graph=False)
    log(f"fleet{F}: built in {time.time() - t0:.1f} s, K={K}, "
        f"{F * K} candidates per cycle")

    got, want, launches = captured_and_twin(torch, f"fleet{F}", run, twin,
                                            carry)
    metrics = got[1]
    check(launches == {"score_candidates": 0, "score_fleet": 2,
                       "lattice_candidates": 2},
          f"fleet1024: wrapper counts {launches}")
    executions, names = kernel_executions(torch, lambda: run(carry),
                                          FLEET_SCORE_KERNEL, cycles)
    check(executions == cycles, f"fleet1024: {executions} fleet-kernel "
          f"executions for {cycles} cycles ({names})")
    win_executions, names = kernel_executions(
        torch, lambda: run(carry), "lattice_candidates_kernel", cycles)
    check(win_executions == cycles, f"fleet1024: {win_executions} "
          f"lattice_candidates_kernel executions for {cycles} cycles "
          f"({names})")
    forms = scan_forms_timed(torch, f"fleet{F} ({cycles} cycles)",
                             {"captured": run, "uncaptured": twin},
                             lambda fn: fn(carry), cycles, rounds=2)
    for form, (ms, _) in forms.items():
        log(f"fleet{F} {form}: {F * K / ms * 1e3:.6g} candidate-evals/s")
    outcomes = member_outcomes(metrics, goals, base_idx)
    check(outcomes == member_outcomes(want[1], goals, base_idx),
          "fleet1024: member outcomes differ between the forms")
    counts = goal_counts(metrics, goals, base_idx, outcomes=outcomes)
    for name, c in counts.items():
        text = f"{c['reached']}/{c['total']}" + "".join(
            f" ({n} {kind})" for kind, n in c["misses"].items())
        log(f"fleet1024 {name}: {text} reached, captured and uncaptured "
            f"(JAX package on the TPU: {JAX_FLEET1024[name]})")
        check(text == JAX_FLEET1024[name],
              f"fleet1024 {name}: {text}, the JAX package "
              f"{JAX_FLEET1024[name]}")
    log(f"fleet1024: {executions} fleet-kernel executions in a traced "
        f"call, member outcomes identical in both forms")

    inp = captured_operands(
        lambda scorer: make_scan(scene, 1, scorer=scorer,
                                 graph=False)[0](carry))
    out_k = scoring.score_prepared(inp)
    out_p = scoring.score_prepared_reference(inp)
    torch.cuda.synchronize()
    max_err = compare(torch, "fleet1024 first cycle", out_k, out_p,
                      prepared_in_domain(torch, inp))
    loaded = lattice_equals_loaded(torch, "fleet1024 first cycle", inp, out_k)
    fates, one_fate, dead = candidate_fates(torch, loaded, out_p)
    log("fleet1024 first cycle, how candidates end: "
        + ", ".join(f"{name} {n} ({n / (F * K):.3f})"
                    for name, n in fates.items())
        + f"; warps (32 neighbours in K) of one fate {one_fate:.3f}, "
        f"prefiltered or violating throughout {dead:.3f}")
    del out_p
    ms, plain_ms = time_prepared(torch, inp, 20, 3)
    best = torch.argmin(out_k[0], dim=1)[:, None]
    every = torch.arange(K, device=best.device).repeat(F, 1)
    win = lambda: scoring.lattice_candidates(inp, best)
    win_plain = lambda: scoring.lattice_candidates_reference(inp, best)
    with uncounted():
        for name, index in (("the winners", best), ("every candidate", every)):
            got = scoring.lattice_candidates(inp, index)
            want = scoring.lattice_candidates_reference(inp, index)
            same = all(bool(torch.equal(a.view(torch.int32),
                                        b.view(torch.int32)))
                       for a, b in zip(got, want))
            log(f"fleet1024 first cycle, lattice_candidates at {name} "
                f"({tuple(index.shape)}) against its plain version: bit for "
                f"bit {same}")
            check(same, f"fleet1024: lattice_candidates at {name} differs "
                  "from its plain version")
        del got, want, every
        dev_ms = device_kernel_ms(torch, lambda: scoring.score_prepared(inp),
                                  "fleet_score_kernel")
        loaded_ms = cuda_time_ms(
            torch, lambda: scoring.score_prepared(loaded), 20)
        loaded_dev_ms = device_kernel_ms(
            torch, lambda: scoring.score_prepared(loaded),
            "fleet_score_kernel")
        win_ms = cuda_time_ms(torch, win, 200)
        win_dev_ms = device_kernel_ms(torch, win, "lattice_candidates_kernel")
    win_plain_ms = cuda_time_ms(torch, win_plain, 20)
    bound = scorer_bound(torch, inp)
    win_bound = lattice_candidates_bound(torch, inp, best)
    log(f"time fleet F=1024: kernel {ms:.4f} ms per call (device time "
        f"{dev_text(dev_ms)}; {F * K / ms * 1e3:.6g} candidate-evals/s), "
        f"plain {plain_ms:.4f} ms; the candidates loaded {loaded_ms:.4f} ms "
        f"(device {dev_text(loaded_dev_ms)}); the winners' coefficients "
        f"(lattice_candidates, F x 1) {win_ms:.4f} ms (device "
        f"{dev_text(win_dev_ms)}), plain {win_plain_ms:.4f} ms, bound "
        f"{win_bound[0]:.3g} ms ({win_bound[1]})")
    return dict(launches=launches["score_fleet"], executions=executions,
                win=dict(launches=launches["lattice_candidates"],
                         executions=win_executions, ms=win_ms,
                         dev_ms=win_dev_ms, plain_ms=win_plain_ms,
                         bound=win_bound),
                max_err=max_err, ms=ms,
                dev_ms=dev_ms, plain_ms=plain_ms, bound=bound,
                outcomes=outcomes, trace=winner_trace(metrics),
                cost=metrics[1].cpu().numpy(),
                fleet=(scene, carry, goals, base_idx))


def collision_scene(torch, n_steps, dtype, device):
    """Synthetic operands of the collision kernel: K smooth ego paths on a
    two-lane road (step-major OBB centers and headings) against 10 obstacle
    rows -- 6 boxes, static and moving, and 4 discs, two rows without
    occupancy over part of the horizon -- padded to 16 rows with invalid
    ones (``pad_obstacles``)."""
    from commonroad_rp_tpu_torch.ops.collision import (ObstacleArrays,
                                                       pad_obstacles)
    from commonroad_rp_tpu_torch.utils.config import VehicleConfiguration

    rng = np.random.default_rng(0)
    K, T = 3414, n_steps + 1
    t = np.arange(T)[:, None] * 0.1
    v = rng.uniform(5.0, 20.0, K)
    lateral = rng.uniform(-1.0, 1.0, K)
    cx = 10.0 + v[None] * t
    cy = rng.uniform(-4.0, 4.0, K)[None] + lateral[None] * t
    theta = np.broadcast_to(np.arctan2(lateral, v)[None], (T, K))
    M = 10
    pose = np.zeros((M, T, 3))
    pose[..., 0] = rng.uniform(20.0, 120.0, M)[:, None] \
        + rng.uniform(0.0, 8.0, M)[:, None] * t[None, :, 0]
    pose[..., 1] = rng.uniform(-4.0, 4.0, M)[:, None]
    pose[..., 2] = rng.uniform(-0.4, 0.4, M)[:, None]
    half = np.tile([[2.2, 0.9]], (M, 1))
    radius = np.zeros(M)
    half[6:] = 0.0
    radius[6:] = rng.uniform(0.5, 1.5, M - 6)
    valid = np.ones((M, T), bool)
    valid[3, :T // 3] = False
    valid[7, T // 2:] = False
    dev = lambda a, dt=dtype: torch.as_tensor(np.ascontiguousarray(a),
                                              dtype=dt, device=device)
    obstacles = pad_obstacles(ObstacleArrays(
        pose=dev(pose), half_ext=dev(half), valid=dev(valid, torch.bool),
        radius=dev(radius)), 16)
    vc = VehicleConfiguration()
    return (dev(cx), dev(cy), dev(theta), obstacles, vc.length / 2,
            vc.width / 2)


def level_collision_operands(torch, name, dtype_name):
    """The collision kernel's operands of every sampling level of a
    scenario's first cycle on the conformance path (``fast_scoring: False``,
    ``kernel_dtype`` ``dtype_name``), captured from ``plan(level)`` calls
    on the card through the uncaptured level programs (a captured one
    would call the pass at its warm-up and at its capture, the latter on
    operands not yet computed)."""
    from commonroad_rp_tpu_torch.ops import collision as collision_ops
    from commonroad_rp_tpu_torch.ops import collision_kernel
    from commonroad_rp_tpu_torch.run_planner import load_config, make_planner

    config = load_config(name, HERE)
    config.debug.fast_scoring = False
    config.debug.kernel_dtype = dtype_name
    planner = make_planner(config, device="cuda", graph=False)
    planner.set_desired_velocity(current_speed=planner.x_0.velocity)
    captured = []

    def capture(*operands):
        captured.append(operands)
        return collision_kernel.obb_collision_reference(*operands)

    collision_ops.obb_collision = capture
    try:
        for level in range(1, planner.sampling_level):
            planner.plan(current_sampling_level=level)
    finally:
        collision_ops.obb_collision = collision_kernel.obb_collision
    return captured


def sat_margins(torch, cx, cy, theta, obstacles, ehl, ehw):
    """[K] float64: each candidate's tightest margin over its valid (step,
    obstacle) pairs -- |min over the four axes of (projection radius sum -
    center distance)| on box rows, |r - distance to the ego box| on disc
    rows.  Only a verdict within that margin can flip between two
    roundings of the same arithmetic."""
    f = lambda x: x.to(torch.float64)
    e_cos, e_sin = torch.cos(f(theta))[:, None], torch.sin(f(theta))[:, None]
    pose = f(obstacles.pose)
    dx = pose[..., 0].T[:, :, None] - f(cx)[:, None]
    dy = pose[..., 1].T[:, :, None] - f(cy)[:, None]
    o_cos = torch.cos(pose[..., 2]).T[:, :, None]
    o_sin = torch.sin(pose[..., 2]).T[:, :, None]
    ohl = f(obstacles.half_ext[:, 0])[None, :, None]
    ohw = f(obstacles.half_ext[:, 1])[None, :, None]
    rel_cos = torch.abs(e_cos * o_cos + e_sin * o_sin)
    rel_sin = torch.abs(o_sin * e_cos - o_cos * e_sin)
    lx = torch.abs(dx * e_cos + dy * e_sin)
    ly = torch.abs(-dx * e_sin + dy * e_cos)
    margin = torch.minimum(
        torch.minimum(ehl + ohl * rel_cos + ohw * rel_sin - lx,
                      ehw + ohl * rel_sin + ohw * rel_cos - ly),
        torch.minimum(ohl + ehl * rel_cos + ehw * rel_sin
                      - torch.abs(dx * o_cos + dy * o_sin),
                      ohw + ehl * rel_sin + ehw * rel_cos
                      - torch.abs(-dx * o_sin + dy * o_cos)))
    if obstacles.radius is not None:
        r = f(obstacles.radius)[None, :, None]
        gap = torch.sqrt(torch.clamp(lx - ehl, min=0.0) ** 2
                         + torch.clamp(ly - ehw, min=0.0) ** 2)
        margin = torch.where(r > 0, r - gap, margin)
    margin = torch.where(obstacles.valid.T[:, :, None], torch.abs(margin),
                         torch.full_like(margin, np.inf))
    return torch.amin(margin.reshape(-1, margin.shape[-1]), dim=0)


def collision_cases(torch, dtype, device, seeds=(0, 1), F=2):
    """Fleet-form collision operands in ``dtype`` on ``device``: the hostile
    cases of ``probes.hostile_collision`` (one problem per hostile ego
    extent; skip boundaries, touching boxes and discs, invalid rows, NaN,
    inf, huge and subnormal poses) and its near-touching scene (F problems,
    K=2754, T=21, every candidate-step within a few ulps of touching)."""
    from commonroad_rp_tpu_torch.probes import hostile_collision as hc

    nd = np.float32 if dtype == torch.float32 else np.float64
    tensor = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                       device=device)
    flag = lambda a: torch.as_tensor(a, device=device)
    cases = {f"hostile {seed}": hc.fleet_operands(
        hc.hostile_collision(seed, nd), tensor, flag) for seed in seeds}
    cases["near-touching"] = hc.fleet_operands(
        hc.near_touching_collision(0, nd, F=F, K=2754, T=21), tensor, flag)
    return cases


def traced_kernels(torch, fn, reps=10, attempts=3):
    """(device kernel launches traced, their distinct names) over ``reps``
    warm calls of ``fn`` under ``torch.profiler``.  The profiler drops
    events now and then, so the count is at most the launches made; a trace
    without any device event is taken again, up to ``attempts`` times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = [evt for evt in prof.key_averages()
                   if evt.device_type == DeviceType.CUDA]
        if kernels:
            break
    return (sum(evt.count for evt in kernels),
            sorted({evt.key for evt in kernels}))


def check_one_kernel_per_call(torch, label, fn, kernel, reps=10):
    """Raises unless every device kernel traced over ``reps`` calls of
    ``fn`` is ``kernel`` and no more of them than calls were traced: with
    the wrapper's launch count (one per call), one kernel per call."""
    count, names = traced_kernels(torch, fn, reps)
    log(f"{label}: {count} device kernels traced over {reps} calls, all "
        f"{kernel}: {names}")
    check(len(names) == 1 and kernel in names[0] and 0 < count <= reps,
          f"{label}: device kernels {names}, {count} over {reps} calls")


def compare_collision_case(torch, label, ops):
    """Both collision kernels against their plain versions on fleet-form
    operands, in their dtype, over the horizon and each step alone (past a
    candidate's first hit the horizon's mask sees nothing): the fleet form
    on all problems, the single-problem form on each problem.  Raises unless
    0 candidates differ; launches not counted."""
    from commonroad_rp_tpu_torch.ops import collision_kernel as ck
    from commonroad_rp_tpu_torch.probes.hostile_collision import \
        problem_operands

    counted = (ck.obb_collision.launches, ck.obb_collision_fleet.launches)
    cx, cy, theta, obstacles, ehl, ehw = ops
    F, T, K = cx.shape
    variants = [ops]
    for t in range(T):
        at = lambda a: a[:, t:t + 1].contiguous()
        variants.append((at(cx), at(cy), at(theta), type(obstacles)(
            pose=obstacles.pose[:, :, t:t + 1].contiguous(),
            half_ext=obstacles.half_ext,
            valid=obstacles.valid[:, :, t:t + 1].contiguous(),
            radius=obstacles.radius), ehl, ehw))
    differ = hits = 0
    for v_ops in variants:
        want = ck.obb_collision_fleet_reference(*v_ops)
        differ += int((ck.obb_collision_fleet(*v_ops) != want).sum())
        hits += int(want.sum())
        for f in range(F):
            one = problem_operands(v_ops, f)
            differ += int((ck.obb_collision(*one)
                           != ck.obb_collision_reference(*one)).sum())
    torch.cuda.synchronize()
    ck.obb_collision.launches, ck.obb_collision_fleet.launches = counted
    log(f"collision {label}: F={F} T={T} K={K} M={obstacles.pose.shape[1]}"
        f", the horizon and each step alone, both forms: hits={hits} "
        f"differing candidates={differ}")
    check(differ == 0, f"collision {label}: the kernels and their plain "
          f"versions differ on {differ} candidates")


def compare_largest_rows(torch, label, ops, F=2, K=512):
    """Both collision kernels on ``ops`` (first F problems, K candidates)
    with their rows padded, by copies of the real rows 1 km further on, to
    the most a block stages (``collision_kernel.max_rows``, far above the
    48 KB a kernel gets unasked) against their plain versions, 0 differing
    candidates; one row more must raise ``ValueError`` in both forms."""
    from commonroad_rp_tpu_torch.ops import collision_kernel as ck
    from commonroad_rp_tpu_torch.probes.hostile_collision import \
        problem_operands

    cx, cy, theta, obstacles, ehl, ehw = map_collision_ops(
        ops, lambda a: a[:F].contiguous())
    cx, cy, theta = (a[..., :K].contiguous() for a in (cx, cy, theta))
    T, M0 = cx.shape[1], obstacles.pose.shape[1]
    most = ck.max_rows(T, cx.dtype)
    copies = -(-(most + 1) // M0)
    shift = torch.zeros(3, dtype=cx.dtype, device=cx.device)
    shift[0] = 1000.0
    pose = torch.cat([obstacles.pose + c * shift for c in range(copies)], 1)
    rep = lambda a, n: None if a is None else \
        torch.cat([a] * copies, 1)[:, :n].contiguous()
    rows = lambda n: type(obstacles)(
        pose=pose[:, :n].contiguous(), half_ext=rep(obstacles.half_ext, n),
        valid=rep(obstacles.valid, n), radius=rep(obstacles.radius, n))
    compare_collision_case(torch, f"{label}, rows padded to {most} "
                           f"({ck.shared_bytes(most, T, cx.dtype)} B shared)",
                           (cx, cy, theta, rows(most), ehl, ehw))
    for call in (lambda: ck.obb_collision_fleet(cx, cy, theta,
                                                rows(most + 1), ehl, ehw),
                 lambda: ck.obb_collision(*problem_operands(
                     (cx, cy, theta, rows(most + 1), ehl, ehw), 0))):
        try:
            call()
        except ValueError as exc:
            check("bytes of shared memory per block" in str(exc), str(exc))
        else:
            raise AssertionError(f"{label}: {most + 1} rows did not raise")


def phase_collision_kernel(torch):
    """9. The collision kernel against its plain version, float32 and
    float64: synthetic scenes at T=21 and T=61, then every sampling level of
    the four scenarios' first cycles, then the hostile and near-touching
    operands (both forms) and the most rows a block stages; one kernel per
    call; times at the level shapes of ZAM_Over and ZAM_Tjunction."""
    from commonroad_rp_tpu_torch.ops import collision_kernel as ck

    counted = ck.obb_collision.launches
    max_err = 0.0
    cases = {}
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[-1]
        for n_steps in (20, 60):
            cases[f"synthetic T={n_steps + 1} {dname}"] = collision_scene(
                torch, n_steps, dtype, "cuda")
        for name in EXPECTED_STEPS:
            for level, ops in enumerate(
                    level_collision_operands(torch, name, dname), start=1):
                cases[f"{name} level {level} {dname}"] = ops
    timing = {}
    for label, ops in cases.items():
        cx, _, _, obstacles, _, _ = ops
        (T, K), M = cx.shape, obstacles.pose.shape[0]
        before = ck.obb_collision.launches
        got = ck.obb_collision(*ops)
        want = ck.obb_collision_reference(*ops)
        torch.cuda.synchronize()
        check(ck.obb_collision.launches == before + (M > 0),
              f"{label}: the kernel launched "
              f"{ck.obb_collision.launches - before} times for M={M}")
        differ = torch.nonzero(got != want).flatten()
        max_err = max(max_err, float(len(differ) > 0))
        tol = MARGIN_TOL[str(cx.dtype).split(".")[-1]]
        margins = sat_margins(torch, *ops)[differ].cpu().numpy() \
            if len(differ) else np.zeros(0)
        for k, m in zip(differ.cpu().numpy()[:10], margins[:10]):
            log(f"  {label}: candidate {k} differs (kernel {bool(got[k])}, "
                f"plain {bool(want[k])}), tightest SAT margin {m:.3e} m")
        log(f"collision {label}: T={T} K={K} M={M} hits={int(want.sum())} "
            f"differing candidates={len(differ)}")
        check(bool(np.all(margins < tol)),
              f"{label}: kernel and plain version differ on a candidate "
              f"whose tightest SAT margin is at least {tol} m")
        check(len(differ) == 0, f"{label}: {len(differ)} differing "
              "candidates")
        if M > 0 and label.startswith(TIMED_COLLISION_CASES):
            k_ms = cuda_time_ms(torch, lambda: ck.obb_collision(*ops),
                                KERNEL_REPS)
            p_ms = cuda_time_ms(torch,
                                lambda: ck.obb_collision_reference(*ops),
                                PLAIN_REPS)
            timing[label] = (k_ms, p_ms)
            k_dev = device_kernel_ms(torch, lambda: ck.obb_collision(*ops),
                                     "obb_collision_kernel")
            p_dev = device_kernel_ms(
                torch, lambda: ck.obb_collision_reference(*ops), "")
            log(f"time collision {label}: T={T} K={K} M={M} kernel "
                f"{k_ms:.4f} ms per obb_collision call, plain {p_ms:.4f} ms "
                f"(CUDA events); device time of their kernels "
                f"{dev_text(k_dev)} and {dev_text(p_dev)} (profiler)")
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[-1]
        for label, ops in collision_cases(torch, dtype, "cuda").items():
            compare_collision_case(torch, f"{label} {dname}", ops)
            if label == "near-touching":
                compare_largest_rows(torch, f"{label} {dname}", ops)
    level1 = cases["ZAM_Over-1_1 level 1 float64"]
    check_one_kernel_per_call(torch, "obb_collision",
                              lambda: ck.obb_collision(*level1),
                              "obb_collision_kernel")
    ck.obb_collision.launches = counted
    k_ms, p_ms = timing["ZAM_Over-1_1 level 1 float64"]
    bound = collision_bound(torch, as_fleet_collision(torch, level1))[:2]
    # the masks are bool: the error is 1 where any candidate differs
    return dict(max_err=max_err, ms=k_ms, plain_ms=p_ms, bound=bound)


def phase_conformance(torch):
    """10. The float64 conformance plan() on the card: the four goldens, the
    four drives to their goals in the JAX package's step counts through the
    captured level programs, bit for bit their uncaptured twins, with one
    collision-kernel execution per level evaluation that has obstacles
    (profiler) and one device read per level evaluation; a replay at a new
    desired speed against the twin; plan() p50/p90 of both forms beside the
    same drives with the plain obstacle pass, and the four scenarios
    through ``segments`` and continuous ``plan_scan`` to their goals
    without device reads between cycles, each scan captured and bit for bit
    its uncaptured twin."""
    from commonroad_rp_tpu_torch.ops import collision as collision_ops
    from commonroad_rp_tpu_torch.ops import collision_kernel as ck
    from commonroad_rp_tpu_torch.ops import cycle as cycle_ops
    from commonroad_rp_tpu_torch.ops import scoring
    from commonroad_rp_tpu_torch.run_planner import (drive_to_goal,
                                                     load_config,
                                                     make_planner)

    def conformance_planner(name):
        config = load_config(name, HERE)
        config.debug.kernel_dtype = "float64"
        return make_planner(config, device="cuda")

    for name, g in GOLDEN_FIRST_CYCLE.items():
        planner = conformance_planner(name)
        planner.set_desired_velocity(current_speed=planner.x_0.velocity)
        end = planner.plan()[0].state_list[-1]
        reasons = {k: v for k, v in planner.infeasible_reason_dict.items()
                   if v}
        errors = (abs(planner.optimal_cost / g["cost"] - 1.0),
                  float(np.abs(np.asarray(end.position)
                               - g["end_position"]).max()),
                  abs(end.velocity - g["end_velocity"]),
                  abs(end.orientation - g["end_orientation"]))
        counters = (planner.infeasible_count_kinematics,
                    planner.infeasible_count_collision)
        log(f"golden {name}: cost rel err {errors[0]:.3e}, end position "
            f"{errors[1]:.3e} m, velocity {errors[2]:.3e}, orientation "
            f"{errors[3]:.3e}; rejected (kinematic, colliding) {counters}; "
            f"reasons {reasons}")
        check(errors[0] <= 1e-9 and errors[1] <= 1e-7 and errors[2] <= 1e-9
              and errors[3] <= 1e-9, f"golden {name}: winner differs")
        check(counters == g["counters"] and reasons == g["reasons"],
              f"golden {name}: counters or reasons differ")

    plan_ms = {True: [], False: []}
    by_form = {True: {}, False: {}}
    launches = executions = None
    for name, want_steps in CONFORMANCE_STEPS.items():
        reset_launch_counts()
        with program_calls() as calls:
            got = plan_drive(torch, name, dtype="float64")
        n_launch = ck.obb_collision.launches
        planner, result, _ = got
        built = list(planner.level_programs.values())
        built_obs = sum(p._args.obstacles.pose.shape[0] > 0 for p in built)
        with_obstacles = sum(c[2] for c in calls)
        log(f"conformance drive {name}: goal_reached="
            f"{result['goal_reached']} steps={result['steps']} plan() "
            f"calls={result['plan_calls']} level evaluations={len(calls)} "
            f"(with obstacles {with_obstacles}) built programs={len(built)} "
            f"(with obstacles {built_obs}) collision-kernel launches="
            f"{n_launch} (the warm-ups' and the captured ones)")
        check(result["goal_reached"] and result["steps"] == want_steps,
              f"conformance {name}: expected the goal in {want_steps} "
              f"steps, got {result['steps']}")
        check(all(p.graph and p.kind == "level" for p in built)
              and n_launch == 2 * built_obs
              and scoring.score_candidates.launches == 0,
              f"conformance {name}: {n_launch} collision-kernel launches "
              f"for {built_obs} captured programs with obstacles")
        want = plan_drive(torch, name, graph=False, dtype="float64")
        assert_drives_identical(f"conformance drive {name}", got, want)
        by_form[True][name] = planner.level_programs
        by_form[False][name] = want[0].level_programs
        again = lambda: plan_drive(torch, name, dtype="float64",
                                   programs=planner.level_programs)
        n_exec = 0
        if with_obstacles:
            n_exec, names = kernel_executions(
                torch, again, COLLISION_KERNEL, with_obstacles, warm=False)
            check(n_exec == with_obstacles,
                  f"conformance {name}: {n_exec} collision-kernel "
                  f"executions for {with_obstacles} level evaluations with "
                  f"obstacles ({names})")
        rows = reads_per_plan(torch, name, dtype="float64",
                              programs=planner.level_programs)
        check(sum(back for _, back in rows) == len(calls),
              f"conformance {name}: the warm drive evaluated "
              f"{sum(back for _, back in rows)} levels, the first "
              f"{len(calls)}")
        check_reads(f"conformance drive {name}", rows)
        log(f"conformance drive {name}: captured == uncaptured bit for bit; "
            f"a warm drive: {n_exec} collision-kernel executions "
            f"(profiler) for {with_obstacles} level evaluations with "
            f"obstacles")
        if name == "ZAM_Over-1_1":
            launches, executions = n_launch, n_exec
            check(n_exec > 0, "ZAM_Over: the collision kernel never ran")
        log_builds(f"conformance {name}", calls)
        for graph, (_, res, _) in ((True, got), (False, want)):
            plan_ms[graph] += [1e3 * t for t in res["planning_times"][1:]]
    for graph in (True, False):
        q = np.percentile(plan_ms[graph], [50, 90])
        log(f"conformance plan() float64 "
            f"{'captured' if graph else 'uncaptured'}: p50 {q[0]:.3f} ms, "
            f"p90 {q[1]:.3f} ms over {len(plan_ms[graph])} calls of the "
            "four drives (first call of each drive excluded)")
    for graph in (True, False):
        log(f"conformance plan() float64 "
            f"{'captured' if graph else 'uncaptured'}, ZAM_Over's first "
            f"cycle planned 20 times: device busy share "
            f"{plan_busy(torch, 'ZAM_Over-1_1', graph, by_form[graph], 'float64')}")
    q = np.percentile(plan_ms[True], [50, 90])
    replay_at_new_speed(torch, "conformance replay at a new speed",
                        "ZAM_Over-1_1", dtype="float64")
    # the same drives with the plain obstacle pass in the kernel's place
    plain_ms = []
    collision_ops.obb_collision = ck.obb_collision_reference
    try:
        for name, want_steps in CONFORMANCE_STEPS.items():
            result = drive_to_goal(conformance_planner(name), max_steps=300)
            torch.cuda.synchronize()
            check(result["steps"] == want_steps,
                  f"conformance {name} with the plain obstacle pass: "
                  f"{result['steps']} steps")
            plain_ms += [1e3 * t for t in result["planning_times"][1:]]
    finally:
        collision_ops.obb_collision = ck.obb_collision
    q_plain = np.percentile(plain_ms, [50, 90])
    log(f"conformance plan() float64 with the plain obstacle pass "
        f"(captured): p50 "
        f"{q_plain[0]:.3f} ms, p90 {q_plain[1]:.3f} ms over "
        f"{len(plain_ms)} calls")

    for key, value in (("boundary_mode", "segments"),
                       ("continuous_collision_check", True)):
        for name, cycles in EXPECTED_CYCLES.items():
            config = load_config(name, HERE)
            setattr(config.planning, key, value)
            planner = make_planner(config, device="cuda")
            planner.set_desired_velocity(current_speed=planner.x_0.velocity)
            run, carry = planner.scan_program(cycles + 3)
            twin, _ = planner.scan_program(cycles + 3, graph=False)
            captured_and_twin(torch, f"plan_scan {key}={value} {name}", run,
                              twin, carry, float(planner._desired_speed))
            planner.record_state_and_input(planner.x_0)
            info = planner.plan_scan(cycles + 3)
            log(f"plan_scan {key}={value} {name}: goal_reached="
                f"{info['goal_reached']} steps={info['steps']} cycles_run="
                f"{info['cycles_run']}, largest re-selection count in a "
                f"cycle {max(info['reselections'])} (bound "
                f"{cycle_ops.REFINE_WIDTH}), no device read between "
                f"cycles")
            check(info["goal_reached"] and info["steps"] == EXPECTED_STEPS[
                name], f"plan_scan {key}={value} {name}: goal not reached "
                f"in {EXPECTED_STEPS[name]} steps")
    return dict(launches=launches, executions=executions, p50=q[0],
                p90=q[1])


def bound_of(ops, nbytes, dtype_name="float32"):
    """(bound ms, bound_by): the larger of the operations over the card's
    peak for their type and the bytes over its memory rate."""
    t_ops = ops / PEAK_OPS[dtype_name] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def scorer_bound(torch, inp):
    """Bound of one scorer launch on prepared operands (one problem or a
    fleet, its candidates loaded or a lattice): this run's active steps
    (``traj_len``); every operand read once (a lattice's: the carried
    state, the bounds and the level table, and each candidate built once),
    the three [.., K] rows written once."""
    from commonroad_rp_tpu_torch.ops import scoring

    lattice = isinstance(inp, scoring.FleetLatticeInputs)
    loaded = scoring.lattice_scorer_inputs(inp) if lattice else inp
    if not isinstance(loaded, scoring.FleetScorerInputs):
        loaded = scoring._as_fleet(loaded)
    T = loaded.n_steps + 1
    F, K = loaded.traj_len.shape
    halvings = int(np.ceil(np.log2(loaded.tables.shape[1])))
    active = float(torch.clamp(loaded.traj_len, max=T).sum())
    ops = F * K * T * SCORER_STEP_OPS + active * (SCORER_ACTIVE_OPS
                                                  + 3 * halvings)
    operands = [t for t in inp if isinstance(t, torch.Tensor)]
    if lattice:
        ops += F * K * LATTICE_OPS
        operands.append(scoring.lattice_table(inp.grid, inp.x0_lon.device))
    nbytes = 4 * (sum(t.numel() for t in operands) + 3 * F * K)
    return bound_of(ops, nbytes)


def lattice_candidates_bound(torch, inp, index):
    """Bound of one ``lattice_candidates`` launch: each chosen candidate
    built once (its index read, its 13 floats written), each problem's
    carried state, bounds and low-velocity flag and the level table read
    once."""
    from commonroad_rp_tpu_torch.ops import scoring

    F, J = index.shape
    table = scoring.lattice_table(inp.grid, inp.x0_lon.device)
    nbytes = F * J * (8 + 13 * 4) + F * 4 * (3 + 3 + 2 + 1) \
        + 4 * table.numel()
    return bound_of(F * J * LATTICE_OPS, nbytes)



def map_collision_ops(ops, fn):
    """``fn`` applied to every tensor of fleet collision operands (cx, cy,
    theta, box rows, ehl, ehw); None stays None."""
    g = lambda a: None if a is None else fn(a)
    cx, cy, theta, obstacles, ehl, ehw = ops
    return (g(cx), g(cy), g(theta), type(obstacles)(*map(g, obstacles)),
            g(ehl), g(ehw))


def as_fleet_collision(torch, ops):
    """Single-problem collision operands ([T, K] poses, [M, ...] rows, host
    scalar extents) as a fleet of one."""
    cx, cy, theta, obstacles, ehl, ehw = ops
    ext = lambda x: torch.full((1,), float(x), dtype=cx.dtype,
                               device=cx.device)
    return (cx[None], cy[None], theta[None],
            type(obstacles)(*(None if a is None else a[None]
                              for a in obstacles)), ext(ehl), ext(ehw))


def collision_work(torch, ops):
    """(evaluated ego steps, steps whose heading is computed, skip tests,
    full pair tests) of the collision kernels' early-exit loops on
    fleet-form operands, replayed with the plain version one (step, row)
    at a time in the order one thread of the fleet form runs them: the
    skip (``far_pairs_reference``) tests every live valid pair, the full
    test runs on those it keeps."""
    from commonroad_rp_tpu_torch.ops import collision_kernel as ck

    cx, cy, theta, obstacles, ehl, ehw = ops
    F, T, K = cx.shape
    M = obstacles.pose.shape[1]
    done = torch.zeros((F, K), dtype=torch.bool, device=cx.device)
    steps = torch.zeros((), dtype=torch.int64, device=cx.device)
    headings, pairs, full = (torch.zeros_like(steps) for _ in range(3))
    for t in range(T):
        steps += torch.sum(~done)
        at = lambda a: a[:, t:t + 1].contiguous()
        rows_t = type(obstacles)(
            pose=obstacles.pose[:, :, t:t + 1].contiguous(),
            half_ext=obstacles.half_ext,
            valid=obstacles.valid[:, :, t:t + 1].contiguous(),
            radius=obstacles.radius)
        far = ck.far_pairs_reference(at(cx), at(cy), at(theta), rows_t, ehl,
                                     ehw)[:, 0]             # [F, M, K]
        heading = torch.zeros_like(done)
        for m in range(M):
            live = ~done & obstacles.valid[:, m, t, None]
            tested = live & ~far[:, m]
            pairs += torch.sum(live)
            full += torch.sum(tested)
            heading |= tested
            row = lambda a: None if a is None else a[:, m:m + 1].contiguous()
            one = type(obstacles)(
                pose=row(obstacles.pose)[:, :, t:t + 1].contiguous(),
                half_ext=row(obstacles.half_ext),
                valid=row(obstacles.valid)[:, :, t:t + 1].contiguous(),
                radius=row(obstacles.radius))
            hit = ck.obb_collision_fleet_reference(at(cx), at(cy), at(theta),
                                                   one, ehl, ehw)
            done = done | (hit & tested)
        headings += torch.sum(heading)
    return int(steps), int(headings), int(pairs), int(full)


def collision_bound(torch, ops):
    """(bound ms, bound_by, work) of one fleet collision launch, ``work``
    the tuple of :func:`collision_work`: the poses of the evaluated steps
    and every row read once, the mask written once; a skipped pair charged
    its skip test alone."""
    cx, _, _, obstacles, _, _ = ops
    F, T, K = cx.shape
    M = obstacles.pose.shape[1]
    size = cx.element_size()
    work = collision_work(torch, ops)
    steps, headings, pairs, full = work
    nbytes = (steps * 3 * size + F * M * T * (3 * size + 1)
              + F * M * 3 * size + 2 * F * size + F * K)
    ops_count = (headings * COLLISION_STEP_OPS + pairs * COLLISION_SKIP_OPS
                 + full * COLLISION_PAIR_OPS)
    return bound_of(ops_count, nbytes, str(cx.dtype).split(".")[-1]) + (work,)


def captured_fleet_collision(run_once):
    """The fleet collision kernel's operands of the first call in
    ``run_once()`` (the plain version answers while capturing)."""
    from commonroad_rp_tpu_torch.ops import collision as collision_ops
    from commonroad_rp_tpu_torch.ops import collision_kernel as ck

    captured = []

    def capture(*ops):
        captured.append(ops)
        return ck.obb_collision_fleet_reference(*ops)

    collision_ops.obb_collision_fleet = capture
    try:
        run_once()
    finally:
        collision_ops.obb_collision_fleet = ck.obb_collision_fleet
    return captured[0]


def compare_fleet_collision(torch, label, ops, chunk=128):
    """The fleet collision kernel against its plain version (in chunks of
    ``chunk`` problems) on these operands, in float32 and float64: raises
    unless 0 candidates differ.  Launches made here are not counted."""
    from commonroad_rp_tpu_torch.ops import collision_kernel as ck

    counted = ck.obb_collision_fleet.launches
    F, T, K = ops[0].shape
    for dtype in (torch.float32, torch.float64):
        d_ops = map_collision_ops(ops, lambda a: a.to(dtype)
                                  if a.is_floating_point() else a)
        got = ck.obb_collision_fleet(*d_ops)
        want = torch.cat([ck.obb_collision_fleet_reference(
            *map_collision_ops(d_ops, lambda a: a[f0:f0 + chunk]))
            for f0 in range(0, F, chunk)])
        torch.cuda.synchronize()
        differ = int((got != want).sum())
        log(f"fleet collision {label} {str(dtype).split('.')[-1]}: F={F} "
            f"T={T} K={K} M={ops[3].pose.shape[1]} hits={int(want.sum())} "
            f"differing candidates={differ}")
        check(differ == 0, f"fleet collision {label}: the kernel and its "
              f"plain version differ on {differ} candidates")
    ck.obb_collision_fleet.launches = counted


def reset_launch_counts():
    """Every kernel wrapper's launch count to 0 (before a main-path run)."""
    from commonroad_rp_tpu_torch.ops import collision_kernel as ck
    from commonroad_rp_tpu_torch.ops import dense_rollout as dr
    from commonroad_rp_tpu_torch.ops import scoring

    for wrapper in (scoring.score_candidates, scoring.score_fleet,
                    scoring.lattice_candidates, scoring.trivial_probe,
                    ck.obb_collision, ck.obb_collision_fleet,
                    dr.dense_rollout, dr.dense_winner):
        wrapper.launches = 0


def dense_first_cycle(torch, scene, carry, dtype=None, route_end=False):
    """The first XLA cycle's ``ops.dense_rollout`` operands of a fleet at
    ``run_fleet``'s level and horizon, in ``dtype`` (the scene's when None);
    ``route_end``: every member on a route shorter than the fleet's longest
    moved 8 m before its route's end."""
    from commonroad_rp_tpu_torch.ops import grid as grid_ops
    from commonroad_rp_tpu_torch.parallel import fleet
    from commonroad_rp_tpu_torch.run_fleet import DT, LEVEL, N_STEPS

    if route_end:
        ends = fleet.true_path_lengths(scene.ref.s)
        short = ends < ends.max() - 1.0
        x0_lon = carry.x0_lon.clone()
        x0_lon[short, 0] = ends[short] - 8.0
        carry = carry._replace(x0_lon=x0_lon)
    if dtype is not None:
        cast = lambda t: t.to(dtype) if t.is_floating_point() else t
        scene = type(scene)(*(
            type(leaf)(*map(cast, leaf)) if isinstance(leaf, tuple)
            else cast(leaf) for leaf in scene))
        carry = type(carry)(*map(cast, carry))
    static_grid = grid_ops.make_static_grid(LEVEL, 0.4, N_STEPS * DT, DT,
                                            -3.0, 3.0, 4)
    grid_ops.upload_constants(static_grid, carry.x0_lon.device)
    return fleet.dense_inputs(carry, scene, scene.veh,
                              static_grid=static_grid,
                              low_vel_threshold=4.0, horizon=N_STEPS * DT)


def _dense_slice(inp, f0, f1):
    """Problems [f0, f1) of dense-rollout operands."""
    cut = lambda t: t[f0:f1]
    return type(inp)(*(type(x)(*map(cut, x)) if isinstance(x, tuple)
                       else cut(x) for x in inp))


def compare_dense_rollout(torch, label, inp, chunk=256):
    """``dense_rollout_kernel`` against its plain version on ``inp`` (the
    plain version in chunks of ``chunk`` problems), and
    ``dense_winner_kernel`` against the plain bundle at the plain version's
    winners (feasible, in the corridor, cheapest): raises unless at most
    ``DENSE_MAX_FLIPS`` verdicts differ, costs and poses lie within
    ``DENSE_TOLERANCE`` and the winner states are the bundle's, bit for
    bit.  Returns the readings; launches made here are not counted."""
    from commonroad_rp_tpu_torch.ops import dense_rollout as dr
    from commonroad_rp_tpu_torch.run_fleet import DT, N_STEPS

    counted = (dr.dense_rollout.launches, dr.dense_winner.launches)
    dtype_name = str(inp.coeffs_lon.dtype).split(".")[-1]
    tol = DENSE_TOLERANCE[dtype_name]
    got = dr.dense_rollout(inp, DT, N_STEPS)
    F = inp.traj_len.shape[0]
    flips = nonfinite = 0
    cost_gap = pose_gap = win_gap = 0.0
    win_differ = n_ok = 0
    for f0 in range(0, F, chunk):
        part = _dense_slice(inp, f0, f0 + chunk)
        want = dr.dense_rollout_reference(part, DT, N_STEPS)
        g = lambda t: t[f0:f0 + chunk]
        flips += int((g(got.feasible) != want.feasible).sum()
                     + (g(got.corridor) != want.corridor).sum())
        finite = torch.isfinite(want.cost)
        nonfinite += int((torch.isfinite(g(got.cost)) != finite).sum())
        cost_gap = max(cost_gap, float(torch.where(
            finite, (g(got.cost) - want.cost).abs() / want.cost.abs(),
            0.0).max()))
        for a, b in zip(got[:3], want[:3]):
            pose_gap = max(pose_gap, float((g(a) - b).abs().max()))
        ok = want.feasible & ~want.corridor
        n_ok += int(ok.sum())
        best = torch.argmin(torch.where(
            ok, want.cost, torch.full_like(want.cost, float("inf"))), dim=1)
        rows = dr.dense_winner(part, dr.DenseRollout(*map(g, got[:6])),
                               best, DT, N_STEPS, 1, 10)
        plain = dr.dense_winner_reference(want, best, 1, 10)
        win_differ += int((rows != plain).sum())
        win_gap = max(win_gap, float(((rows - plain).abs() / torch.clamp(
            plain.abs(), min=1.0)).max()))
        del want
    torch.cuda.synchronize()
    readings = dict(flips=flips, nonfinite=nonfinite, cost_gap=cost_gap,
                    pose_gap=pose_gap, winner_gap=win_gap,
                    winner_differ=win_differ, ok=n_ok)
    log(f"dense rollout {label} {dtype_name}: F={F} K={inp.traj_len.shape[1]}"
        f" T={N_STEPS + 1}: {n_ok} candidates feasible and in the corridor "
        f"(plain); flipped verdicts {flips}, costs finite on one side only "
        f"{nonfinite}, largest relative cost gap "
        f"{cost_gap:.3e}, largest pose gap {pose_gap:.3e}, winner states: "
        f"{win_differ} of {F * len(dr.WINNER_FIELDS)} differ, largest "
        f"relative gap {win_gap:.3e}")
    check(flips <= DENSE_MAX_FLIPS and nonfinite == 0
          and cost_gap <= tol["cost"] and pose_gap <= tol["pose"]
          and win_differ == 0,
          f"dense rollout {label} {dtype_name}: the kernel and its plain "
          f"version differ beyond the bars ({readings})")
    dr.dense_rollout.launches, dr.dense_winner.launches = counted
    return readings


def dense_rollout_bound(torch, inp):
    """(bound ms, bound_by) of one ``dense_rollout`` launch: its
    operations (``DENSE_*_OPS`` over this run's active and extension steps)
    against its bytes (the coefficient rows and valid steps read once, the
    poses and verdicts written once, each problem's tables once)."""
    from commonroad_rp_tpu_torch.run_fleet import N_STEPS

    F, K = inp.traj_len.shape
    T = N_STEPS + 1
    active = float(torch.clamp(inp.traj_len, max=T).sum())
    ext = F * K * T - active
    ops = (F * K * T * DENSE_STEP_OPS + active * (DENSE_ACTIVE_OPS
                                                   + 4 * DENSE_SEARCH_OPS)
           + ext * (DENSE_EXT_OPS + 3 * DENSE_SEARCH_OPS))
    size = inp.coeffs_lon.element_size()
    P = inp.ref.s.shape[1]
    nbytes = (F * K * (12 * size + 4) + F * K * T * 3 * size
              + F * K * (size + 2) + F * P * 13 * size + F * 12 * size)
    return bound_of(ops, nbytes, str(inp.coeffs_lon.dtype).split(".")[-1])


def phase_xla_fleet(torch, fused):
    """11. The XLA fleet path on the card, captured: the bench shape, the
    12-problem fleet and fleet1024 bit for bit their ``graph=False`` twins,
    one fleet collision-kernel and one dense-rollout-kernel execution per
    cycle (profiler); the fleet collision kernel and the dense rollout
    kernel against their plain versions (the latter on the 12-problem fleet
    in both dtypes, as it starts and at its routes' ends, and at fleet1024,
    where it is timed); the 12-problem fleet against the fused scan;
    fleet1024 beside the fused scan's goal counts (``fused``: phase 8's
    outcomes and trace)."""
    from commonroad_rp_tpu_torch.ops import collision_kernel as ck
    from commonroad_rp_tpu_torch.ops import dense_rollout as dr
    from commonroad_rp_tpu_torch.ops import grid as grid_ops
    from commonroad_rp_tpu_torch.parallel import fleet
    from commonroad_rp_tpu_torch.parallel.dryrun import (over_problem,
                                                         shared_vehicle)
    from commonroad_rp_tpu_torch.run_fleet import (
        DT, LEVEL, N_STEPS, SCENARIOS, VEHICLE_TYPES, goal_counts,
        heterogeneous_fleet, make_scan, make_xla_rollout, member_outcomes,
        winner_trace)

    def captured_rollout(label, run, twin, carry, scene, cycles):
        """``captured_and_twin`` on a rollout, its wrapper counts (the
        warm-up's launch and the captured one) and the profiler's
        executions of the fleet collision kernel and the dense rollout
        kernel in a traced warm call."""
        got, _, _ = captured_and_twin(torch, label, run, twin, carry, scene)
        launches = ck.obb_collision_fleet.launches
        check(launches == 2 + cycles and ck.obb_collision.launches == 0,
              f"{label}: {launches} fleet collision launches for the "
              f"captured program and its {cycles}-cycle twin")
        dense = dr.dense_rollout.launches
        check(dense == 2 + cycles, f"{label}: {dense} dense rollout "
              f"launches for the captured program and its {cycles}-cycle "
              f"twin")
        executions, names = kernel_executions(
            torch, lambda: run(carry, scene), FLEET_COLLISION_KERNEL, cycles)
        check(executions == cycles, f"{label}: {executions} fleet collision "
              f"kernel executions for {cycles} cycles ({names})")
        dense_exec = sum(n for name, n in names.items()
                         if re.search(DENSE_KERNEL, name))
        check(dense_exec == cycles,
              f"{label}: {dense_exec} dense rollout kernel executions for "
              f"{cycles} cycles ({names})")
        log(f"{label}: wrapper counts 2 (warm-up, capture) + {cycles} "
            f"(twin); {executions} obb_collision_fleet_kernel executions in "
            f"a traced call (profiler); graph pool {run.pool_bytes} B "
            f"({run.pool_bytes / 2**20:.1f} MiB)")
        return got, executions

    # ---- bench shape (bench.py:670-694): 16 x ZAM_Over, level 3, 10 cycles
    F, cycles = 16, 10
    scene, carry = fleet.build_fleet_scene(
        [over_problem(N_STEPS, horizon_pad=60, root=HERE)] * F, N_STEPS,
        device="cuda")
    static_grid = grid_ops.make_static_grid(LEVEL, 0.4, N_STEPS * DT, DT,
                                            -3.0, 3.0, 4)
    K = static_grid.size
    bench = lambda n, graph=True: fleet.make_fleet_rollout(
        None, shared_vehicle(), static_grid, DT, N_STEPS, replan_offset=3,
        low_vel_threshold=4.0, horizon=N_STEPS * DT, n_cycles=n,
        device="cuda", graph=graph)
    run, twin = bench(cycles), bench(cycles, False)
    (_, metrics), _ = captured_rollout(f"XLA fleet F={F} (bench shape)", run,
                                       twin, carry, scene, cycles)
    forms = scan_forms_timed(torch, f"XLA fleet F={F} (bench shape)",
                             {"captured": run, "uncaptured": twin},
                             lambda fn: fn(carry, scene), cycles, rounds=1)
    log(f"XLA fleet F={F} (bench shape): K={K} T={N_STEPS + 1}, successes "
        f"per cycle {metrics.fleet_success.tolist()}; "
        + ", ".join(f"{form} {F * K / ms * 1e3:.6g} candidate-evals/s"
                    for form, (ms, _) in forms.items()))
    ops16 = captured_fleet_collision(lambda: bench(1, False)(carry, scene))
    compare_fleet_collision(torch, "bench F=16 first cycle", ops16)
    ms16 = cuda_time_ms(torch, lambda: ck.obb_collision_fleet(*ops16),
                        KERNEL_REPS)
    plain16 = cuda_time_ms(
        torch, lambda: ck.obb_collision_fleet_reference(*ops16), PLAIN_REPS)
    log(f"time fleet collision F=16: kernel {ms16:.4f} ms, plain "
        f"{plain16:.4f} ms")

    # ---- the 12-problem heterogeneous fleet: XLA path against fused scan
    scene12, carry12, _, _ = heterogeneous_fleet(12, 10, device="cuda",
                                                 root=HERE)
    run_x = make_xla_rollout(10, 1, "cuda")[0]
    (final_x, m_x), _ = captured_rollout(
        "XLA fleet F=12", run_x, make_xla_rollout(10, 1, "cuda", False)[0],
        carry12, scene12, 10)
    # a second scene of the same shapes through the same captured program
    scene12b, carry12b, _, _ = heterogeneous_fleet(12, 10, seed=1,
                                                   device="cuda", root=HERE)
    assert_bit_identical(
        torch, "XLA fleet F=12, another scene",
        no_sync(torch, lambda: run_x(carry12b, scene12b)),
        make_xla_rollout(10, 1, "cuda", False)[0](carry12b, scene12b))
    log("XLA fleet F=12: the captured program on a second scene (seed 1) "
        "== a fresh uncaptured rollout on it, bit for bit")
    for dtype in (torch.float32, torch.float64):
        for route_end in (False, True):
            compare_dense_rollout(
                torch, f"F=12{' at route ends' if route_end else ''}",
                dense_first_cycle(torch, scene12, carry12, dtype, route_end))
    run_f, _ = make_scan(scene12, 10)
    final_f, m_f = run_f(carry12)
    compare_fleet_collision(torch, "F=12 first cycle", captured_fleet_collision(
        lambda: make_xla_rollout(1, 1, "cuda", False)[0](carry12,
                                                         scene12)))
    h = lambda t: t.cpu().numpy()
    np.testing.assert_array_equal(h(m_x.found), h(m_f[0]))
    np.testing.assert_allclose(h(final_x.x0_lon), h(final_f.x0_lon),
                               rtol=2e-4, atol=2e-3)
    np.testing.assert_allclose(h(final_x.velocity), h(final_f.velocity),
                               atol=2e-3)
    np.testing.assert_allclose(h(m_x.best_cost), h(m_f[1]), rtol=2e-3)
    np.testing.assert_array_equal(h(m_x.fleet_success), h(m_f[4]))
    np.testing.assert_allclose(h(m_x.fleet_mean_cost), h(m_f[5]), rtol=2e-3)
    log(f"F=12 heterogeneous, 10 cycles: XLA path and fused scan agree "
        f"(found identical, alive {int(m_x.found[-1].sum())}/12 at the end; "
        f"max |x0_lon diff| "
        f"{float((final_x.x0_lon - final_f.x0_lon).abs().max()):.3e}, max "
        f"|best cost diff| "
        f"{float((m_x.best_cost - m_f[1]).nan_to_num(0, 0, 0).abs().max()):.3e})")
    del run, twin, run_x, run_f
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # ---- full width: run_fleet --xla's 1024-problem fleet, 150 cycles,
    # captured (the default) and its graph=False twin
    F, cycles = 1024, 150
    scene, carry, goals, base_idx = fused["fleet"]          # phase 8's fleet
    run, K = make_xla_rollout(cycles, 1, "cuda")
    M = scene.obs_pose.shape[1]
    log(f"XLA fleet{F}: phase 8's fleet, K={K}, "
        f"T={N_STEPS + 1}, M={M}, Mp={scene.poly_verts.shape[1]}; reckoned "
        f"peak: the dense rollout kernel's three [F, T, K] float32 pose "
        f"arrays of {F * K * 21 / 1e6:.1f}M elements, "
        f"{3 * F * K * 21 * 4 / 1e9:.2f} GB, beside the grid's [F, K, 6] rows")
    walls, peaks = {}, {}
    results = {}
    for form, make in (("captured", lambda: run),
                       ("uncaptured", lambda: make_xla_rollout(
                           cycles, 1, "cuda", graph=False)[0])):
        program = make()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.time()
        results[form] = no_sync(torch, lambda: program(carry, scene))
        torch.cuda.synchronize()
        walls[form] = time.time() - t0
        peaks[form] = torch.cuda.max_memory_allocated()
        launches = ck.obb_collision_fleet.launches
        want = 2 if form == "captured" else cycles
        check(launches == want and ck.obb_collision.launches == 0,
              f"XLA fleet1024 {form}: {launches} fleet collision launches, "
              f"expected {want}")
        if form == "captured":
            check(program.replays == cycles, f"XLA fleet1024: "
                  f"{program.replays} replays for {cycles} cycles")
            pool, main_launches = program.pool_bytes, launches
            main_dense = dr.dense_rollout.launches
        log(f"XLA fleet1024 {form}: {cycles} cycles, {launches} fleet "
            f"collision wrapper launches, no device read between cycles; "
            f"{walls[form]:.3f} s"
            f"{' (first call: warm-up cycle, capture, 150 replays)' if form == 'captured' else ''}: "
            f"{walls[form] / cycles * 1e3:.3f} ms/cycle, "
            f"{F * K * cycles / walls[form]:.6g} candidate-evals/s; peak "
            f"device memory {peaks[form] / 1e9:.3f} GB "
            f"(max_memory_allocated)")
    assert_bit_identical(torch, "XLA fleet1024", results["captured"],
                         results["uncaptured"])
    metrics = results["captured"][1]
    outcomes = member_outcomes(metrics, goals, base_idx)
    check(outcomes == member_outcomes(results["uncaptured"][1], goals,
                                      base_idx),
          "XLA fleet1024: member outcomes differ between the forms")
    log(f"XLA fleet1024: captured == uncaptured bit for bit ({cycles} "
        f"cycles, every metric, member outcomes); graph pool {pool} B "
        f"({pool / 2**30:.3f} GiB)")
    del run, results
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    counts = goal_counts(metrics, goals, base_idx, outcomes=outcomes)
    fused_counts = goal_counts(None, goals, base_idx,
                               outcomes=fused["outcomes"])
    for name in SCENARIOS:
        c, fc = counts[name], fused_counts[name]
        log(f"XLA fleet1024 {name}: {c['reached']}/{c['total']} reached"
            f"{', misses ' + str(c['misses']) if c['misses'] else ''} "
            f"(fused scan: {fc['reached']}/{fc['total']}"
            f"{', misses ' + str(fc['misses']) if fc['misses'] else ''}; "
            f"JAX package on the TPU: {JAX_FLEET1024[name]})")
    check(all(c["reached"] > 0 for c in counts.values()),
          "XLA fleet1024: a scenario reached no goal")
    differ = [f for f in range(F) if outcomes[f] != fused["outcomes"][f]]
    log(f"XLA fleet1024: {len(differ)} members whose outcome differs from "
        "the fused scan's")
    trace_x = [t.cpu().numpy() for t in winner_trace(metrics)]
    trace_f = [t.cpu().numpy() for t in fused["trace"]]
    cost_x, cost_f = metrics.best_cost.cpu().numpy(), fused["cost"]
    for f in differ[:20]:
        apart = (trace_x[0][:, f] != trace_f[0][:, f]) | (
            np.hypot(trace_x[1][:, f] - trace_f[1][:, f],
                     trace_x[2][:, f] - trace_f[2][:, f]) > 0.05)
        c = int(np.argmax(apart)) if apart.any() else None
        where = "never apart" if c is None else (
            f"first apart at cycle {c}: alive {bool(trace_x[0][c, f])}/"
            f"{bool(trace_f[0][c, f])}, best cost {cost_x[c, f]:.6g}/"
            f"{cost_f[c, f]:.6g} (XLA/fused)")
        log(f"  member {f} ({SCENARIOS[base_idx[f] // len(VEHICLE_TYPES)]}, "
            f"vehicle {VEHICLE_TYPES[base_idx[f] % len(VEHICLE_TYPES)]}): "
            f"XLA {outcomes[f]}, fused {fused['outcomes'][f]}; {where}")

    # a 3-cycle program at the same width: the first call's extra time and
    # the profiler's executions (a traced 150-cycle replay would take 15 s),
    # both forms' ms/cycle in turns and their busy shares
    run3, twin3 = (make_xla_rollout(3, 1, "cuda", graph=graph)[0]
                   for graph in (True, False))
    _, executions = captured_rollout("XLA fleet1024, 3 cycles", run3, twin3,
                                     carry, scene, 3)
    forms = scan_forms_timed(torch, "XLA fleet1024 (3 cycles)",
                             {"captured": run3, "uncaptured": twin3},
                             lambda fn: fn(carry, scene), 3, rounds=1)
    del run3, twin3
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    ops = captured_fleet_collision(
        lambda: make_xla_rollout(1, 1, "cuda", False)[0](carry, scene))
    compare_fleet_collision(torch, "fleet1024 first cycle", ops)
    ms = cuda_time_ms(torch, lambda: ck.obb_collision_fleet(*ops), 50)
    plain_ms = cuda_time_ms(torch, lambda: [
        ck.obb_collision_fleet_reference(
            *map_collision_ops(ops, lambda a: a[f0:f0 + 128]))
        for f0 in range(0, F, 128)], 3)
    dev_ms = device_kernel_ms(torch, lambda: ck.obb_collision_fleet(*ops),
                              "obb_collision_fleet_kernel")
    check_one_kernel_per_call(torch, "obb_collision_fleet",
                              lambda: ck.obb_collision_fleet(*ops),
                              "obb_collision_fleet_kernel")
    bound_ms, bound_by, (steps, headings, pairs, full) = collision_bound(
        torch, ops)
    log(f"time fleet collision F={F}: kernel {ms:.4f} ms per "
        f"obb_collision_fleet call (device time {dev_text(dev_ms)}), plain "
        f"{plain_ms:.4f} ms (8 calls of 128 problems); bound {bound_ms:.6f} "
        f"ms by {bound_by} ({steps} evaluated steps, {headings} with their "
        f"heading computed, {pairs} live pairs, {full} full pair tests: the "
        f"skip removes {1 - full / max(pairs, 1):.4f} of the pair tests)")

    # the dense rollout kernel at full width, the first cycle's operands
    inp = dense_first_cycle(torch, scene, carry)
    dense_readings = compare_dense_rollout(torch, "fleet1024 first cycle",
                                           inp)
    counted = dr.dense_rollout.launches
    call = lambda: dr.dense_rollout(inp, DT, N_STEPS)
    dense_ms = cuda_time_ms(torch, call, 50)
    dense_plain_ms = cuda_time_ms(torch, lambda: [
        dr.dense_rollout_reference(_dense_slice(inp, f0, f0 + 256), DT,
                                   N_STEPS) for f0 in range(0, F, 256)], 3)
    dense_dev_ms = device_kernel_ms(torch, call, "dense_rollout_kernel")
    check_one_kernel_per_call(torch, "dense_rollout", call,
                              "dense_rollout_kernel")
    dense_bound = dense_rollout_bound(torch, inp)
    dr.dense_rollout.launches = counted
    log(f"time dense rollout F={F}: kernel {dense_ms:.4f} ms per "
        f"dense_rollout call (device time {dev_text(dense_dev_ms)}), plain "
        f"{dense_plain_ms:.4f} ms (4 calls of 256 problems); bound "
        f"{dense_bound[0]:.6f} ms by {dense_bound[1]}")
    return dict(launches=main_launches, executions=executions, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                dev_ms=dev_ms, walls=walls, pool=pool,
                dense=dict(launches=main_dense, ms=dense_ms,
                           plain_ms=dense_plain_ms, dev_ms=dense_dev_ms,
                           bound=dense_bound, readings=dense_readings))


def same_device_ops(torch, label, run, twin, args, attempts=8):
    """Raises unless a replay of the captured ``run`` launches as many
    device operations as its eager ``twin`` on the same arguments (the
    profiler drops events now and then: each form's largest count over up
    to ``attempts`` traces, taken in turns until they agree).  Returns the
    count."""
    best = {True: 0, False: 0}
    for attempt in range(attempts):
        for form, fn in ((True, run), (False, twin)):
            best[form] = max(best[form], kernel_executions(
                torch, lambda: fn(*args), "", 0, attempts=1)[0])
        if best[True] == best[False]:
            break
    check(best[True] == best[False], f"{label}: a replay launches "
          f"{best[True]} device operations, the eager twin {best[False]}")
    return best[True]


def phase_nccl_dryrun(torch):
    """12. The NCCL dry run in this process: a world-size-1 NCCL group
    through both fleet programs (``dryrun.run_rank``: two XLA fleet cycles
    and one fused fleet-scan cycle, global success count = F); the same
    programs (``dryrun.fleet_programs``) captured with the all-reduces in
    the graph, bit for bit their ``graph=False`` twins; three one-element all-reduces recorded per captured step (2 x 3
    per program: the warm-up's and the capture's) and three per eager
    cycle; a replay of each captured program launches as many device
    operations as its twin (profiler), and what one all-reduce launches,
    eager and replayed; then the n=1 row of ``measure_scaling`` (the
    captured rollout under a group of one)."""
    import torch.distributed as dist

    from commonroad_rp_tpu_torch.ops.program import CapturedStep
    from commonroad_rp_tpu_torch.parallel import dryrun, mesh, scaling

    device = mesh.initialize_distributed(
        f"tcp://localhost:{dryrun.free_port()}", 1, 0, "cuda")
    try:
        group = mesh.make_fleet_group()
        dryrun.run_rank(group, 0, 1, device)
        programs, counts = {}, {}
        for graph in (True, False):
            before = mesh.fleet_all_reduce.calls, mesh.fleet_all_reduce.elements
            rollout, fused, carry, scene = dryrun.fleet_programs(
                group, 0, 1, device, graph)
            args = {"xla": (carry, scene), "fused": (carry,)}
            programs[graph] = {key: (run, args[key], run(*args[key]))
                               for key, run in (("xla", rollout),
                                                ("fused", fused))}
            counts[graph] = (mesh.fleet_all_reduce.calls - before[0],
                             mesh.fleet_all_reduce.elements - before[1])
        log(f"NCCL dry run: fleet_all_reduce (calls, elements) captured "
            f"{counts[True]} (2 programs x warm-up and capture x 3), eager "
            f"{counts[False]} (3 cycles x 3)")
        check(counts[True] == (2 * 2 * 3,) * 2 and counts[False] == (3 * 3,) * 2,
              "NCCL dry run: not three one-element all-reduces per captured "
              "step and per eager cycle")
        for key in ("xla", "fused"):
            run, args, got = programs[True][key]
            twin, _, want = programs[False][key]
            check(run.graph and not twin.graph
                  and run.replays == run.n_cycles, f"NCCL dry run {key}: "
                  f"graph {run.graph}/{twin.graph}, {run.replays} replays")
            assert_bit_identical(torch, f"NCCL dry run {key}", got, want)
            n_ops = same_device_ops(torch, f"NCCL dry run {key}", run, twin,
                                    args)
            log(f"NCCL dry run {key}: captured == eager bit for bit "
                f"({run.n_cycles} cycles, graph pool {run.pool_bytes} B); a "
                f"replay launches {n_ops} device operations, the eager twin "
                f"as many ({n_ops / run.n_cycles:.0f} per cycle)")
        x = torch.ones((), device=device)
        step = CapturedStep(lambda: mesh.fleet_all_reduce(x, group), device)
        step()
        for label, fn in (("eager", lambda: mesh.fleet_all_reduce(x, group)),
                          ("replayed", step)):
            log(f"NCCL one fleet_all_reduce, {label}: device operations "
                f"{kernel_executions(torch, fn, '', 0, attempts=1)[1]}")
        check(float(step()) == float(mesh.fleet_all_reduce(x, group)) == 1.0,
              "NCCL all-reduce of a world of one is not the identity")
    finally:
        dist.destroy_process_group()
    report = scaling.measure_scaling("cuda")
    for row in report["sweep"]:
        log(f"measure_scaling on {report['device']}: n={row['devices']} "
            f"F={row['problems']} K={report['candidates_per_cycle']} "
            f"{row['throughput_evals_per_sec']:.6g} candidate-evals/s, "
            f"{row['time_s'] * 1e3:.3f} ms per {report['cycles']}-cycle "
            f"rollout, efficiency {row['efficiency']:.3f}")


def phase_probe(torch):
    """13. The T=61 launch-overhead probe: phases A, C and D, the probe
    kernel against its plain version and one torch.add."""
    from commonroad_rp_tpu_torch.ops import scoring
    from commonroad_rp_tpu_torch.probes import t61_overhead

    ops = t61_overhead.probe_operands(60, "cuda", HERE)
    inp = scoring.prepare_inputs(*ops["args"], 20.0, 0.0, 5.0,
                                 ops["ref_s_last"], n_steps=60)
    v = torch.full((), 20.0, dtype=torch.float32, device="cuda")
    got = scoring.trivial_probe(inp, v)
    want = scoring.trivial_probe_reference(inp, v)
    torch.cuda.synchronize()
    max_err = float((got - want).abs().max())
    check(bool(torch.equal(got, want)),
          f"probe kernel differs from its plain version by {max_err}")
    reps, n_scan = 5, 150
    reset_launch_counts()
    phases = t61_overhead.run_phases(ops, n_scan, reps, "cuda")
    launches = scoring.trivial_probe.launches
    check(launches == scoring.score_candidates.launches
          == (reps + 1) * n_scan,
          f"probe: {launches} probe and {scoring.score_candidates.launches} "
          f"scorer launches for {reps + 1} runs of {n_scan}")
    for name, (us, rate) in phases.items():
        log(f"probe T=61 K={ops['K']} {name}: {us:.1f} us/launch, "
            f"{rate:.2f} M cands/s (best of {reps} runs of {n_scan} launches, "
            "one synchronize per run)")
    K = ops["K"]
    c = v + inp.table[0, 0] + (inp.obs[0, 0, 0] if inp.obs.shape[0] else 0.0)
    cl0 = inp.coeffs_lon[:, 0]
    args = (inp.coeffs_lon.data_ptr(), inp.table.data_ptr(),
            inp.obs.data_ptr(), inp.obs.shape[0], v.data_ptr(), K)
    with uncounted():
        # one call between two CUDA events each, in turns so that the card's
        # state is shared: the wrapper as the scans and plan() pay it,
        # torch.add, the same launch path with nothing launched (crp_empty in
        # the kernel's place), and the event pair around nothing
        timed = {
            "kernel": lambda: scoring.trivial_probe(inp, v),
            "torch.add": lambda: torch.add(cl0, c),
            "empty call": lambda: scoring._launch(
                scoring.trivial_probe, "crp_empty", "empty call", inp, args,
                (K,)),
            "events alone": lambda: None,
            "plain": lambda: scoring.trivial_probe_reference(inp, v)}
        rounds = [{name: cuda_time_ms(torch, fn, KERNEL_REPS // 2)
                   for name, fn in timed.items()} for _ in range(4)]
    t = {name: statistics.median(r[name] for r in rounds) for name in timed}
    with uncounted():
        dev_ms = device_kernel_ms(torch, timed["kernel"], "trivial_kernel")
    bound_ms, bound_by = bound_of(3 * K, 8 * K + 12)
    log(f"time probe kernel K={K}: {t['kernel']:.4f} ms per "
        f"scoring.trivial_probe call, plain {t['plain']:.4f} ms, torch.add "
        f"{t['torch.add']:.4f} ms; floor: the same launch path with nothing "
        f"launched {t['empty call']:.4f} ms, the event pair alone "
        f"{t['events alone']:.4f} ms; device time of the kernel "
        f"{dev_text(dev_ms)} (profiler); bound {bound_ms:.6f} ms by "
        f"{bound_by} "
        f"(medians of 4 rounds of {KERNEL_REPS // 2} calls, taken in turns)")
    return dict(launches=launches, max_err=max_err, ms=t["kernel"],
                dev_ms=dev_ms, plain_ms=t["plain"], library_ms=t["torch.add"],
                bound_ms=bound_ms, bound_by=bound_by, phases=phases)


def capture_drive(torch, capture: bool, out_dir, device="cuda", graph=True,
                  programs=None):
    """ZAM_Over through ``plan()`` on the card, with or without trajectory-set
    capture (``graph=False``: the uncaptured twin; ``programs``: reuse built
    level programs): (planner, drive result, per-step record, capture
    records, launch counts).  A capture record is (CUDA-event ms, the
    window had obstacles, the bundle)."""
    from commonroad_rp_tpu_torch.ops import collision_kernel as ck
    from commonroad_rp_tpu_torch.ops import scoring
    from commonroad_rp_tpu_torch.run_planner import (drive_to_goal,
                                                     load_config,
                                                     make_planner)

    config = load_config("ZAM_Over-1_1", HERE)
    configure_capture(config, capture, out_dir)
    planner = make_planner(config, device=device, graph=graph)
    if programs is not None:
        planner.level_programs = programs
    captures = []
    if capture:
        inner = planner._capture_bundle_fast

        def timed(batch, goal_valid):
            obstacles = planner.collision_checker.obstacles_for_window(
                planner.x_0.time_step, planner.N, config.planning.factor)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            inner(batch, goal_valid)
            end.record()
            end.synchronize()
            captures.append((start.elapsed_time(end),
                             obstacles.pose.shape[0] > 0,
                             planner.stored_trajectories))
        planner._capture_bundle_fast = timed
    record = []
    reset_launch_counts()
    result = drive_to_goal(planner, max_steps=300,
                           on_step=lambda _: record.append(
                               (planner.infeasible_count_kinematics,
                                planner.infeasible_count_collision,
                                dict(planner.infeasible_reason_dict),
                                planner.optimal_cost)))
    torch.cuda.synchronize()
    launches = (scoring.score_candidates.launches, ck.obb_collision.launches)
    return planner, result, record, captures, launches


def configure_capture(config, capture: bool, out_dir=None):
    """Trajectory-set capture on (``draw_traj_set`` with ``save_plots``,
    output under ``out_dir``) or off."""
    config.debug.draw_traj_set = capture
    config.debug.save_plots = capture
    if out_dir is not None:
        config.general.path_output = str(out_dir) + "/"


def assert_bundle_matches(got, want):
    """The bar of tests/test_fast_scoring.py:501-507 (the CPU test's)."""
    check(got.x.shape == want.x.shape, "capture: bundle shapes differ")
    check(np.array_equal(got.feasible, want.feasible)
          and np.array_equal(got.collides, want.collides),
          "capture: feasible/colliding labels differ from the conformance "
          "bundle")
    np.testing.assert_allclose(got.x, want.x, atol=1e-3)
    np.testing.assert_allclose(got.y, want.y, atol=1e-3)
    np.testing.assert_allclose(got.costs[want.feasible],
                               want.costs[want.feasible], rtol=1e-4)
    return float(max(np.abs(got.x - want.x).max(),
                     np.abs(got.y - want.y).max()))


def write_drive_plots(planner, bundles, out_dir):
    """Timestep plots of the first cycles (with their captured bundles), the
    final trajectory and the state and input plots of a drive; returns the
    paths."""
    from commonroad_rp_tpu_torch.utils import evaluation
    from commonroad_rp_tpu_torch.utils import visualization as viz

    cfg = planner.config
    freq = cfg.planning.replanning_frequency
    written = []
    for i, bundle in enumerate(bundles):
        t = i * freq
        ego = planner.convert_state_list_to_commonroad_object(
            planner.record_state_list[t:])
        written.append(out_dir / f"timestep_{t}.png")
        viz.visualize_planner_at_timestep(
            cfg.scenario, cfg.planning_problem, ego, timestep=t,
            traj_set=bundle, ref_path=planner.reference_path,
            save_path=str(written[-1]))
    written.append(out_dir / "final_trajectory.png")
    viz.plot_final_trajectory(cfg.scenario, cfg.planning_problem,
                              planner.record_state_list,
                              save_path=str(written[-1]))
    written.append(out_dir / "states.png")
    evaluation.plot_states(cfg, planner.record_state_list,
                           save_path=str(written[-1]))
    written.append(out_dir / "inputs.png")
    evaluation.plot_inputs(cfg, planner.record_input_list,
                           save_path=str(written[-1]))
    return written


def phase_capture(torch, device="cuda"):
    """14. Trajectory-set capture on the card: ZAM_Over to the goal through
    ``plan()`` with ``draw_traj_set`` and ``save_plots`` against the same
    drive without capture, the first bundle against the card's float32
    conformance bundle, the collision kernel's launches, the capture's time,
    and every plot and the solution file written from the drive."""
    from commonroad_rp_tpu_torch.run_planner import load_config, make_planner
    from commonroad_rp_tpu_torch.utils import evaluation, solution_writer

    out_dir = HERE / "output" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    runs = {flag: capture_drive(torch, flag, out_dir, device)
            for flag in (False, True)}
    planner, result, record, captures, launches = runs[True]
    _, result_off, record_off, _, launches_off = runs[False]
    twin = capture_drive(torch, True, out_dir, device, graph=False)
    want = EXPECTED_STEPS["ZAM_Over-1_1"]
    log(f"capture drive: goal_reached={result['goal_reached']} steps="
        f"{result['steps']} plan() calls={result['plan_calls']} captures="
        f"{len(captures)}; launches (scorer, collision) {launches} with "
        f"capture, {launches_off} without (the warm-ups' and the captured "
        "ones)")
    check(result["goal_reached"] and result["steps"] == want,
          f"capture drive: expected the goal in {want} steps")
    check(result_off["steps"] == result["steps"], "capture changed the "
          "step count")
    states = lambda p: np.array([[s.position[0], s.position[1], s.velocity,
                                  s.orientation, s.acceleration]
                                 for s in p.record_state_list])
    check(np.array_equal(states(planner), states(runs[False][0])),
          "capture changed the selected states")
    check(record == record_off, "capture changed the counters or reasons")
    check(len(captures) == result["plan_calls"], "not every cycle captured")
    with_obstacles = sum(c[1] for c in captures)
    # the capture bundle through its level program, bit for bit the twin's
    check(np.array_equal(states(planner), states(twin[0]))
          and record == twin[2] and len(twin[3]) == len(captures)
          and all(np.array_equal(a, b) for g, w in zip(captures, twin[3])
                  for a, b in zip(bundle_arrays(g[2]), bundle_arrays(w[2]))),
          "capture: the captured drive's states, counters or bundles "
          "differ from the uncaptured twin's")
    built = list(planner.level_programs.values())
    fused = sum(p.kind == "fast" for p in built)
    bundles_obs = sum(p.kind == "level"
                      and p._args.obstacles.pose.shape[0] > 0 for p in built)
    check(launches[0] == launches_off[0] == 2 * fused > 0,
          f"capture: {launches[0]} scorer launches for {fused} captured "
          "fused programs")
    check(launches_off[1] == 0 and launches[1] == 2 * bundles_obs > 0,
          f"capture: {launches[1]} collision-kernel launches for "
          f"{bundles_obs} captured bundle programs with obstacles")
    warm_drive = lambda: capture_drive(torch, True, out_dir, device,
                                       programs=planner.level_programs)
    n_exec, names = kernel_executions(torch, warm_drive, COLLISION_KERNEL,
                                      with_obstacles, warm=False)
    check(n_exec == with_obstacles,
          f"capture: {n_exec} collision-kernel executions for "
          f"{with_obstacles} captures with obstacles ({names})")
    n_score, names = kernel_executions(torch, warm_drive, SCORE_KERNEL,
                                       result["plan_calls"], warm=False)
    check(n_score == result["plan_calls"],
          f"capture: {n_score} score_kernel executions for "
          f"{result['plan_calls']} plan() calls ({names})")
    log(f"capture drive: captured == uncaptured bit for bit (states, "
        f"counters, reasons, {len(captures)} bundles); a warm drive: "
        f"{n_exec} collision-kernel executions for {with_obstacles} "
        f"captures with obstacles, {n_score} score_kernel executions for "
        f"{result['plan_calls']} plan() calls (profiler)")
    replay_at_new_speed(torch, "capture replay at a new speed",
                        "ZAM_Over-1_1", configure=lambda c: configure_capture(
                            c, True, out_dir))

    # the first cycle's bundle against the card's conformance float32 one
    config = load_config("ZAM_Over-1_1", HERE)
    config.debug.fast_scoring = False
    config.debug.kernel_dtype = "float32"
    config.debug.draw_traj_set = True
    config.debug.save_plots = True
    conformance = make_planner(config, device=device)
    conformance.set_desired_velocity(current_speed=conformance.x_0.velocity)
    check(conformance.plan() is not None, "conformance float32: no plan")
    err = assert_bundle_matches(captures[0][2],
                                conformance.stored_trajectories)
    ms = [c[0] for c in captures]
    log(f"capture: first bundle K={captures[0][2].x.shape[0]} against the "
        f"card's float32 conformance bundle: labels identical, max |x, y "
        f"diff| {err:.3e} m; extra time per cycle (CUDA events) median "
        f"{statistics.median(ms):.4f} ms, mean {statistics.mean(ms):.4f} ms, "
        f"first {ms[0]:.4f} ms over {len(ms)} cycles; plan() p50 "
        f"{1e3 * statistics.median(result['planning_times'][1:]):.3f} ms with"
        f" capture, {1e3 * statistics.median(result_off['planning_times'][1:]):.3f}"
        f" ms without (host clock)")

    # plots (where matplotlib is installed) and the solution file
    cfg = planner.config
    written = []
    if importlib.util.find_spec("matplotlib") is None:
        log("capture: matplotlib is not installed on this host: the six "
            "plots are not written (tests/test_torch_visualization.py holds "
            "every plot pixel for pixel against the JAX package on the CPU)")
    else:
        written = write_drive_plots(planner, [c[2] for c in captures[:3]],
                                    out_dir)
    for path in written:
        check(path.stat().st_size > 10_000, f"plot {path} is too small")
    solution, feasible = evaluation.run_evaluation(
        cfg, planner.record_state_list, planner.record_input_list)
    solution_path = out_dir / "solution_ZAM_Over-1_1.xml"
    solution_writer.write_solution_file(solution, str(solution_path))
    back = solution_writer.read_solution_file(str(solution_path))
    back_states = back.planning_problem_solutions[0].trajectory.state_list
    want_states = solution.planning_problem_solutions[0].trajectory.state_list
    check(len(back_states) == len(want_states) == want + 1,
          "solution file: wrong state count")
    np.testing.assert_allclose([s.position for s in back_states],
                               [s.position for s in want_states], atol=1e-9)
    ok, detail = evaluation.valid_solution(cfg.scenario,
                                           cfg.planning_problem_set, back)
    check(all(feasible) and ok, f"run_evaluation failed: feasible "
          f"{sum(feasible)}/{len(feasible)}, valid {ok} {detail}")
    log(f"capture: wrote {len(written)} plots and {solution_path.name} under "
        f"{out_dir.relative_to(HERE)}; the file reads back ({len(back_states)}"
        f" states), {sum(feasible)}/{len(feasible)} transitions feasible, "
        f"valid_solution {ok}")
    return dict(launches=launches, capture_ms=statistics.median(ms),
                captures=len(captures), with_obstacles=with_obstacles)


def phase_fleet_resume(torch, fused, cycles=150, device="cuda"):
    """15. The fused fleet1024 scan resumed from a checkpoint: 75 cycles,
    ``save_fleet_carry``, ``load_fleet_carry(device="cuda")``, 75 more,
    against the uninterrupted 150-cycle scan (phase 8's scene and carry):
    the final carry and the per-cycle metrics bit for bit, and the goal
    outcome member for member."""
    from commonroad_rp_tpu_torch.ops import scoring
    from commonroad_rp_tpu_torch.parallel.fleet import FleetCarry
    from commonroad_rp_tpu_torch.run_fleet import (goal_counts, make_scan,
                                                   member_outcomes)
    from commonroad_rp_tpu_torch.utils import checkpoint

    scene, carry, goals, base_idx = fused["fleet"]
    half = cycles // 2
    full_run, _ = make_scan(scene, cycles)
    half_run, _ = make_scan(scene, half)
    full_carry, full_metrics = no_sync(torch, lambda: full_run(carry))
    torch.cuda.synchronize()
    path = HERE / "output" / "chip_smoke" / "fleet1024_carry.npz"
    path.parent.mkdir(parents=True, exist_ok=True)
    reset_launch_counts()
    t0 = time.time()
    mid_carry, first = no_sync(torch, lambda: half_run(carry))
    checkpoint.save_fleet_carry(mid_carry, half, str(path))
    loaded, cycle = checkpoint.load_fleet_carry(str(path), device=device)
    check(cycle == half and all(getattr(loaded, f).device.type == device
                                for f in FleetCarry._fields),
          "fleet1024 resume: the carry did not load onto the card")
    end_carry, second = no_sync(torch, lambda: half_run(loaded))
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = scoring.score_fleet.launches
    check(launches == 2 and half_run.replays == cycles,
          f"fleet1024 resume: {launches} fleet launches (the warm-up's and "
          f"the captured one) and {half_run.replays} replays for {cycles} "
          "cycles")
    raw = lambda t: t.detach().cpu().numpy().tobytes()
    for field in FleetCarry._fields:
        check(raw(getattr(end_carry, field)) == raw(getattr(full_carry,
                                                            field)),
              f"fleet1024 resume: final carry field {field} differs")
    resumed = tuple(torch.cat([a, b]) for a, b in zip(first, second))
    for i, (a, b) in enumerate(zip(resumed, full_metrics)):
        check(a.dtype == b.dtype and a.shape == b.shape and raw(a) == raw(b),
              f"fleet1024 resume: metric {i} differs from the "
              f"uninterrupted scan")
    outcomes = member_outcomes(resumed, goals, base_idx)
    check(outcomes == member_outcomes(full_metrics, goals, base_idx),
          "fleet1024 resume: member outcomes differ")
    counts = goal_counts(resumed, goals, base_idx, outcomes=outcomes)
    log(f"fleet1024 resume: {half} + {half} cycles through {path.name} "
        f"({path.stat().st_size} B), {launches} fleet launches and "
        f"{half_run.replays} replays of the captured cycle, "
        f"{wall:.3f} s; final carry and {len(resumed)} metric rows "
        f"bit-identical to the {cycles}-cycle scan (whose member outcomes "
        f"{'equal' if outcomes == fused['outcomes'] else 'DIFFER FROM'} "
        f"phase 8's); goals "
        + ", ".join(f"{n} {c['reached']}/{c['total']}"
                    for n, c in counts.items()))
    return dict(launches=launches)


def phase_oracle(torch, device="cuda"):
    """16. The numpy oracle at full width: every sampling level of
    ZAM_Over's first cycle through the card's float64 rollout and default
    cost and through ``baseline.oracle`` on the host: identical feasibility
    and reasons, arrays and costs within 1e-9, the same argmin."""
    from commonroad_rp_tpu_torch.baseline import oracle
    from commonroad_rp_tpu_torch.ops import cost as cost_ops
    from commonroad_rp_tpu_torch.ops import kinematics
    from commonroad_rp_tpu_torch.run_planner import load_config, make_planner

    config = load_config("ZAM_Over-1_1", HERE)
    config.debug.kernel_dtype = "float64"
    planner = make_planner(config, device=device)
    planner.set_desired_velocity(current_speed=planner.x_0.velocity)
    x0_lon, x0_lat = planner.begin_cycle()
    veh = planner._vehicle_arrays()
    ref = oracle.OracleRefPath.from_tables(planner.coordinate_system.tables)
    cf = planner.cost_function
    cost_kw = dict(w_a=float(cf.w_a), desired_d=float(cf.desired_d),
                   desired_speed=float(planner._desired_speed))
    reason_by_code = {**kinematics.REASON_NAMES,
                      kinematics.REASON_DOMAIN: "domain"}
    keys = ("x", "y", "theta_gl", "theta_cl", "v", "a", "kappa_gl",
            "kappa_dot", "s", "s_dot", "s_ddot", "d", "d_dot", "d_ddot")
    f64 = lambda a, dtype=torch.float64: torch.as_tensor(
        np.asarray(a), dtype=dtype, device=device)
    total, t_host, max_err = 0, 0.0, 0.0
    for level in range(1, planner.sampling_level):
        batch = planner._create_trajectory_bundle(x0_lon, x0_lat, level)
        res = kinematics.rollout(
            f64(batch.coeffs_lon), f64(batch.coeffs_lat),
            f64(batch.traj_len, torch.int64), planner.coordinate_system.tables,
            veh, float(planner.x_0.orientation), planner.dt, planner.N,
            planner._low_vel_mode)
        costs = cost_ops.default_cost(res, **cost_kw).cpu().numpy()
        t0 = time.time()
        cands = oracle.evaluate_batch(
            batch, ref, oracle.OracleVehicle(*veh),
            float(planner.x_0.orientation), planner.dt, planner.N,
            planner._low_vel_mode, config.planning.constraints_to_check,
            **cost_kw)
        t_host += time.time() - t0
        feasible = res.feasible.cpu().numpy()
        reasons = res.reason.cpu().numpy()
        check(np.array_equal(feasible, [c.feasible for c in cands]),
              f"oracle level {level}: feasibility differs")
        check(all(reason_by_code[int(reasons[k])] == c.reason
                  for k, c in enumerate(cands) if not c.feasible),
              f"oracle level {level}: reasons differ")
        arrays = {key: getattr(res, key).cpu().numpy() for key in keys}
        for k, cand in enumerate(cands):
            if cand.feasible:
                for key in keys:
                    np.testing.assert_allclose(arrays[key][k],
                                               cand.arrays[key], rtol=1e-9,
                                               atol=1e-9)
                    max_err = max(max_err, float(np.abs(
                        arrays[key][k] - cand.arrays[key]).max()))
        want = np.array([c.cost for c in cands])
        np.testing.assert_allclose(costs[feasible], want[feasible],
                                   rtol=1e-9, atol=1e-9)
        check(int(np.argmin(np.where(feasible, costs, np.inf))) ==
              int(np.argmin(np.where(feasible, want, np.inf))),
              f"oracle level {level}: argmin differs")
        total += batch.size
        log(f"oracle level {level}: K={batch.size}, {int(feasible.sum())} "
            f"feasible; feasibility, reasons and argmin identical")
    log(f"oracle: {total} candidates, card float64 rollout and cost against "
        f"the host oracle within 1e-9 (max |array diff| {max_err:.3e}); "
        f"oracle host time {t_host:.2f} s")


def phase_primitives_native(torch, device="cuda"):
    """17. The six device primitives on the card against their CPU results
    (float64 1e-9, float32 2e-4), and the C++ host module: built with the
    host's g++, which ``nvcc`` also uses (a failed build fails the run)."""
    from commonroad_rp_tpu_torch import native
    from commonroad_rp_tpu_torch.ops import frenet, polynomial
    from commonroad_rp_tpu_torch.run_planner import load_config, make_planner

    planner = make_planner(load_config("ZAM_Over-1_1", HERE), device="cpu")
    polyline = planner.coordinate_system.reference
    rng = np.random.default_rng(0)
    c = rng.normal(size=(2754, 6)) * [10.0, 5.0, 1.0, 0.5, 0.1, 0.02]
    tau = rng.uniform(-1.0, 7.0, size=(21, 2754))
    t_end = rng.uniform(0.4, 6.0, size=2754)
    s_last = float(frenet.from_polyline(polyline).s[-1])
    s = rng.uniform(-5.0, s_last + 5.0, 4096)
    idx_pts = rng.integers(2, len(polyline) - 2, 1024)
    pts = polyline[idx_pts] + rng.uniform(-3.0, 3.0, (1024, 2))
    worst = {}
    for dtype, tol in ((torch.float64, 1e-9), (torch.float32, 2e-4)):
        outs = {}
        for where in ("cpu", device):
            T = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype,
                                          device=where)
            ref = frenet.from_polyline(polyline, dtype=dtype, device=where)
            idx = frenet.interp_index(ref, T(s))
            lam = frenet.interp_fraction(ref, T(s), idx)
            outs[where] = dict(
                eval_jerk=polynomial.eval_jerk(T(c)[None], T(tau)),
                squared_jerk_integral=polynomial.squared_jerk_integral(
                    T(c), T(t_end)),
                evaluate_state_at_tau=polynomial.evaluate_state_at_tau(
                    T(c)[None], T(tau), 0.5, 4.0),
                interp_fraction=lam,
                interp_table=frenet.interp_table(ref.curv, idx, lam),
                to_curvilinear=torch.stack(frenet.to_curvilinear(
                    ref, T(pts[:, 0]), T(pts[:, 1]))))
        for name, cpu in outs["cpu"].items():
            gpu = outs[device][name]
            check(gpu.device.type == device,
                  f"{name} did not run on the card")
            np.testing.assert_allclose(gpu.cpu().numpy(), cpu.numpy(),
                                       rtol=tol, atol=tol, err_msg=name)
            rel = float(((gpu.cpu() - cpu).abs() /
                         cpu.abs().clamp(min=1.0)).max())
            worst[name] = max(worst.get(name, 0.0), rel)
    log("primitives on the card against the CPU (max relative diff, both "
        "dtypes): " + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()))

    ok = native.available()
    log(f"native.available(): {ok} ({native.library_path().name}); "
        f"build: {(native.build_log or 'built before this run').splitlines()[0]}")
    check(ok, f"the native library did not build:\n{native.build_log}")
    ref64 = frenet.from_polyline(polyline)
    s_n, d_n, _ = native.clcs_project(ref64.points.numpy(), ref64.s.numpy(),
                                      ref64.tangent.numpy(),
                                      ref64.normal.numpy(), pts)
    s_t, d_t = frenet.to_curvilinear(ref64, torch.as_tensor(pts[:, 0]),
                                     torch.as_tensor(pts[:, 1]))
    np.testing.assert_allclose(s_n, s_t.numpy(), atol=1e-9)
    np.testing.assert_allclose(d_n, d_t.numpy(), atol=1e-9)
    log("native projection against to_curvilinear: within 1e-9 on 1024 "
        "points")


def device_kernel_ms(torch, fn, name, reps=20, attempts=5):
    """Device time (ms) per call of ``fn`` spent in the kernels whose name
    contains ``name`` (every kernel for ""): ``torch.profiler`` device
    events over ``reps`` warm calls, the trace taken again (up to
    ``attempts`` times) while it holds no such event; None when none did.
    A named kernel, launched once per call, is timed as the mean of the
    launches the trace kept (the profiler drops events now and then)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = [evt for evt in prof.key_averages()
                   if evt.device_type == DeviceType.CUDA and name in evt.key]
        device_us = sum(float(evt.self_device_time_total) for evt in kernels)
        if device_us > 0:
            break
    calls = sum(evt.count for evt in kernels) if name else reps
    return device_us / 1e3 / calls if device_us > 0 else None


def device_busy_share(torch, fn):
    """Device busy share of ``fn`` as text: the device time of its kernels
    (``torch.profiler``, device events only: an operator's row repeats its
    kernels' time) over the wall time of an unprofiled run (the profiler
    stretches the host side)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.time()
    fn()
    torch.cuda.synchronize()
    wall = time.time() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    device_us = sum(float(evt.self_device_time_total)
                    for evt in prof.key_averages()
                    if evt.device_type == DeviceType.CUDA)
    if device_us <= 0.0:
        return "not measured (no device events in the trace)"
    return (f"{device_us / 1e3 / (wall * 1e3):.3f} ({device_us / 1e3:.2f} ms "
            f"of kernels in {wall * 1e3:.2f} ms of unprofiled wall)")


def profile_plans(torch, out_dir):
    """torch.profiler over three warm ZAM_Over plan() calls."""
    from commonroad_rp_tpu_torch.run_planner import load_config, make_planner
    from commonroad_rp_tpu_torch.utils.profiling import device_trace

    planner = make_planner(load_config("ZAM_Over-1_1", HERE), device="cuda")
    planner.set_desired_velocity(current_speed=planner.x_0.velocity)
    planner.plan()
    torch.cuda.synchronize()
    with device_trace(out_dir) as prof:
        for _ in range(3):
            planner.plan()
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=25)
    pathlib.Path(out_dir, "key_averages.txt").write_text(table)
    log(f"profile: {out_dir}/trace.json, {out_dir}/key_averages.txt")


def memoize_road_boundaries(torch):
    """Compile each scenario's road boundary once per run: the many
    planners this script builds share ``ops.collision.compile_road_boundary``
    memoized on the scenario, dtype and device.  It is a planner's set-up
    outside ``plan()`` (seconds of point-in-polygon tests in Python per
    planner), and the tensors it returns are never written."""
    from commonroad_rp_tpu_torch.ops import collision as collision_ops

    inner = collision_ops.compile_road_boundary
    memo = {}

    def compile_once(scenario, dtype=torch.float64, device="cpu"):
        key = (scenario.scenario_id, dtype, str(torch.device(device)))
        if key not in memo:
            memo[key] = inner(scenario, dtype=dtype, device=device)
        return memo[key]

    collision_ops.compile_road_boundary = compile_once


def logging_off():
    import logging
    logging.getLogger("RP_LOGGER").setLevel(logging.CRITICAL)


if __name__ == "__main__":
    os.chdir(HERE)
    sys.exit(main())
