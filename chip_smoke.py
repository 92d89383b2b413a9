#!/usr/bin/env python3
"""Smoke run of the PyTorch port's main path on one CUDA card.

Run from the repository root:

    python3 chip_smoke.py [--profile DIR]

Phases (any failure raises and ends the run with a non-zero exit code):

1. environment: torch, CUDA, nvcc and triton versions, the card's name and
   power limit from nvidia-smi;
2. build: ``commonroad_rp_tpu_torch/csrc/scoring.cu`` with nvcc for sm_90a;
3. kernel against its plain PyTorch version on the card: ZAM_Over-1_1's
   first planning cycle (the main path's shape), then a synthetic scene with
   OBB, disc and polygon obstacles at T=21 and T=61;
4. the main path: ``ReactivePlanner(device="cuda")`` drives ZAM_Over-1_1
   (and the other three bundled scenarios) through the host replanning loop
   to the goal in the JAX fast path's step counts; the kernel's launch count
   must equal the number of ``plan()`` calls, and the first cycle's winner
   must match the CPU plain-version planner on the same inputs;
5. times: kernel and plain version at both shapes (CUDA events, warm,
   medians), and ``plan()`` p50/p90 over the drives' calls;
6. the fleet kernel against its plain version on the card: the 12-problem
   fleet (4 scenarios x 3 vehicle types, level 3, T=21), first cycle, at
   the bar of phase 3; then a 10-cycle fleet scan through the kernel
   against the same scan through the plain version (identical ``alive``,
   states within 2e-3);
7. ``plan_scan`` on the card: the four scenarios reach their goals in one
   ``plan_scan`` of the JAX package's cycle count each (9/12/15/49 cycles,
   27/35/44/146 steps) with one kernel launch per cycle, each scan first
   run under ``torch.cuda.set_sync_debug_mode("error")`` (no cycle reads
   the device); ZAM_Over at T=61 through the kernel against the plain
   version (same found flags, states within 5e-3); ms/cycle at T=21 and
   T=61;
8. the 1024-problem heterogeneous fleet at full width (K=2754 per problem,
   150 cycles at replanning frequency 1): one fleet-kernel launch per
   cycle, no device read between cycles, per-scenario goal counts beside
   the JAX package's, the fleet kernel's and the plain version's times,
   candidate-evals/s of the warm scan and the device's busy share.

The card's name and power limit, then a JSON object of per-kernel results,
come on the two lines before the last; the last line is ``{"ok": true,
"device": {...}}``.  Without a card, or outside a checkout of the
repository, the run fails before printing any of them.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
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


def prepared_in_domain(torch, inp):
    """Candidates of prepared operands (one problem or a fleet) whose
    active steps all lie in [0, s_last]."""
    from commonroad_rp_tpu_torch.ops import scoring

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


def captured_operands(run_scan):
    """The scorer operands of a scan's first cycle: ``run_scan(scorer)``
    runs a one-cycle scan with the given scoring function."""
    from commonroad_rp_tpu_torch.ops import scoring

    captured = []

    def capture(inp):
        captured.append(inp)
        return scoring.score_prepared_reference(inp)

    run_scan(capture)
    return captured[0]


def time_prepared(torch, inp, kernel_reps, plain_reps):
    """(kernel ms, plain ms) on prepared operands, launches not counted."""
    from commonroad_rp_tpu_torch.ops import scoring

    counts = (scoring.score_candidates.launches, scoring.score_fleet.launches)
    k_ms = cuda_time_ms(torch, lambda: scoring.score_prepared(inp),
                        kernel_reps)
    p_ms = cuda_time_ms(torch, lambda: scoring.score_prepared_reference(inp),
                        plain_reps)
    scoring.score_candidates.launches, scoring.score_fleet.launches = counts
    return k_ms, p_ms


def no_sync(torch, fn):
    """fn() with every synchronizing CUDA call raising (the scan loops must
    not read the device between cycles)."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)


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
    from commonroad_rp_tpu_torch.run_planner import (drive_to_goal,
                                                     load_config,
                                                     make_planner)

    pkg_root = pathlib.Path(commonroad_rp_tpu_torch.__file__).resolve()
    if pkg_root.parent.parent != HERE:
        raise RuntimeError(f"commonroad_rp_tpu_torch imported from "
                           f"{pkg_root}, not from this checkout {HERE}")
    logging_off()
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. environment
    smi = environment(torch)

    # ---- 2. build
    t0 = time.time()
    lib_path = scoring.build_library()
    log(f"build: {lib_path.relative_to(HERE)} in {time.time() - t0:.1f} s")
    if scoring.build_log:
        for line in scoring.build_log.splitlines():
            if "ptxas" in line or "error" in line.lower():
                log("  " + line.strip())

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
    plan_ms, first_ms = [], []
    launches = None
    for name, want_steps in EXPECTED_STEPS.items():
        planner = make_planner(load_config(name, HERE), device="cuda")
        scoring.score_candidates.launches = 0
        result = drive_to_goal(planner, max_steps=300)
        torch.cuda.synchronize()
        n_launch = scoring.score_candidates.launches
        log(f"drive {name}: goal_reached={result['goal_reached']} steps="
            f"{result['steps']} plan() calls={result['plan_calls']} kernel "
            f"launches={n_launch}")
        check(result["goal_reached"], f"{name} did not reach its goal")
        check(result["steps"] == want_steps,
              f"{name}: expected {want_steps} steps, got {result['steps']}")
        check(n_launch == result["plan_calls"] > 0,
              f"{name}: the scoring kernel did not run once per plan() call")
        if name == "ZAM_Over-1_1":
            launches = n_launch
        first_ms.append(1e3 * result["planning_times"][0])
        plan_ms += [1e3 * t for t in result["planning_times"][1:]]

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
        before = scoring.score_candidates.launches
        k_ms = cuda_time_ms(torch, lambda: scoring._launch(inp), KERNEL_REPS)
        p_ms = cuda_time_ms(torch, lambda: scoring._score_plain(inp),
                            PLAIN_REPS)
        scoring.score_candidates.launches = before
        K = args[0].shape[0]
        timing[label] = (k_ms, p_ms)
        log(f"time {label}: K={K} T={kw['n_steps'] + 1} kernel "
            f"{k_ms:.4f} ms ({K / k_ms * 1e3:.6g} candidate-evals/s), plain "
            f"{p_ms:.4f} ms")
    q = np.percentile(plan_ms, [50, 90])
    log(f"plan(): p50 {q[0]:.3f} ms, p90 {q[1]:.3f} ms over {len(plan_ms)} "
        f"calls of the four drives (first call of each drive, excluded: "
        f"{', '.join(f'{x:.1f}' for x in first_ms)} ms)")

    if opts.profile:
        profile_plans(torch, opts.profile)

    fleet_k = phase_fleet_kernel(torch)
    scan = phase_plan_scan(torch)
    fleet1024 = phase_fleet1024(torch)

    k_ms, p_ms = timing["main"]
    log(smi)
    log(json.dumps({"kernels": [{
        "name": "score_candidates",
        "route": "cuda",
        "source": "commonroad_rp_tpu_torch/csrc/scoring.cu",
        "replaces": "commonroad_rp_tpu/ops/pallas_cycle.py:490",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": p_ms}, {
        "name": "score_candidates (plan_scan, T=61)",
        "route": "cuda",
        "source": "commonroad_rp_tpu_torch/csrc/scoring.cu",
        "replaces": "commonroad_rp_tpu/ops/pallas_cycle.py:420",
        "launches": scan["launches61"],
        "max_abs_err": scan["max_err61"],
        "ms": scan["ms61"],
        "plain_ms": scan["plain_ms61"]}, {
        "name": "score_fleet",
        "route": "cuda",
        "source": "commonroad_rp_tpu_torch/csrc/scoring.cu",
        "replaces": "commonroad_rp_tpu/ops/pallas_cycle.py:455",
        "launches": fleet1024["launches"],
        "max_abs_err": max(fleet_k["max_err"], fleet1024["max_err"]),
        "ms": fleet1024["ms"],
        "plain_ms": fleet1024["plain_ms"]}]}))
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
        lambda scorer: make_scan(scene, 1, scorer=scorer)[0](carry))
    out_k = scoring.score_prepared(inp)
    out_p = scoring.score_prepared_reference(inp)
    torch.cuda.synchronize()
    max_err = compare(torch, "fleet F=12 first cycle", out_k, out_p,
                      prepared_in_domain(torch, inp))
    k_ms, p_ms = time_prepared(torch, inp, KERNEL_REPS, PLAIN_REPS)
    log(f"time fleet F=12: F x K={inp.coeffs_lon.shape[0]}x"
        f"{inp.coeffs_lon.shape[1]} T={inp.n_steps + 1} kernel {k_ms:.4f} "
        f"ms, plain {p_ms:.4f} ms")

    run_k, _ = make_scan(scene, 10)
    run_p, _ = make_scan(scene, 10,
                         scorer=scoring.score_prepared_reference)
    scoring.score_fleet.launches = 0
    final_k, metrics_k = no_sync(torch, lambda: run_k(carry))
    n_launch = scoring.score_fleet.launches
    final_p, metrics_p = run_p(carry)
    check(n_launch == 10, f"fleet scan: {n_launch} kernel launches for 10 "
          "cycles")
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


def phase_plan_scan(torch):
    """7. plan_scan on the card: the four scenarios to their goals, T=61
    kernel against plain, ms/cycle."""
    from commonroad_rp_tpu_torch.ops import scoring
    from commonroad_rp_tpu_torch.run_planner import load_config, make_planner

    for name, cycles in EXPECTED_CYCLES.items():
        planner = make_planner(load_config(name, HERE), device="cuda")
        planner.set_desired_velocity(current_speed=planner.x_0.velocity)
        run, carry = planner.scan_program(cycles)
        no_sync(torch, lambda: run(carry, float(planner._desired_speed)))
        planner.record_state_and_input(planner.x_0)
        scoring.score_candidates.launches = 0
        scoring.score_fleet.launches = 0
        info = planner.plan_scan(cycles)
        n_launch = scoring.score_candidates.launches
        log(f"plan_scan {name}: goal_reached={info['goal_reached']} "
            f"steps={info['steps']} cycles_run={info['cycles_run']} kernel "
            f"launches={n_launch} ({info['wall_time'] * 1e3:.1f} ms, first "
            "call of this scan)")
        check(info["goal_reached"], f"plan_scan {name}: goal not reached")
        check(info["steps"] == EXPECTED_STEPS[name],
              f"plan_scan {name}: {info['steps']} steps, expected "
              f"{EXPECTED_STEPS[name]}")
        check(n_launch == info["cycles_run"] == cycles
              and scoring.score_fleet.launches == 0,
              f"plan_scan {name}: {n_launch} launches for "
              f"{info['cycles_run']} cycles")

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
    _, metrics_k = no_sync(torch, lambda: run_k(carry, ds))
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
        lambda scorer: t61_planner().scan_program(1, scorer=scorer)[0](
            carry, ds))
    out_k = scoring.score_prepared(inp61)
    out_p = scoring.score_prepared_reference(inp61)
    torch.cuda.synchronize()
    max_err61 = compare(torch, "plan_scan T=61 union", out_k, out_p,
                        prepared_in_domain(torch, inp61))
    ms61, plain_ms61 = time_prepared(torch, inp61, KERNEL_REPS, PLAIN_REPS)
    log(f"time plan_scan T=61 union: K={inp61.coeffs_lon.shape[0]} kernel "
        f"{ms61:.4f} ms, plain {plain_ms61:.4f} ms")

    planner = t61_planner()
    planner.record_state_and_input(planner.x_0)
    scoring.score_candidates.launches = 0
    info = planner.plan_scan(n61)
    launches61 = scoring.score_candidates.launches
    log(f"plan_scan T=61 drive: goal_reached={info['goal_reached']} "
        f"steps={info['steps']} cycles_run={info['cycles_run']} kernel "
        f"launches={launches61}")
    check(launches61 == n61, "plan_scan T=61: one launch per cycle")

    for label, make in (("T=21", lambda: make_planner(
            load_config("ZAM_Over-1_1", HERE), device="cuda")),
            ("T=61", t61_planner)):
        planner = make()
        planner.set_desired_velocity(current_speed=planner.x_0.velocity)
        planner.plan_scan(12, record=False)
        times = []
        for _ in range(5):
            t0 = time.time()
            planner.plan_scan(12, record=False)
            times.append(time.time() - t0)
        log(f"plan_scan ms/cycle {label} ZAM_Over (12 cycles per call, warm, "
            f"median of 5, host clock incl. readback): "
            f"{statistics.median(times) / 12 * 1e3:.3f} "
            f"(min {min(times) / 12 * 1e3:.3f})")
        run, carry = planner.scan_program(12)
        ds = float(planner._desired_speed)
        log(f"plan_scan {label} device busy share over 12 cycles: "
            f"{device_busy_share(torch, lambda: run(carry, ds))}")
    return dict(launches61=launches61, max_err61=max_err61, ms61=ms61,
                plain_ms61=plain_ms61)


def phase_fleet1024(torch):
    """8. The 1024-problem heterogeneous fleet at full width."""
    from commonroad_rp_tpu_torch.ops import scoring
    from commonroad_rp_tpu_torch.run_fleet import (goal_counts,
                                                   heterogeneous_fleet,
                                                   make_scan)

    F, cycles = 1024, 150
    t0 = time.time()
    scene, carry, goals, base_idx = heterogeneous_fleet(F, cycles,
                                                        device="cuda",
                                                        root=HERE)
    run, K = make_scan(scene, cycles)
    log(f"fleet{F}: built in {time.time() - t0:.1f} s, K={K}, "
        f"{F * K} candidates per cycle")

    scoring.score_candidates.launches = 0
    scoring.score_fleet.launches = 0
    t0 = time.time()
    _, metrics = no_sync(torch, lambda: run(carry))
    torch.cuda.synchronize()
    first = time.time() - t0
    n_launch = scoring.score_fleet.launches
    check(n_launch == cycles and scoring.score_candidates.launches == 0,
          f"fleet1024: {n_launch} fleet launches for {cycles} cycles")
    walls = []
    for _ in range(2):
        t0 = time.time()
        _, metrics = run(carry)
        torch.cuda.synchronize()
        walls.append(time.time() - t0)
    wall = min(walls)
    log(f"fleet1024: {cycles} cycles, {n_launch} fleet-kernel launches; "
        f"first scan {first:.3f} s, warm {', '.join(f'{w:.3f}' for w in walls)}"
        f" s; {F * K * cycles / wall:.6g} candidate-evals/s (warm, best of "
        f"2), {wall / cycles * 1e3:.3f} ms/cycle")
    counts = goal_counts(metrics, goals, base_idx)
    for name, c in counts.items():
        log(f"fleet1024 {name}: {c['reached']}/{c['total']} reached"
            f"{', misses ' + str(c['misses']) if c['misses'] else ''} "
            f"(JAX package on the TPU: {JAX_FLEET1024[name]})")
    check(all(c["reached"] > 0 for c in counts.values()),
          "fleet1024: a scenario reached no goal")

    inp = captured_operands(
        lambda scorer: make_scan(scene, 1, scorer=scorer)[0](carry))
    out_k = scoring.score_prepared(inp)
    out_p = scoring.score_prepared_reference(inp)
    torch.cuda.synchronize()
    max_err = compare(torch, "fleet1024 first cycle", out_k, out_p,
                      prepared_in_domain(torch, inp))
    del out_p
    ms, plain_ms = time_prepared(torch, inp, 20, 3)
    log(f"time fleet F=1024: kernel {ms:.4f} ms "
        f"({F * K / ms * 1e3:.6g} candidate-evals/s), plain {plain_ms:.4f} "
        "ms")
    run3, _ = make_scan(scene, 3)
    log(f"fleet1024 device busy share over a 3-cycle scan: "
        f"{device_busy_share(torch, lambda: run3(carry))}")
    return dict(launches=n_launch, max_err=max_err, ms=ms,
                plain_ms=plain_ms)


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


def logging_off():
    import logging
    logging.getLogger("RP_LOGGER").setLevel(logging.CRITICAL)


if __name__ == "__main__":
    os.chdir(HERE)
    sys.exit(main())
