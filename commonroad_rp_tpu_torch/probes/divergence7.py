"""Measured validation of ``doc/conformance.md`` divergence 7.

Counterpart of ``scripts/divergence7_check.py``.  Claim under test: the
input-reconstruction failures on the T-junction (27 of its 146 transitions
in the JAX package) are forced by the replanning driver's segment stitching
(3-step replans joining different candidates with acceleration jumps), not
by the planner's states: no bounded input reproduces such a transition.

1. Drive the scenario to its goal through the host replanning loop
   (``run_planner.drive_to_goal``: one ``plan()`` per replanning period,
   the fused float32 path) and run the KS input-reconstruction harness
   (``utils.evaluation.reconstruct_inputs``) on the stitched solution.
2. For every failing transition, record its position relative to the
   replan boundaries and the acceleration jump |da| across it.
3. For every failing transition, search the bounded input box (steering
   rate x acceleration: a dense grid and two refinements around its best
   point, :func:`min_error_over_input_box`) for the least position and
   orientation error any bounded input reaches: above the tolerances, the
   state pair itself is KS-infeasible.

The sweep is host numpy (3 x 41^2 simulations per failing transition).
Prints one JSON line per failing transition, then a summary line.  Usage,
from the repository root:

    python -m commonroad_rp_tpu_torch.probes.divergence7 [--device cuda|cpu]
        [--scenario ZAM_Tjunction-1_42_T-1] [--max-steps 200]
"""

from __future__ import annotations

import argparse
import json
import logging

import numpy as np

# the reconstruction's tolerances on position and orientation
# (utils.evaluation.state_transition_feasibility)
POSITION_TOL, ORIENTATION_TOL = 2e-2, 3e-2

TJUNCTION = "ZAM_Tjunction-1_42_T-1"
# the transitions of the T-junction's ``plan_scan(50)`` drive (the fused
# float32 scan) that fail the KS reconstruction, 27 of 146: the same in the
# JAX package's drive, in the port's on the CPU and on the card
TJUNCTION_FAILING = (38, 40, 46, 47, 48, 49, 50, 51, 52, 56, 57, 58, 59, 60,
                     61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 75, 76, 87)


def min_error_over_input_box(dynamics, x0, x1, dt, n=41):
    """(least position error, its orientation error, its input): a dense
    bounded-input sweep of ``n`` x ``n`` steering rates and accelerations,
    then two more around the best input at twice the grid spacing: the floor
    of the position error any reconstruction could reach, whatever its
    optimizer."""
    from commonroad_rp_tpu_torch.utils.evaluation import _angle_diff

    p = dynamics.params

    def err(u):
        sim = dynamics.forward_simulation(x0, u, dt, throw=False)
        return float(np.hypot(sim[0] - x1[0], sim[1] - x1[1])), \
            abs(_angle_diff(sim[4], x1[4]))

    best = (np.inf, np.inf, None)
    lo = np.array([p.v_delta_min, -p.a_max])
    hi = np.array([p.v_delta_max, p.a_max])
    for _ in range(3):
        for vd in np.linspace(lo[0], hi[0], n):
            for a in np.linspace(lo[1], hi[1], n):
                pe, oe = err(np.array([vd, a]))
                if pe < best[0]:
                    best = (pe, oe, (vd, a))
        vd0, a0 = best[2]
        span_vd = (hi[0] - lo[0]) / (n - 1) * 2
        span_a = (hi[1] - lo[1]) / (n - 1) * 2
        lo = np.array([max(p.v_delta_min, vd0 - span_vd),
                       max(-p.a_max, a0 - span_a)])
        hi = np.array([min(p.v_delta_max, vd0 + span_vd),
                       min(p.a_max, a0 + span_a)])
    return best


def drive(scenario: str, device="cuda", max_steps: int = 200):
    """(planner after the drive, its loop result, the solution's planning
    problem solution, the per-transition reconstruction verdicts): the
    scenario driven through ``plan()`` on the fused float32 path."""
    from commonroad_rp_tpu_torch.run_planner import (drive_to_goal,
                                                     load_config,
                                                     make_planner)
    from commonroad_rp_tpu_torch.utils import evaluation as ev

    config = load_config(scenario)
    config.debug.kernel_dtype = "float32"
    config.debug.fast_scoring = True
    planner = make_planner(config, device=device)
    result = drive_to_goal(planner, max_steps=max_steps)
    trajectory = ev.create_full_solution_trajectory(
        config, planner.record_state_list)
    solution = ev.create_planning_problem_solution(
        config, trajectory, config.scenario, config.planning_problem)
    pps = solution.planning_problem_solutions[0]
    feasible, _ = ev.reconstruct_inputs(config, pps)
    return planner, result, pps, feasible


def failing_transitions(planner, pps, feasible, n=41) -> list:
    """One row per failing transition: its index, whether it starts a
    replanning period, |da| across it, and the floor of its input-box
    errors (:func:`min_error_over_input_box` at grid ``n``)."""
    from commonroad_rp_tpu_torch.utils import evaluation as ev

    config = planner.config
    freq = config.planning.replanning_frequency
    dynamics = ev.VehicleDynamicsKS.from_vehicle_type(
        config.vehicle.id_type_vehicle)
    states = pps.trajectory.state_list
    accel = [s.acceleration for s in planner.record_state_list]
    rows = []
    for i in (i for i, ok in enumerate(feasible) if not ok):
        x0, _ = dynamics.state_to_array(states[i])
        x1, _ = dynamics.state_to_array(states[i + 1])
        pe, oe, _ = min_error_over_input_box(dynamics, x0, x1,
                                             config.planning.dt, n)
        rows.append(dict(
            transition=i,
            at_replan_boundary=bool(i % freq == 0),
            accel_jump=round(float(abs(accel[i + 1] - accel[i])), 3),
            min_pos_err_any_bounded_input=round(pe, 5),
            min_orient_err=round(oe, 6),
            fails_for_any_input=bool(pe > POSITION_TOL
                                     or oe > ORIENTATION_TOL)))
    return rows


def summary(scenario: str, feasible, rows) -> dict:
    return {
        "scenario": scenario,
        "transitions": len(feasible),
        "failures": len(rows),
        "failures_at_replan_boundary": sum(r["at_replan_boundary"]
                                           for r in rows),
        "failures_forced_for_any_bounded_input": sum(
            r["fails_for_any_input"] for r in rows),
        "median_accel_jump_at_failures": round(float(np.median(
            [r["accel_jump"] for r in rows])), 3) if rows else None,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--scenario", default=TJUNCTION)
    parser.add_argument("--max-steps", type=int, default=200)
    args = parser.parse_args(argv)
    logging.getLogger("RP_LOGGER").setLevel(logging.CRITICAL)
    planner, result, pps, feasible = drive(args.scenario, args.device,
                                           args.max_steps)
    fails = [i for i, ok in enumerate(feasible) if not ok]
    print(f"# loop: goal={result['goal_reached']} steps={result['steps']}",
          flush=True)
    print(f"# reconstruction: {len(feasible) - len(fails)}/{len(feasible)} "
          f"transitions pass; failures at {fails}", flush=True)
    rows = failing_transitions(planner, pps, feasible)
    for row in rows:
        print(json.dumps(row), flush=True)
    print(json.dumps(summary(args.scenario, feasible, rows)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
