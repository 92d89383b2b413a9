"""Fleet run: many heterogeneous planning problems replanned in lockstep.

The fleet deployment of the JAX package's ``bench.py`` fleet1024 stage
(``bench.py:363-519``): the four bundled scenarios x three vehicle types
(BMW 320i, Ford Escort, VW Vanagon), each problem with its start speed,
lateral offset and desired speed jittered from ``numpy.random
.default_rng(seed)``, sampling level 3 (K = 2754 candidates per problem at
T = 21), replanned at replanning frequency 1 by
``parallel.replanning_scan.make_fleet_scan`` -- one fleet-scorer launch per
cycle -- or, with ``--xla``, by the XLA fleet path
``parallel.fleet.make_fleet_rollout`` with each problem's own vehicle (the
default path of ``scripts/fleet_scale_demo.py``: dense rollout, cost and
checks, one launch of the fleet collision kernel per cycle), and checked on
the host against each scenario's goal region from the recorded winner
states.  Usage, from the repository root:

    python -m commonroad_rp_tpu_torch.run_fleet [--fleet-size 1024]
        [--cycles 150] [--xla] [--device cuda|cpu]

Prints the per-scenario goal counts with each miss classified (dead: the
member's carry died; timing: it entered the goal position outside the
admissible time window; velocity: outside the velocity interval; planning:
it never touched the goal position), and the warm run's candidate
evaluations per second.
"""

from __future__ import annotations

import argparse
import logging
import pathlib
import time

import numpy as np

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
SCENARIOS = ("ZAM_Over-1_1", "DEU_Test-1_1_T-1", "ZAM_Tjunction-1_42_T-1",
             "ZAM-Ramp-1_1-T-1")
VEHICLE_TYPES = (1, 2, 3)
N_STEPS, DT, LEVEL = 20, 0.1, 3


def heterogeneous_fleet(fleet_size: int, cycles: int, freq: int = 1,
                        seed: int = 0, device="cuda",
                        root: pathlib.Path = REPO_ROOT):
    """(scene, carry, goals, base_index): ``fleet_size`` problems cycling
    through the 12 (scenario, vehicle) bases with bench.py's jitter
    (speed x U(0.92, 1.08) on v and s_dot, lateral offset + U(-0.25, 0.25),
    desired speed x U(0.95, 1.05)); ``goals[base]`` is (goal region,
    rear-axle offset) of each base."""
    from commonroad_rp_tpu_torch.parallel import fleet
    from commonroad_rp_tpu_torch.utils.config import VehicleConfiguration
    from commonroad_rp_tpu_torch.utils.general import \
        load_scenario_and_planning_problem
    from commonroad_rp_tpu_torch.utils.route import RoutePlanner

    base_problems, goals = [], []
    for name in SCENARIOS:
        scn, pp, _ = load_scenario_and_planning_problem(
            str(root / "example_scenarios" / f"{name}.xml"))
        route = RoutePlanner(scn, pp).plan_routes().retrieve_first_route()
        for vid in VEHICLE_TYPES:
            veh_cfg = VehicleConfiguration(id_type_vehicle=vid)
            base_problems.append(fleet.problem_from_planner_setup(
                scn, pp, route.reference_path, n_steps=N_STEPS,
                horizon_pad=cycles * freq + 10, vehicle=veh_cfg))
            goals.append((pp.goal, veh_cfg.wb_rear_axle))
    rng = np.random.default_rng(seed)
    problems, base_idx = [], []
    for i in range(fleet_size):
        gidx = i % len(base_problems)
        base = base_problems[gidx]
        p = dict(base)
        v_scale = float(rng.uniform(0.92, 1.08))
        d_off = float(rng.uniform(-0.25, 0.25))
        p["velocity"] = float(base["velocity"]) * v_scale
        x0_lon = np.asarray(base["x0_lon"], np.float64).copy()
        x0_lon[1] *= v_scale
        p["x0_lon"] = x0_lon
        x0_lat = np.asarray(base["x0_lat"], np.float64).copy()
        x0_lat[0] += d_off
        p["x0_lat"] = x0_lat
        p["desired_speed"] = float(base["desired_speed"]) * \
            float(rng.uniform(0.95, 1.05))
        problems.append(p)
        base_idx.append(gidx)
    scene, carry = fleet.build_fleet_scene(problems, N_STEPS, device=device)
    return scene, carry, goals, base_idx


def make_scan(scene, cycles: int, freq: int = 1, **kwargs):
    """The fleet scan of the run: level 3, replan offset ``freq``."""
    from commonroad_rp_tpu_torch.ops import grid
    from commonroad_rp_tpu_torch.parallel import replanning_scan

    static_grid = grid.make_static_grid(LEVEL, 0.4, N_STEPS * DT, DT,
                                        -3.0, 3.0, 4)
    run = replanning_scan.make_fleet_scan(
        scene, static_grid, DT, N_STEPS, replan_offset=freq,
        low_vel_threshold=4.0, horizon=N_STEPS * DT, n_cycles=cycles,
        **kwargs)
    return run, static_grid.size


def make_xla_rollout(cycles: int, freq: int = 1, device="cuda",
                     graph: bool = True):
    """The XLA fleet path of the run: level 3, replan offset ``freq``, each
    problem's own vehicle (``veh=None``); ``run(carry, scene)``, a captured
    cycle on the card unless ``graph=False``."""
    from commonroad_rp_tpu_torch.ops import grid
    from commonroad_rp_tpu_torch.parallel import fleet

    static_grid = grid.make_static_grid(LEVEL, 0.4, N_STEPS * DT, DT,
                                        -3.0, 3.0, 4)
    run = fleet.make_fleet_rollout(
        None, None, static_grid, DT, N_STEPS, replan_offset=freq,
        low_vel_threshold=4.0, horizon=N_STEPS * DT, n_cycles=cycles,
        device=device, graph=graph)
    return run, static_grid.size


def winner_trace(metrics):
    """(alive, x, y, theta, v) per cycle, each [C, F], from either fleet
    path's stacked metrics: the XLA path's ``CycleMetrics`` or the fused
    scan's tuple."""
    from commonroad_rp_tpu_torch.parallel.fleet import CycleMetrics

    if isinstance(metrics, CycleMetrics):
        return (metrics.found, metrics.x, metrics.y, metrics.orientation,
                metrics.velocity)
    return tuple(metrics[i] for i in (0, 2, 3, 8, 9))


def member_outcomes(metrics, goals, base_idx, freq: int = 1) -> list:
    """Each member's outcome from a fleet run's metrics (alive, x, y, theta,
    v per cycle: ``winner_trace``), as bench.py:436-519 classifies it:
    'reached', or the miss class 'dead', 'planning', 'timing' or
    'velocity'."""
    from commonroad_rp_tpu_torch.models.state import ReactivePlannerState

    alive, xs, ys, thetas, vs = (a.cpu().numpy()
                                 for a in winner_trace(metrics))  # [C, F]
    cycles, fleet_size = alive.shape

    def position_hits(goal, states):
        hits = []
        for i, st in enumerate(states):
            for gs in goal.state_list:
                if not (gs.position_shapes or gs.position_lanelets):
                    continue
                inside = any(s.contains_point(st.position)
                             for s in gs.position_shapes)
                if gs.position_lanelets and goal.lanelet_network:
                    inside = inside or any(
                        goal.lanelet_network.find_lanelet_by_id(lid)
                        .contains_point(st.position)
                        for lid in gs.position_lanelets)
                if inside:
                    hits.append((i, gs))
                    break
        return hits

    outcomes = []
    for f in range(fleet_size):
        goal, wb_rear = goals[base_idx[f]]
        states, died = [], False
        for c in range(cycles):
            if not alive[c, f]:
                died = True
                break
            states.append(ReactivePlannerState(
                time_step=(c + 1) * freq,
                position=np.array([xs[c, f], ys[c, f]]),
                orientation=float(thetas[c, f]), velocity=float(vs[c, f]),
                acceleration=0.0, yaw_rate=0.0,
                steering_angle=0.0).shift_positions_to_center(wb_rear))
        if any(goal.is_reached(st) for st in states):
            outcomes.append("reached")
            continue
        hits = position_hits(goal, states)
        if not hits:
            outcomes.append("dead" if died else "planning")
            continue
        timing = any(gs.time_step is not None
                     and not gs.time_step.contains(states[i].time_step)
                     for i, gs in hits)
        outcomes.append("timing" if timing else "velocity")
    return outcomes


def goal_counts(metrics, goals, base_idx, freq: int = 1,
                outcomes=None) -> dict:
    """Per-scenario goal counts and miss classes of a fleet run (from its
    metrics, or from its ``member_outcomes``)."""
    if outcomes is None:
        outcomes = member_outcomes(metrics, goals, base_idx, freq)
    counts = {name: dict(reached=0, total=0, misses={}) for name in SCENARIOS}
    for f, outcome in enumerate(outcomes):
        c = counts[SCENARIOS[base_idx[f] // len(VEHICLE_TYPES)]]
        c["total"] += 1
        if outcome == "reached":
            c["reached"] += 1
        else:
            c["misses"][outcome] = c["misses"].get(outcome, 0) + 1
    return counts


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--fleet-size", type=int, default=1024)
    parser.add_argument("--cycles", type=int, default=150)
    parser.add_argument("--freq", type=int, default=1)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--xla", action="store_true",
                        help="the XLA fleet path (make_fleet_rollout, each "
                             "problem's own vehicle) instead of the fused "
                             "fleet scan")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="default: cuda (raises without a card; the "
                             "CPU runs only when named)")
    args = parser.parse_args(argv)

    import torch

    from commonroad_rp_tpu_torch.models.planner import resolve_device

    logging.getLogger("RP_LOGGER").setLevel(logging.CRITICAL)
    device = resolve_device(args.device)
    t0 = time.time()
    scene, carry, goals, base_idx = heterogeneous_fleet(
        args.fleet_size, args.cycles, args.freq, args.seed, device)
    if args.xla:
        run_xla, K = make_xla_rollout(args.cycles, args.freq, device)
        run = lambda c: run_xla(c, scene)
    else:
        run, K = make_scan(scene, args.cycles, args.freq)
    print(f"fleet of {args.fleet_size} problems built in "
          f"{time.time() - t0:.1f} s on {device}: K={K} per problem, "
          f"{args.fleet_size * K} candidates per cycle, "
          f"{'XLA fleet path' if args.xla else 'fused fleet scan'}",
          flush=True)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    for label in ("first", "warm"):
        t0 = time.time()
        _, metrics = run(carry)
        sync()
        wall = time.time() - t0
        print(f"{label} scan: {args.cycles} cycles in {wall:.3f} s, "
              f"{args.fleet_size * K * args.cycles / wall:.6g} "
              "candidate-evals/s", flush=True)
    for name, c in goal_counts(metrics, goals, base_idx, args.freq).items():
        print(f"{name}: {c['reached']}/{c['total']} reached"
              + (f", misses {c['misses']}" if c["misses"] else ""))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
