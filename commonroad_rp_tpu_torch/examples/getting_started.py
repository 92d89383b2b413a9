"""Getting started with the PyTorch port of the reactive planner.

A step-by-step walk-through on the port's API, mirroring
``tutorial/00_getting_started.py``: load a scenario and its configuration,
plan a route, run one planning cycle and inspect it, run the cyclic
replanning loop to the goal, evaluate the driven solution, write it as a
CommonRoad solution file, plot it, and hand a stretch of replanning to the
device with ``plan_scan``.  From the repository root:

    python -m commonroad_rp_tpu_torch.examples.getting_started
        [--device cuda|cpu] [--scenario ZAM_Over-1_1] [--max-steps N]
        [--output DIR]

The device is the card unless ``--device cpu`` is given (the planner raises
without a card).
"""

from __future__ import annotations

import argparse
import os
import pathlib


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--scenario", default="ZAM_Over-1_1")
    parser.add_argument("--max-steps", type=int, default=200,
                        help="stop the replanning loop after this many steps")
    parser.add_argument("--output", default="output",
                        help="directory of the solution file and the plot")
    args = parser.parse_args(argv)
    root = pathlib.Path(__file__).resolve().parent.parent.parent

    # %% 1. Load configuration and scenario ----------------------------------
    # The YAML configs use the reference's fields
    # (commonroad_rp/utility/config.py); scenarios are CommonRoad XML.
    from commonroad_rp_tpu_torch.utils.config import \
        ReactivePlannerConfiguration

    config = ReactivePlannerConfiguration.load(
        root / "configurations" / f"{args.scenario}.yaml",
        f"{args.scenario}.xml")
    config.general.path_scenarios = str(root / "example_scenarios") + "/"
    config.general.set_path_scenario(f"{args.scenario}.xml")
    config.update()
    print(f"scenario: {config.scenario.scenario_id}, dt={config.planning.dt}, "
          f"horizon={config.planning.planning_horizon}s")

    # %% 2. Plan a route and build the planner -------------------------------
    from commonroad_rp_tpu_torch.models.planner import ReactivePlanner
    from commonroad_rp_tpu_torch.utils.route import RoutePlanner

    route = RoutePlanner(config.scenario, config.planning_problem) \
        .plan_routes().retrieve_first_route()
    print(f"route through lanelets {route.lanelet_ids}, reference path "
          f"{len(route.reference_path)} vertices")
    planner = ReactivePlanner(config, device=args.device)
    planner.set_reference_path(route.reference_path)
    print(f"planner on {planner.device}")

    # %% 3. One planning cycle -----------------------------------------------
    # Every sampling level's candidates are scored in one launch of the fused
    # scorer (a CUDA kernel on the card, its plain PyTorch version on the
    # CPU); the winner comes from the first level with a feasible one.
    planner.set_desired_velocity(current_speed=planner.x_0.velocity)
    cartesian, curvilinear, lon_samples, lat_samples = planner.plan()
    print(f"selected trajectory cost: {planner.optimal_cost:.2f}")
    print(f"kinematically infeasible candidates: "
          f"{planner.infeasible_count_kinematics}")
    print(f"rejection reasons: {planner.infeasible_reason_dict}")
    print(f"first states: v={cartesian.state_list[0].velocity:.2f} -> "
          f"v={cartesian.state_list[-1].velocity:.2f}")

    # %% 4. Cyclic replanning to the goal ------------------------------------
    planner.record_state_and_input(planner.x_0)
    optimal = None
    freq = config.planning.replanning_frequency
    while not planner.goal_reached() and \
            len(planner.record_state_list) - 1 < args.max_steps:
        count = len(planner.record_state_list) - 1
        if count % freq == 0:
            planner.set_desired_velocity(current_speed=planner.x_0.velocity)
            optimal = planner.plan()
            if optimal is None:
                print("planning failed")
                break
            offset = 1
        else:
            offset = 1 + count % freq
        planner.record_state_and_input(optimal[0].state_list[offset])
        planner.reset(initial_state_cart=planner.record_state_list[-1],
                      initial_state_curv=(optimal[2][offset],
                                          optimal[3][offset]),
                      collision_checker=planner.collision_checker,
                      coordinate_system=planner.coordinate_system)
    times = sorted(planner.planning_times)
    print(f"goal reached: {planner.goal_reached()} after "
          f"{len(planner.record_state_list) - 1} steps; p50 cycle latency: "
          f"{times[len(times) // 2] * 1e3:.1f} ms")

    # %% 5. Evaluate the solution and write it -------------------------------
    # KS-model input reconstruction per state transition + validity check
    # (the reference's physics-level oracle); the solution file is the
    # CommonRoad format that read_solution_file reads back.
    from commonroad_rp_tpu_torch.utils.evaluation import run_evaluation
    from commonroad_rp_tpu_torch.utils.solution_writer import (
        read_solution_file, write_solution_file)

    solution, feasibility = run_evaluation(config, planner.record_state_list,
                                           planner.record_input_list)
    print(f"feasible transitions: {sum(feasibility)}/{len(feasibility)}")
    os.makedirs(args.output, exist_ok=True)
    solution_path = os.path.join(args.output,
                                 f"solution_{args.scenario}.xml")
    write_solution_file(solution, solution_path)
    back = read_solution_file(solution_path)
    print(f"solution written to {solution_path} "
          f"({len(back.planning_problem_solutions[0].trajectory.state_list)}"
          " states)")

    # %% 6. Visualize --------------------------------------------------------
    from commonroad_rp_tpu_torch.utils.visualization import \
        plot_final_trajectory

    plot_path = os.path.join(args.output, f"final_trajectory_{args.scenario}"
                             ".png")
    plot_final_trajectory(config.scenario, config.planning_problem,
                          planner.record_state_list, config,
                          save_path=plot_path)
    print(f"plot saved to {plot_path}")

    # %% 7. Device replanning: plan_scan -------------------------------------
    # A stretch of the replanning loop on the device: grid generation, the
    # fused scorer, the winner re-roll and the state advance of every cycle,
    # with one readback at the end.
    scan_planner = ReactivePlanner(config, device=args.device)
    scan_planner.set_reference_path(route.reference_path)
    scan_planner.set_desired_velocity(current_speed=scan_planner.x_0.velocity)
    scan_planner.record_state_and_input(scan_planner.x_0)
    n_cycles = max(1, min(12, args.max_steps // freq))
    info = scan_planner.plan_scan(n_cycles=n_cycles)
    print(f"plan_scan: goal={info['goal_reached']} "
          f"cycles={info['cycles_run']} steps={info['steps']} "
          f"{info['wall_time'] / max(info['cycles_run'], 1) * 1e3:.1f} "
          "ms/cycle")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
