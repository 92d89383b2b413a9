"""End-to-end run: config -> route -> planner -> cyclic replanning to the goal.

The host replanning loop of the reference's run script (reference:
run_planner.py:53-115) on the PyTorch planner.  Usage, from the repository
root:

    python -m commonroad_rp_tpu_torch.run_planner [--scenario ZAM_Over-1_1]
                                                  [--device cuda|cpu]
                                                  [--max-steps N]
"""

from __future__ import annotations

import argparse
import logging
import pathlib
import time

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent


def load_config(scenario: str, root: pathlib.Path = REPO_ROOT):
    """Per-scenario configuration with the bundled scenario attached."""
    from commonroad_rp_tpu_torch.utils.config import \
        ReactivePlannerConfiguration

    config = ReactivePlannerConfiguration.load(
        root / "configurations" / f"{scenario}.yaml", f"{scenario}.xml")
    config.general.path_scenarios = str(root / "example_scenarios") + "/"
    config.general.set_path_scenario(f"{scenario}.xml")
    config.update()
    return config


def make_planner(config, device=None):
    """Planner on the first route's reference path, desired speed unset."""
    from commonroad_rp_tpu_torch.models.planner import ReactivePlanner
    from commonroad_rp_tpu_torch.utils.route import RoutePlanner

    route = RoutePlanner(config.scenario, config.planning_problem) \
        .plan_routes().retrieve_first_route()
    planner = ReactivePlanner(config, device=device)
    planner.set_reference_path(route.reference_path)
    return planner


def drive_to_goal(planner, max_steps: int = 300, on_step=None) -> dict:
    """The reference's replanning loop (run_planner.py:61-107): plan every
    ``replanning_frequency`` steps, follow the previous optimum in between,
    and reset with the carried collision checker and coordinate system.
    Returns goal_reached, steps, plan_calls and the planning times."""
    logger = logging.getLogger("RP_LOGGER")
    freq = planner.config.planning.replanning_frequency
    planner.record_state_and_input(planner.x_0)
    optimal = None
    plan_calls = 0
    while not planner.goal_reached():
        count = len(planner.record_state_list) - 1
        if count >= max_steps:
            logger.warning("Aborting after %d steps without reaching goal",
                           count)
            break
        if count % freq == 0:
            planner.set_desired_velocity(current_speed=planner.x_0.velocity)
            optimal = planner.plan()
            plan_calls += 1
            if not optimal:
                logger.error("Planner returned no trajectory — stopping")
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
        if on_step is not None:
            on_step(count)
    return dict(goal_reached=planner.goal_reached(),
                steps=len(planner.record_state_list) - 1,
                plan_calls=plan_calls,
                planning_times=list(planner.planning_times))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--scenario", default="ZAM_Over-1_1")
    parser.add_argument("--device", default=None, choices=["cuda", "cpu"],
                        help="default: cuda when available, else cpu")
    parser.add_argument("--max-steps", type=int, default=300)
    args = parser.parse_args()

    from commonroad_rp_tpu_torch.utils.logger import initialize_logger

    config = load_config(args.scenario)
    initialize_logger(config)
    planner = make_planner(config, device=args.device)
    logging.getLogger("RP_LOGGER").info("Scenario %s on %s", args.scenario,
                                        planner.device)

    t_start = time.time()
    result = drive_to_goal(
        planner, args.max_steps,
        on_step=lambda count: print(f"current time step: {count}",
                                    flush=True))
    wall = time.time() - t_start
    ordered = sorted(result["planning_times"])
    if ordered:
        print(f"goal_reached={result['goal_reached']} "
              f"steps={result['steps']} wall={wall:.2f}s "
              f"cycles={len(ordered)} "
              f"p50_cycle={ordered[len(ordered) // 2]:.4f}s "
              f"min_cycle={ordered[0]:.4f}s max_cycle={ordered[-1]:.4f}s "
              f"device={planner.device}", flush=True)
    else:
        print("no planning cycles ran", flush=True)
    return 0 if result["goal_reached"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
