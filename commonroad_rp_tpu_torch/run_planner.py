"""End-to-end run: config -> route -> planner -> cyclic replanning to the goal.

The replanning loop of the reference's run script (reference:
run_planner.py:53-115) on the PyTorch planner: on the host, one ``plan()``
per cycle (default), or on the device, chunks of cycles per ``plan_scan``
(``--scan``), or a stop-at-goal mission through ``plan_scan`` only
(``--mission``).  ``--sampling-iteration-outside`` escalates the sampling
levels in the loop instead of inside ``plan()``: ``plan(level)`` from level
1 up until one finds a trajectory (the reference's run script, its
``sampling_iteration_outside`` mode).  ``--dtype float64`` plans through
the float64 conformance level program instead of the fused float32
scorer, ``--evaluate`` runs the physics certificate
(``utils.evaluation.run_evaluation``) on the driven states, and ``--plot``
saves the final-trajectory plot to the configuration's output directory
(``output/`` by default).  Usage, from the repository root:

    python -m commonroad_rp_tpu_torch.run_planner [--scenario ZAM_Over-1_1]
                                                  [--device cuda|cpu]
                                                  [--dtype float32|float64]
                                                  [--max-steps N]
                                                  [--scan] [--mission]
                                                  [--sampling-iteration-outside]
                                                  [--stop-at DS]
                                                  [--evaluate] [--plot]
"""

from __future__ import annotations

import argparse
import logging
import pathlib
import time

import numpy as np

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


def make_planner(config, device="cuda", graph: bool = True):
    """Planner on the first route's reference path, desired speed unset;
    ``graph=False`` runs its programs uncaptured (``ReactivePlanner``)."""
    from commonroad_rp_tpu_torch.models.planner import ReactivePlanner
    from commonroad_rp_tpu_torch.utils.route import RoutePlanner

    route = RoutePlanner(config.scenario, config.planning_problem) \
        .plan_routes().retrieve_first_route()
    planner = ReactivePlanner(config, device=device, graph=graph)
    planner.set_reference_path(route.reference_path)
    return planner


def drive_to_goal(planner, max_steps: int = 300, on_step=None,
                  stop_s: float = None,
                  sampling_iteration_outside: bool = False) -> dict:
    """The reference's replanning loop (run_planner.py:61-107): plan every
    ``replanning_frequency`` steps, follow the previous optimum in between,
    and reset with the carried collision checker and coordinate system.
    With ``stop_s`` every cycle plans in stopping mode toward that arclength
    and the loop ends when the vehicle halts.  With
    ``sampling_iteration_outside`` the loop escalates the sampling levels
    itself (run_planner.py:72-75): ``plan(level)`` from level 1 up until one
    returns a trajectory.  Returns goal_reached, steps, plan_calls and the
    planning times."""
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
        if stop_s is not None and planner.x_0.velocity <= 0.05:
            logger.info("Vehicle halted at the stop target")
            break
        if count % freq == 0:
            if stop_s is not None:
                planner.set_desired_lon_position(stop_s)
            else:
                planner.set_desired_velocity(
                    current_speed=planner.x_0.velocity)
            if sampling_iteration_outside:
                optimal = None
                level = 1
                while optimal is None and level < planner.sampling_level:
                    optimal = planner.plan(level)
                    plan_calls += 1
                    level += 1
            else:
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


def drive_scan(planner, max_steps: int = 300, chunk: int = 12,
               stop_s: float = None, on_scan=None) -> dict:
    """The replanning loop on the device: ``plan_scan(chunk)`` dispatches
    (each ``chunk`` cycles with no device readback between them) until the
    goal is reached, the vehicle halts at ``stop_s`` (stopping mode), or a
    scan finds no trajectory.  Returns goal_reached, steps, the cycles run
    and the per-scan infos."""
    logger = logging.getLogger("RP_LOGGER")
    if stop_s is None:
        planner.set_desired_velocity(current_speed=planner.x_0.velocity)
    else:
        planner.set_desired_lon_position(stop_s)
    planner.record_state_and_input(planner.x_0)
    scan_infos = []
    while not planner.goal_reached():
        if len(planner.record_state_list) - 1 >= max_steps:
            logger.warning("Aborting after %d steps without reaching goal",
                           len(planner.record_state_list) - 1)
            break
        if stop_s is not None and planner.x_0.velocity <= 0.05:
            logger.info("Vehicle halted at the stop target")
            break
        info = planner.plan_scan(chunk)
        scan_infos.append(info)
        if on_scan is not None:
            on_scan(info)
        if info["cycles_run"] < chunk and not info["goal_reached"]:
            logger.error("plan_scan found no trajectory — stopping")
            break
    return dict(goal_reached=planner.goal_reached(),
                steps=len(planner.record_state_list) - 1,
                cycles=sum(i["cycles_run"] for i in scan_infos),
                scan_infos=scan_infos)


def drive_mission(planner, config, max_steps: int = 400, chunk: int = 12,
                  verbose: bool = False) -> dict:
    """Stop-at-goal mission: the reference's two longitudinal modes
    (reactive_planner.py:309-347 velocity keeping + :349-376 stopping)
    composed into one run, every planning cycle through ``plan_scan``.

    Phases: CRUISE (velocity keeping) until the goal region is entered
    inside its admissible time window, then BRAKE (tracked deceleration
    profile toward a computed stop point), then STOP (stopping-mode
    quintics to rest).  A stopping quintic must fit the horizon
    (t_stop ~ 2 d / v <= h), which bounds the hand-over speed; the
    velocity-keeping sampler tracks a braking profile at ~1.7 m/s^2
    effective (lag included), so the stop point is placed with a
    conservative 1.5 and the profile leads the position by ~1 s of travel.

    Returns a dict: success, goal_entered, halted, final_v, final_s,
    stop_target, steps, cycles, scan_infos.
    """
    logger = logging.getLogger("RP_LOGGER")
    scan_infos = []
    a_br = 1.5
    v_handover = max(2.0, min(6.0, 0.55 * 2.5 * planner.horizon))
    reach_h = max(0.45 * v_handover * planner.horizon, 3.0)
    phase = "cruise"
    goal_entered = False
    stop_target = None
    stop_retargets = 0
    while True:
        if len(planner.record_state_list) - 1 >= max_steps:
            logger.warning("Mission aborted after %d steps",
                           len(planner.record_state_list) - 1)
            break
        if not planner.x_0_cl:
            planner.x_0_cl = planner._compute_initial_states(planner.x_0)
        cur_s = float(planner.x_0_cl[0][0])
        v = planner.x_0.velocity
        n_cycles = chunk
        if phase == "cruise":
            planner.set_desired_velocity(current_speed=v)
        elif phase == "brake":
            if stop_target is None:
                # fixed stop point: brake distance + sampler reach +
                # half-second tracking-lag margin
                stop_target = cur_s \
                    + (v * v - v_handover ** 2) / (2.0 * a_br) \
                    + reach_h + 0.5 * v
                logger.info("Mission: braking toward stop at s = %.2f",
                            stop_target)
            remaining = stop_target - cur_s
            if remaining < 2.0 and v > 0.5:
                # overshot the planned stop point: re-target ahead
                stop_target = cur_s + max(0.45 * v * planner.horizon, 3.0)
                remaining = stop_target - cur_s
                logger.info("Mission: re-targeting stop to s = %.2f",
                            stop_target)
            if remaining <= max(reach_h, 0.45 * v * planner.horizon):
                # a stopping quintic from the current speed fits the
                # horizon: hand over now
                phase = "stop"
                config.sampling.longitudinal_mode = "stopping"
                planner.set_desired_lon_position(stop_target)
                logger.info("Mission: stopping phase at s = %.2f "
                            "(%.1f m to stop target)", cur_s, remaining)
            else:
                # profile speed one second of travel ahead of the current
                # position (tracking-lag lead)
                v_des = max(v_handover, float(np.sqrt(max(
                    2.0 * a_br * (remaining - reach_h - v), 0.0))))
                planner.set_desired_velocity(desired_velocity=v_des,
                                             current_speed=v)
                n_cycles = 3
        if phase == "stop" and v <= 0.05:
            logger.info("Mission: halted at s = %.2f", cur_s)
            break
        info = planner.plan_scan(n_cycles,
                                 stop_on_goal=(phase == "cruise"))
        scan_infos.append(info)
        if verbose:
            print(f"plan_scan[{phase}]: {info['cycles_run']} cycles, "
                  f"{info['steps']} steps, goal={info['goal_reached']}, "
                  f"{info['wall_time'] / max(info['cycles_run'], 1) * 1e3:.2f}"
                  " ms/cycle", flush=True)
        if phase == "cruise" and info["goal_reached"]:
            goal_entered = True
            phase = "brake"
            logger.info("Mission: goal region entered — braking")
            continue
        if info["cycles_run"] == 0:
            if phase == "stop" and planner.x_0.velocity > 0.05 \
                    and stop_retargets < 3:
                # rolled past the stop point before rest: nudge the target
                # ahead of the current position and keep stopping
                stop_retargets += 1
                cur_s = float(planner.x_0_cl[0][0])
                v = planner.x_0.velocity
                stop_target = cur_s + max(0.45 * v * planner.horizon, 1.5)
                planner.set_desired_lon_position(stop_target)
                logger.info("Mission: stop re-target %d to s = %.2f",
                            stop_retargets, stop_target)
                continue
            logger.error("plan_scan found no trajectory — stopping")
            break
    final_v = planner.x_0.velocity
    final_s = float(planner.x_0_cl[0][0]) if planner.x_0_cl else None
    halted = final_v <= 0.05
    success = goal_entered and halted and final_s is not None and \
        stop_target is not None and abs(final_s - stop_target) < 5.0
    return dict(success=success, goal_entered=goal_entered, halted=halted,
                final_v=final_v, final_s=final_s, stop_target=stop_target,
                steps=len(planner.record_state_list) - 1,
                cycles=sum(i["cycles_run"] for i in scan_infos),
                scan_infos=scan_infos)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--scenario", default="ZAM_Over-1_1")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="default: cuda (raises without a card; the "
                             "CPU runs only when named)")
    parser.add_argument("--dtype", default=None,
                        choices=["float32", "float64"],
                        help="planner dtype: float32 (default) scores on the "
                             "fused kernel, float64 runs the conformance "
                             "level program")
    parser.add_argument("--max-steps", type=int, default=300)
    parser.add_argument("--evaluate", action="store_true",
                        help="run the solution-feasibility evaluation "
                             "(input reconstruction, KS simulation, "
                             "collision report) on the driven states")
    parser.add_argument("--scan", action="store_true",
                        help="drive the replanning loop as plan_scan "
                             "dispatches of 12 cycles each, with no device "
                             "readback between the cycles of a dispatch")
    parser.add_argument("--sampling-iteration-outside", action="store_true",
                        help="escalate the sampling levels in the loop: "
                             "plan(level) from level 1 up until one finds "
                             "a trajectory (the reference run script's "
                             "mode; host loop only)")
    parser.add_argument("--stop-at", type=float, default=None, metavar="DS",
                        help="stopping mode: plan to a halt DS meters ahead "
                             "along the reference path (the loop ends when "
                             "the vehicle halts)")
    parser.add_argument("--mission", action="store_true",
                        help="stop-at-goal mission: velocity-keeping "
                             "plan_scan to the goal region, then stopping-"
                             "mode plan_scan to a standstill at the goal "
                             "(implies --scan)")
    parser.add_argument("--plot", action="store_true",
                        help="save the final-trajectory plot to the "
                             "configuration's output directory (output/)")
    args = parser.parse_args(argv)

    from commonroad_rp_tpu_torch.utils.logger import initialize_logger

    config = load_config(args.scenario)
    if args.sampling_iteration_outside and (args.scan or args.mission):
        parser.error("--sampling-iteration-outside drives the host loop; "
                     "drop --scan and --mission")
    if args.dtype == "float64" and (args.scan or args.mission):
        parser.error("--scan and --mission run the fused float32 scorer; "
                     "drop --dtype float64")
    if args.dtype:
        config.debug.kernel_dtype = args.dtype
    if args.stop_at is not None:
        config.sampling.longitudinal_mode = "stopping"
    initialize_logger(config)
    planner = make_planner(config, device=args.device)
    logger = logging.getLogger("RP_LOGGER")
    logger.info("Scenario %s on %s", args.scenario, planner.device)

    stop_s = None
    if args.stop_at is not None:
        if not planner.x_0_cl:
            planner.x_0_cl = planner._compute_initial_states(planner.x_0)
        stop_s = float(planner.x_0_cl[0][0]) + args.stop_at
        logger.info("Stopping mode: target s = %.2f (+%.1f m)", stop_s,
                    args.stop_at)

    t_start = time.time()
    if args.mission:
        if planner.goal_center_s() is None:
            parser.error("--mission requires a goal with a position "
                         "constraint")
        planner.record_state_and_input(planner.x_0)
        result = drive_mission(planner, config, max_steps=args.max_steps,
                               verbose=True)
        wall = time.time() - t_start
        print(f"mission: goal_entered={result['goal_entered']} "
              f"halted={result['halted']} v={result['final_v']:.3f} "
              f"s={result['final_s']:.2f} "
              f"stop_target={result['stop_target']}", flush=True)
        print(f"goal_reached={result['success']} steps={result['steps']} "
              f"wall={wall:.2f}s cycles={result['cycles']} ms_per_cycle="
              f"{wall / max(result['cycles'], 1) * 1e3:.2f} "
              f"device={planner.device}", flush=True)
        return 0 if result["success"] else 1

    if args.scan:
        result = drive_scan(
            planner, args.max_steps, stop_s=stop_s,
            on_scan=lambda info: print(
                f"plan_scan: {info['cycles_run']} cycles, {info['steps']} "
                f"steps, goal={info['goal_reached']}, "
                f"{info['wall_time'] / max(info['cycles_run'], 1) * 1e3:.2f}"
                " ms/cycle", flush=True))
        n_cycles = result["cycles"]
    else:
        result = drive_to_goal(
            planner, args.max_steps, stop_s=stop_s,
            on_step=lambda count: print(f"current time step: {count}",
                                        flush=True),
            sampling_iteration_outside=args.sampling_iteration_outside)
        n_cycles = result["plan_calls"]
    wall = time.time() - t_start
    reached = result["goal_reached"]
    if stop_s is not None:
        final_v = planner.x_0.velocity
        final_s = float(planner.x_0_cl[0][0])
        reached = final_v <= 0.05 and abs(final_s - stop_s) < 5.0
        print(f"stopping: halted={final_v <= 0.05} v={final_v:.3f} "
              f"s={final_s:.2f} target={stop_s:.2f}", flush=True)
    line = (f"goal_reached={reached} steps={result['steps']} "
            f"wall={wall:.2f}s cycles={n_cycles} "
            f"ms_per_cycle={wall / max(n_cycles, 1) * 1e3:.2f}")
    ordered = sorted(result.get("planning_times", []))
    if ordered:
        line += (f" p50_cycle={ordered[len(ordered) // 2]:.4f}s "
                 f"min_cycle={ordered[0]:.4f}s max_cycle={ordered[-1]:.4f}s")
    print(f"{line} device={planner.device}", flush=True)
    if args.plot:
        from commonroad_rp_tpu_torch.utils.visualization import \
            plot_final_trajectory
        plot_final_trajectory(config.scenario, config.planning_problem,
                              planner.record_state_list, config)
    if args.evaluate:
        from commonroad_rp_tpu_torch.utils.evaluation import run_evaluation
        _, feasibility = run_evaluation(planner.config,
                                        planner.record_state_list,
                                        planner.record_input_list)
        print(f"state transitions feasible: "
              f"{sum(feasibility)}/{len(feasibility)}", flush=True)
    return 0 if reached else 1


if __name__ == "__main__":
    raise SystemExit(main())
