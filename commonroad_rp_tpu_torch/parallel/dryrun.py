"""Multi-process dry run of both fleet paths under a process group.

Counterpart of ``__graft_entry__.dryrun_multichip`` (``:84-189``): a fleet of
ZAM_Over-1_1 problems, two per rank, runs two cycles of the XLA fleet path
(``parallel.fleet.make_fleet_rollout``) and one cycle of the fused fleet
scan (``parallel.replanning_scan.make_fleet_scan``) with every rank holding
its slice of the fleet (``parallel.mesh.shard_fleet``) and the aggregates
summed over the group (``parallel.mesh.fleet_all_reduce``); every rank
checks that the global success count equals the global fleet size.  On the
card both programs replay a captured cycle with the all-reduces in the
graph.

On the CPU the ranks are gloo processes; on the card NCCL ranks, one per
card (``torch.cuda.device_count()``, 1 on a one-card machine: a world-size-1
dry run, in this process).  Usage, from the repository root:

    python -m commonroad_rp_tpu_torch.parallel.dryrun [--world-size N]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import logging
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent.parent
# a 1.5 s horizon keeps the ZAM_Over overtake plannable, so both cycles
# report real successes (at 1.0 s every candidate hits the parked obstacle
# mid-overtake)
N_STEPS, DT = 15, 0.1


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def over_problem(n_steps: int, horizon_pad: int = 30,
                 root: pathlib.Path = REPO_ROOT) -> dict:
    """The fleet problem of ZAM_Over-1_1 (host-side, once)."""
    from commonroad_rp_tpu_torch.parallel.fleet import \
        problem_from_planner_setup
    from commonroad_rp_tpu_torch.utils.general import \
        load_scenario_and_planning_problem
    from commonroad_rp_tpu_torch.utils.route import RoutePlanner

    scenario, pp, _ = load_scenario_and_planning_problem(
        str(root / "example_scenarios" / "ZAM_Over-1_1.xml"))
    route = RoutePlanner(scenario, pp).plan_routes().retrieve_first_route()
    return problem_from_planner_setup(scenario, pp, route.reference_path,
                                      n_steps=n_steps,
                                      horizon_pad=horizon_pad)


def shared_vehicle():
    """The BMW 320i parameter set as float32 values (one shared vehicle)."""
    from commonroad_rp_tpu_torch.ops.kinematics import VehicleArrays
    from commonroad_rp_tpu_torch.utils.config import VehicleConfiguration

    vc = VehicleConfiguration()
    return VehicleArrays(*(float(np.float32(x)) for x in (
        vc.wheelbase, vc.wb_rear_axle, vc.a_max, vc.v_switch,
        np.tan(vc.delta_max) / vc.wheelbase, vc.v_delta_max,
        vc.length / 2, vc.width / 2)))


def fleet_programs(group, rank: int, world: int, device,
                   graph: bool = True):
    """The dry run's two programs over a fleet of ``2 * world`` problems,
    this rank's slice: ``(rollout, fused scan, carry, scene)``, the XLA
    rollout of two cycles (``rollout(carry, scene)``) and the fused fleet
    scan of one (``fused(carry)``).  On the card both capture their cycle,
    the all-reduces included, unless ``graph=False``."""
    from commonroad_rp_tpu_torch.ops import grid as grid_ops
    from commonroad_rp_tpu_torch.parallel import fleet, replanning_scan
    from commonroad_rp_tpu_torch.parallel.mesh import shard_fleet

    F = 2 * world
    scene, carry = fleet.build_fleet_scene([over_problem(N_STEPS)] * F,
                                           N_STEPS, device=device)
    scene, carry, _ = shard_fleet(scene, carry, rank, world)
    static_grid = grid_ops.make_static_grid(1, 0.4, N_STEPS * DT, DT,
                                            -3.0, 3.0, 4)
    rollout = fleet.make_fleet_rollout(
        group, shared_vehicle(), static_grid, DT, N_STEPS, replan_offset=3,
        low_vel_threshold=4.0, horizon=N_STEPS * DT, n_cycles=2,
        device=device, graph=graph)
    fused = replanning_scan.make_fleet_scan(
        scene, static_grid, DT, N_STEPS, replan_offset=3,
        low_vel_threshold=4.0, horizon=N_STEPS * DT, n_cycles=1, mesh=group,
        graph=graph)
    return rollout, fused, carry, scene


def run_rank(group, rank: int, world: int, device) -> dict:
    """One rank's dry run (the default process group is up): two XLA fleet
    cycles and one fused fleet-scan cycle over a fleet of ``2 * world``
    problems (``fleet_programs``); raises unless every cycle's global
    success count is the fleet size.  Returns the success counts."""
    F = 2 * world
    rollout, fused, carry, scene = fleet_programs(group, rank, world, device)
    final, metrics = rollout(carry, scene)
    successes = metrics.fleet_success.tolist()
    if tuple(final.x0_lon.shape) != (2, 3) or successes != [F, F]:
        raise AssertionError(f"rank {rank}: XLA fleet path successes "
                             f"{successes}, expected {F} per cycle")
    print(f"dryrun_multichip({world}) rank {rank}: XLA fleet path OK -- "
          f"fleet of {F} problems, successes per cycle: {successes}",
          flush=True)

    _, fused_metrics = fused(carry)
    n_success = int(fused_metrics[4][0])
    if n_success != F:
        raise AssertionError(f"rank {rank}: fused fleet scan "
                             f"{n_success}/{F} successes")
    print(f"dryrun_multichip({world}) rank {rank}: fused fleet scan OK -- "
          f"{n_success}/{F} successes in cycle 0", flush=True)
    return dict(F=F, xla_successes=successes, fused_success=n_success)


def _rank_main(rank: int, world: int, init_method: str, device) -> dict:
    import torch.distributed as dist

    from commonroad_rp_tpu_torch.parallel.mesh import (initialize_distributed,
                                                       make_fleet_group)

    device = initialize_distributed(init_method, world, rank, device)
    try:
        result = run_rank(make_fleet_group(), rank, world, device)
        # no rank tears the group down while a peer still uses it (rank 0
        # hosts the store: a peer's late exit aborted it now and then)
        dist.barrier()
        return result
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n: int | None = None, device="cuda") -> None:
    """Dry run of both fleet paths over ``n`` ranks: gloo processes on the
    CPU, NCCL ranks on the card (default: one per card).  One rank runs in
    this process; more run as subprocesses of this module, each checked for
    its exit code."""
    import torch

    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("dryrun_multichip: device cuda requested but "
                               "torch.cuda.is_available() is false; pass "
                               "device='cpu' for gloo ranks on the CPU")
        n = torch.cuda.device_count() if n is None else n
        if n > torch.cuda.device_count():
            raise ValueError(f"dryrun_multichip({n}): NCCL takes one card "
                             f"per rank, {torch.cuda.device_count()} here")
    n = 1 if n is None else n
    init_method = f"tcp://localhost:{free_port()}"
    if n == 1:
        _rank_main(0, 1, init_method, device)
        return
    env = dict(os.environ)
    env["PYTHONPATH"] = f"{REPO_ROOT}{os.pathsep}{env.get('PYTHONPATH', '')}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "commonroad_rp_tpu_torch.parallel.dryrun",
         "--rank", str(rank), "--world-size", str(n), "--init-method",
         init_method, "--device", device.type],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(n)]
    outputs = []
    try:
        for proc in procs:
            outputs.append(proc.communicate(timeout=600)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for rank, (proc, out) in enumerate(zip(procs, outputs)):
        print(out, end="", flush=True)
        if proc.returncode != 0:
            raise RuntimeError(f"dryrun_multichip({n}): rank {rank} exited "
                               f"with {proc.returncode}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--world-size", type=int, default=None)
    parser.add_argument("--rank", type=int, default=None,
                        help="run one rank of a world (with --init-method)")
    parser.add_argument("--init-method", default=None)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)
    logging.getLogger("RP_LOGGER").setLevel(logging.CRITICAL)
    if args.rank is None:
        dryrun_multichip(args.world_size, args.device)
    else:
        _rank_main(args.rank, args.world_size, args.init_method, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
