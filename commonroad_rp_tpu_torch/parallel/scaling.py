"""Weak-scaling sweep of the XLA fleet path over a process group.

Counterpart of ``commonroad_rp_tpu/parallel/scaling.py`` (``:22-99``):
fleet planning throughput (candidate evaluations per second) at increasing
group sizes with a constant load per rank (weak scaling), and efficiency =
throughput(n) / (n * throughput(1)).  The sizes are the powers of two up to
the default group's world size: every rank of the default group joins the
sweep, ranks outside a size's sub-group wait.  On one card the sweep is a
single row, n = 1.  Usage, from the repository root:

    python -m commonroad_rp_tpu_torch.parallel.scaling [--device cuda|cpu]

(without a process group it runs as a group of one, in this process).
"""

from __future__ import annotations

import argparse
import json
import logging
import time
from typing import Dict, List, Optional


def measure_scaling(device="cuda", world_sizes: Optional[List[int]] = None,
                    problems_per_device: int = 4, n_cycles: int = 5,
                    n_steps: int = 10, level: int = 1,
                    repeats: int = 5) -> Dict:
    """Weak-scaling sweep of ``parallel.fleet.make_fleet_rollout`` with
    ``problems_per_device`` ZAM_Over-1_1 problems per rank; returns the
    report (its rows are the timings of this rank's sub-groups)."""
    import torch
    import torch.distributed as dist

    from commonroad_rp_tpu_torch.ops import grid as grid_ops
    from commonroad_rp_tpu_torch.parallel import fleet
    from commonroad_rp_tpu_torch.parallel.dryrun import (free_port,
                                                         over_problem,
                                                         shared_vehicle)
    from commonroad_rp_tpu_torch.parallel.mesh import (initialize_distributed,
                                                       make_fleet_group,
                                                       shard_fleet)

    own_group = not dist.is_initialized()
    if own_group:
        device = initialize_distributed(f"tcp://localhost:{free_port()}", 1,
                                        0, device)
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    try:
        world, rank = dist.get_world_size(), dist.get_rank()
        if world_sizes is None:
            world_sizes = [n for n in (1, 2, 4, 8, 16, 32) if n <= world]
        dt = 0.1
        problem = over_problem(n_steps, horizon_pad=60)
        static_grid = grid_ops.make_static_grid(level, 0.4, n_steps * dt, dt,
                                                -3.0, 3.0, 4)
        K = static_grid.size
        rows = []
        for n in world_sizes:
            group = make_fleet_group(None if n == world else range(n))
            if rank < n:
                F = n * problems_per_device
                scene, carry = fleet.build_fleet_scene(
                    [problem] * F, n_steps, device=device)
                scene, carry, _ = shard_fleet(scene, carry, rank, n)
                run = fleet.make_fleet_rollout(
                    group, shared_vehicle(), static_grid, dt, n_steps,
                    replan_offset=3, low_vel_threshold=4.0,
                    horizon=n_steps * dt, n_cycles=n_cycles, device=device)
                run(carry, scene)
                sync()
                t0 = time.perf_counter()
                for _ in range(repeats):
                    run(carry, scene)
                sync()
                elapsed = (time.perf_counter() - t0) / repeats
                rows.append(dict(devices=n, problems=F,
                                 throughput_evals_per_sec=F * K * n_cycles
                                 / elapsed, time_s=elapsed))
            dist.barrier()
        base = rows[0]["throughput_evals_per_sec"] / rows[0]["devices"]
        for row in rows:
            row["efficiency"] = row["throughput_evals_per_sec"] / (
                row["devices"] * base)
        name = torch.cuda.get_device_name(device) \
            if device.type == "cuda" else "cpu"
        return {"device": name, "candidates_per_cycle": K,
                "cycles": n_cycles,
                "problems_per_device": problems_per_device, "sweep": rows}
    finally:
        if own_group:
            dist.destroy_process_group()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--problems-per-device", type=int, default=4)
    args = parser.parse_args(argv)
    logging.getLogger("RP_LOGGER").setLevel(logging.CRITICAL)
    print(json.dumps(measure_scaling(
        args.device, problems_per_device=args.problems_per_device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
