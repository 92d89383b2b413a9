"""One rank of a multi-process fleet-planning run.

Counterpart of ``scripts/distributed_worker.py``: N processes (one per
simulated host, or one per card), each joining one process group, holding
its shard of a ZAM_Over-1_1 fleet (``parallel.mesh.shard_fleet``) and
running one cycle of the XLA fleet step; the fleet success count is summed
over the group (``parallel.mesh.fleet_all_reduce``) and must equal the
GLOBAL fleet size on every process.  Run N times, from the repository root:

    python -m commonroad_rp_tpu_torch.parallel.distributed_worker \\
        --rank R --world-size N --init-method tcp://localhost:12421 \\
        [--problems-per-process 2] [--device cuda|cpu]

(gloo ranks on the CPU, NCCL ranks on the cards, one card per rank).
"""

from __future__ import annotations

import argparse
import logging


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rank", type=int, required=True)
    parser.add_argument("--world-size", type=int, required=True)
    parser.add_argument("--init-method", default="tcp://localhost:12421")
    parser.add_argument("--problems-per-process", type=int, default=2)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)

    import torch.distributed as dist

    from commonroad_rp_tpu_torch.ops import grid as grid_ops
    from commonroad_rp_tpu_torch.parallel import fleet
    from commonroad_rp_tpu_torch.parallel.dryrun import (over_problem,
                                                         shared_vehicle)
    from commonroad_rp_tpu_torch.parallel.mesh import (initialize_distributed,
                                                       make_fleet_group,
                                                       shard_fleet)

    logging.getLogger("RP_LOGGER").setLevel(logging.CRITICAL)
    device = initialize_distributed(args.init_method, args.world_size,
                                    args.rank, args.device)
    try:
        n_steps, dt = 10, 0.1
        F = args.world_size * args.problems_per_process
        scene, carry = fleet.build_fleet_scene(
            [over_problem(n_steps)] * F, n_steps, device=device)
        scene, carry, _ = shard_fleet(scene, carry, args.rank,
                                      args.world_size)
        static_grid = grid_ops.make_static_grid(1, 0.4, n_steps * dt, dt,
                                                -3.0, 3.0, 4)
        step = fleet.make_fleet_step(
            make_fleet_group(), shared_vehicle(), static_grid, dt, n_steps,
            replan_offset=3, low_vel_threshold=4.0, horizon=n_steps * dt,
            device=device)
        _, metrics = step(carry, scene)
        # the success count is summed over the whole group: every rank sees F
        success = int(metrics.fleet_success)
        print(f"rank {args.rank}: global fleet_success={success} (expected "
              f"{F}) world size={args.world_size} device={device}",
              flush=True)
        if success != F:
            raise AssertionError(f"all-reduce mismatch: {success} != {F}")
        print(f"rank {args.rank}: DISTRIBUTED OK", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
