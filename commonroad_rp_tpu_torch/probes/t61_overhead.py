"""Per-launch overhead of the single-problem T=61 scorer.

Counterpart of ``scripts/t61_overhead_probe.py``, on its scene: ZAM_Over-1_1
as a one-problem fleet, the level-3 grid ``make_static_grid(3, 0.4, 6.0,
0.1, -3, 3, 4)``, T = 61, velocity-keeping candidates toward [18, 25] m/s.
Each phase runs ``--n-scan`` launches back to back on the device and
synchronises once at the end (as ``block_until_ready`` after the JAX scan
does); the best of ``--reps`` runs gives us/launch and M candidates/s.

  A. the production call, ``scoring.score_candidates``, with the desired
     speed ``v`` bumped by 0.001 per launch on the device (the probe's
     scan carry);
  C. the wrapper's host-side operand layout alone, ``scoring.prepare_inputs``
     (the counterpart of the JAX probe's XLA window prelude);
  D. the trivial kernel, ``scoring.trivial_probe``: the scorer's operands,
     no compute, launched through the scorer's library.

Phases B and E of the JAX probe time the TPU's table-window size
(``_WINDOW_ROWS``) and K tile (``tile_k``); the port has neither knob, so
they have no counterpart here.  Usage, from the repository root:

    python -m commonroad_rp_tpu_torch.probes.t61_overhead [--n-scan 150]
        [--reps 5] [--n-steps 60] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import logging
import pathlib
import time

import numpy as np

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent.parent


def probe_operands(n_steps: int = 60, device="cuda",
                   root: pathlib.Path = REPO_ROOT) -> dict:
    """The probe's scene: the scorer's arguments (``args``, ``kwargs`` of
    ``scoring.score_candidates`` without the desired speed) and the grid
    size K."""
    import torch

    from commonroad_rp_tpu_torch.ops import grid as grid_ops
    from commonroad_rp_tpu_torch.ops import scoring
    from commonroad_rp_tpu_torch.ops.collision import (CorridorArrays,
                                                       ObstacleArrays)
    from commonroad_rp_tpu_torch.ops.kinematics import VehicleArrays
    from commonroad_rp_tpu_torch.parallel import fleet
    from commonroad_rp_tpu_torch.utils.config import VehicleConfiguration
    from commonroad_rp_tpu_torch.utils.general import \
        load_scenario_and_planning_problem
    from commonroad_rp_tpu_torch.utils.route import RoutePlanner

    dt, T = 0.1, n_steps + 1
    scenario, pp, _ = load_scenario_and_planning_problem(
        str(root / "example_scenarios" / "ZAM_Over-1_1.xml"))
    route = RoutePlanner(scenario, pp).plan_routes().retrieve_first_route()
    problem = fleet.problem_from_planner_setup(
        scenario, pp, route.reference_path, n_steps=n_steps, horizon_pad=30)
    scene, carry = fleet.build_fleet_scene([problem], n_steps, device=device)
    vc = VehicleConfiguration()
    veh = VehicleArrays(*(float(np.float32(x)) for x in (
        vc.wheelbase, vc.wb_rear_axle, vc.a_max, vc.v_switch,
        np.tan(vc.delta_max) / vc.wheelbase, vc.v_delta_max,
        vc.length / 2, vc.width / 2)))
    grid = grid_ops.make_static_grid(3, 0.4, n_steps * dt, dt, -3.0, 3.0, 4)
    ref1 = type(scene.ref)(*(leaf[0] for leaf in scene.ref))
    packed = scoring.pack_ref_tables(ref1, CorridorArrays(
        scene.corridor_lo[0], scene.corridor_hi[0]))
    obstacles = ObstacleArrays(pose=scene.obs_pose[0, :, :T].contiguous(),
                               half_ext=scene.obs_half[0],
                               valid=scene.obs_valid[0, :, :T].contiguous())
    f32 = lambda x: torch.full((), x, dtype=torch.float32, device=device)
    cl, ca, tl = grid_ops.velocity_keeping_candidates(
        carry.x0_lon[0], carry.x0_lat[0], f32(18.0), f32(25.0), False, grid)
    args = (cl, ca, tl, torch.ones(grid.size, dtype=torch.bool,
                                   device=device),
            packed, obstacles, veh, carry.orientation[0], 0.1, False)
    return dict(args=args, ref_s_last=scoring.true_path_length(ref1),
                n_steps=n_steps, K=grid.size)


def run_phases(ops: dict, n_scan: int, reps: int, device="cuda") -> dict:
    """{phase: (us per launch, M candidates/s)} of phases A, C and D, each
    the best of ``reps`` runs of ``n_scan`` launches."""
    import torch

    from commonroad_rp_tpu_torch.ops import scoring

    args, n_steps, K = ops["args"], ops["n_steps"], ops["K"]
    tail = (0.0, 5.0, ops["ref_s_last"])
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" \
        else (lambda: None)
    inp = scoring.prepare_inputs(*args, 20.0, *tail, n_steps=n_steps)

    def phase_a(v):
        costs, _, _ = scoring.score_candidates(*args, v, *tail,
                                               n_steps=n_steps)
        return v + 0.001, costs

    def phase_c(v):
        return v + 0.001, scoring.prepare_inputs(*args, v, *tail,
                                                 n_steps=n_steps)

    def phase_d(v):
        return v + 0.001, scoring.trivial_probe(inp, v)

    out = {}
    for name, body in (("A full scorer call", phase_a),
                       ("C operand layout only", phase_c),
                       ("D trivial kernel", phase_d)):
        times = []
        for _ in range(reps + 1):                       # the first warms up
            v = torch.full((), 20.0, dtype=torch.float32, device=device)
            sync()
            t0 = time.perf_counter()
            for _ in range(n_scan):
                v, _ = body(v)
            sync()
            times.append(time.perf_counter() - t0)
        per_launch = min(times[1:]) / n_scan
        out[name] = (per_launch * 1e6, K / per_launch / 1e6)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n-scan", type=int, default=150)
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--n-steps", type=int, default=60)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="default: cuda (raises without a card; the "
                             "CPU runs only when named)")
    args = parser.parse_args(argv)

    from commonroad_rp_tpu_torch.models.planner import resolve_device

    logging.getLogger("RP_LOGGER").setLevel(logging.CRITICAL)
    device = resolve_device(args.device)
    ops = probe_operands(args.n_steps, device)
    print(f"K={ops['K']} T={args.n_steps + 1} n_scan={args.n_scan} "
          f"device={device}", flush=True)
    for name, (us, rate) in run_phases(ops, args.n_scan, args.reps,
                                       device).items():
        print(f"{name:28s}: {us:8.1f} us/launch {rate:7.2f} M cands/s",
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
