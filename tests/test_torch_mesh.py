"""The fleet axis over processes (``parallel.mesh``), on the CPU with gloo.

* Two ``python -m commonroad_rp_tpu_torch.parallel.distributed_worker``
  processes, each with its shard of a ZAM_Over fleet: both see the global
  success count (the all-reduce over the group) equal to the global F.
* ``dryrun_multichip(2)``: two gloo ranks through two cycles of the XLA
  fleet path and one cycle of the fused fleet scan.
* The communication volume, counterpart of ``tests/test_fleet_comm_volume.py``:
  under a world-size-1 gloo group, a 3-cycle ``make_fleet_rollout`` and a
  2-cycle ``make_fleet_scan(mesh=group)`` make exactly three one-element
  ``fleet_all_reduce`` calls per cycle and no other collective
  (``all_gather``, ``broadcast``, ``all_to_all``, ``reduce_scatter`` and
  ``scatter`` are patched to raise).
* Under that gloo group both fleet programs run eagerly (``graph`` False):
  the CPU decides, and on the card the same programs capture their cycle
  with the all-reduces in the graph.
"""

import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from commonroad_rp_tpu_torch.ops import grid
from commonroad_rp_tpu_torch.parallel import fleet, mesh, replanning_scan
from commonroad_rp_tpu_torch.parallel.dryrun import (dryrun_multichip,
                                                     free_port, over_problem,
                                                     shared_vehicle)

logging.getLogger("RP_LOGGER").setLevel(logging.CRITICAL)


# subprocess-level guard: proc.communicate(timeout=240), as in
# tests/test_distributed.py
def test_two_process_distributed_fleet(repo_root):
    init_method = f"tcp://localhost:{free_port()}"
    env = dict(os.environ)
    env["PYTHONPATH"] = f"{repo_root}{os.pathsep}{env.get('PYTHONPATH', '')}"
    procs = [
        subprocess.Popen(
            [sys.executable, "-m",
             "commonroad_rp_tpu_torch.parallel.distributed_worker",
             "--rank", str(rank), "--world-size", "2", "--init-method",
             init_method, "--device", "cpu"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        for rank in range(2)]
    outputs = []
    try:
        for proc in procs:
            out, _ = proc.communicate(timeout=240)
            outputs.append(out)
    except subprocess.TimeoutExpired:
        for proc in procs:
            proc.kill()
            proc.wait()
        pytest.fail("distributed workers timed out:\n" + "\n".join(outputs))
    for rank, (proc, out) in enumerate(zip(procs, outputs)):
        assert proc.returncode == 0, f"worker failed:\n{out[-3000:]}"
        assert f"rank {rank}: global fleet_success=4 (expected 4)" in out
        assert f"rank {rank}: DISTRIBUTED OK" in out


def test_dryrun_multichip_two_gloo_ranks(capfd):
    dryrun_multichip(2, device="cpu")
    out = capfd.readouterr().out
    for rank in range(2):
        assert (f"dryrun_multichip(2) rank {rank}: XLA fleet path OK -- "
                "fleet of 4 problems, successes per cycle: [4, 4]") in out
        assert (f"dryrun_multichip(2) rank {rank}: fused fleet scan OK -- "
                "4/4 successes in cycle 0") in out


@pytest.fixture
def world_of_one():
    dist.init_process_group("gloo", store=dist.HashStore(), world_size=1,
                            rank=0)
    try:
        yield mesh.make_fleet_group()
    finally:
        dist.destroy_process_group()


def test_only_scalar_all_reduces(world_of_one, monkeypatch):
    """Three one-element all-reduces per cycle on both fleet paths, and
    nothing else crosses the group."""
    raw = []
    all_reduce = dist.all_reduce

    def counting_all_reduce(tensor, *args, **kwargs):
        raw.append(tensor.numel())
        return all_reduce(tensor, *args, **kwargs)

    def forbidden(name):
        def fail(*args, **kwargs):
            raise AssertionError(f"the fleet paths called {name}")
        return fail

    monkeypatch.setattr(dist, "all_reduce", counting_all_reduce)
    for name in ("all_gather", "all_gather_into_tensor", "broadcast",
                 "all_to_all", "all_to_all_single", "reduce_scatter",
                 "reduce_scatter_tensor", "scatter", "gather", "barrier"):
        monkeypatch.setattr(dist, name, forbidden(name))

    n_steps, dt, F = 15, 0.1, 4
    scene, carry = fleet.build_fleet_scene([over_problem(n_steps)] * F,
                                           n_steps, device="cpu")
    scene, carry, _ = mesh.shard_fleet(scene, carry, 0, 1)
    static_grid = grid.make_static_grid(1, 0.4, n_steps * dt, dt, -3.0, 3.0,
                                        4)
    kw = dict(replan_offset=3, low_vel_threshold=4.0, horizon=n_steps * dt)

    before = mesh.fleet_all_reduce.calls, mesh.fleet_all_reduce.elements
    run = fleet.make_fleet_rollout(world_of_one, shared_vehicle(),
                                   static_grid, dt, n_steps, n_cycles=3,
                                   device="cpu", **kw)
    _, metrics = run(carry, scene)
    assert mesh.fleet_all_reduce.calls - before[0] == 3 * 3
    assert mesh.fleet_all_reduce.elements - before[1] == 3 * 3
    np.testing.assert_array_equal(metrics.fleet_success.numpy(), [F] * 3)

    before = mesh.fleet_all_reduce.calls, mesh.fleet_all_reduce.elements
    scan = replanning_scan.make_fleet_scan(scene, static_grid, dt, n_steps,
                                           n_cycles=2, mesh=world_of_one,
                                           **kw)
    _, fused = scan(carry)
    assert mesh.fleet_all_reduce.calls - before[0] == 3 * 2
    assert mesh.fleet_all_reduce.elements - before[1] == 3 * 2
    np.testing.assert_array_equal(fused[4].numpy(), [F] * 2)
    # every all-reduce went through fleet_all_reduce, each of one element
    assert raw == [1] * (3 * 3 + 3 * 2)


def test_fleet_scan_under_group_matches_alone(world_of_one):
    """The fused scan's aggregates under a group of one equal the scan's
    without a group (the divisor is the global found count, at least 1)."""
    n_steps, dt = 15, 0.1
    scene, carry = fleet.build_fleet_scene([over_problem(n_steps)] * 3,
                                           n_steps, device="cpu")
    static_grid = grid.make_static_grid(1, 0.4, n_steps * dt, dt, -3.0, 3.0,
                                        4)
    kw = dict(replan_offset=3, low_vel_threshold=4.0, horizon=n_steps * dt,
              n_cycles=2)
    _, alone = replanning_scan.make_fleet_scan(scene, static_grid, dt,
                                               n_steps, **kw)(carry)
    _, grouped = replanning_scan.make_fleet_scan(
        scene, static_grid, dt, n_steps, mesh=world_of_one, **kw)(carry)
    for a, b in zip(alone, grouped):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_programs_under_gloo_run_eagerly(world_of_one):
    n_steps, dt = 15, 0.1
    scene, carry = fleet.build_fleet_scene([over_problem(n_steps)] * 2,
                                           n_steps, device="cpu")
    static_grid = grid.make_static_grid(1, 0.4, n_steps * dt, dt, -3.0, 3.0,
                                        4)
    kw = dict(replan_offset=3, low_vel_threshold=4.0, horizon=n_steps * dt,
              n_cycles=1)
    scan = replanning_scan.make_fleet_scan(scene, static_grid, dt, n_steps,
                                           mesh=world_of_one, graph=True,
                                           **kw)
    rollout = fleet.make_fleet_rollout(world_of_one, shared_vehicle(),
                                       static_grid, dt, n_steps,
                                       device="cpu", graph=True, **kw)
    assert not scan.graph and not rollout.graph
    _, metrics = rollout(carry, scene)
    _, fused = scan(carry)
    assert scan.replays == rollout.replays == 0
    np.testing.assert_array_equal(metrics.fleet_success.numpy(), [2])
    np.testing.assert_array_equal(fused[4].numpy(), [2])
