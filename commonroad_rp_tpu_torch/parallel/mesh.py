"""The fleet axis over processes: ``torch.distributed`` in the place of the
JAX package's device mesh.

Counterpart of ``commonroad_rp_tpu/parallel/mesh.py`` and of the
``shard_map``/``psum`` of its fleet paths (``parallel/fleet.py:229-255``,
``parallel/pallas_fleet.py:339-343``).  The JAX package shards the fleet's
leading axis over a 1-D mesh named ``FLEET_AXIS`` and sums the per-cycle
aggregates with ``psum``; here each process (rank) holds one slice of the
fleet (``shard_fleet``), runs its cycles alone, and sums the aggregates over
a process group with ``fleet_all_reduce`` -- the only collective of the fleet
paths: three one-element all-reduces per cycle (success count, cost sum,
finite or found count), whatever the fleet size or candidate count.

Process groups use gloo on the CPU and NCCL on the card; nothing on either
machine tells a program of a cluster, so ``initialize_distributed`` takes
the address (``tcp://localhost:<port>``), the world size and the rank.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

# the name of the fleet axis (the JAX mesh's axis name); the axis itself is
# the process group of make_fleet_group
FLEET_AXIS = "fleet"


def backend_for(device) -> str:
    """``nccl`` for the card, ``gloo`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_distributed(init_method: str, world_size: int, rank: int,
                           device="cuda") -> torch.device:
    """Join the default process group (``init_process_group``) with the
    backend of ``device``; on the card each rank takes card
    ``rank % device_count``.  Returns the rank's device."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize_distributed: device cuda requested "
                               "but torch.cuda.is_available() is false; pass "
                               "device='cpu' for gloo on the CPU")
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    dist.init_process_group(backend_for(device), init_method=init_method,
                            world_size=world_size, rank=rank)
    return device


def make_fleet_group(ranks: Optional[Sequence[int]] = None):
    """The process group over the fleet axis: every rank of the default
    group (``ranks`` None), or the given ranks (every rank of the default
    group must call this, as ``torch.distributed.new_group`` requires)."""
    if ranks is None:
        return dist.group.WORLD
    return dist.new_group(list(ranks))


def shard_fleet(scene, carry, rank: int, world: int):
    """This rank's slice of a ``parallel.fleet`` (FleetScene, FleetCarry):
    ``pad_fleet`` to a multiple of ``world`` (dead padding members), then
    problems [rank * F / world, (rank + 1) * F / world).  Returns (scene,
    carry, original F)."""
    from commonroad_rp_tpu_torch.parallel.fleet import (FleetCarry,
                                                        FleetScene, pad_fleet)

    scene, carry, F = pad_fleet(scene, carry, world)
    n = carry.alive.shape[0] // world
    take = lambda a: a[rank * n:(rank + 1) * n]
    scene = FleetScene(
        ref=type(scene.ref)(*(take(x) for x in scene.ref)),
        **{name: take(getattr(scene, name)) for name in FleetScene._fields
           if name not in ("ref", "veh")},
        veh=type(scene.veh)(*(take(x) for x in scene.veh)))
    carry = FleetCarry(*(take(x) for x in carry))
    return scene, carry, F


def fleet_all_reduce(value: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``value`` over the ranks of ``group`` (``psum`` over the
    fleet axis): the one collective of the fleet paths.  Counts its calls
    (``fleet_all_reduce.calls``) and the elements they reduce
    (``fleet_all_reduce.elements``)."""
    out = value.reshape(-1).clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    fleet_all_reduce.calls += 1
    fleet_all_reduce.elements += out.numel()
    return out.reshape(value.shape)


fleet_all_reduce.calls = 0
fleet_all_reduce.elements = 0
