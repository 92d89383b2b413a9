"""Carry scene state from the JAX package into the port's tensors.

The JAX package (``commonroad_rp_tpu``) keeps its scene state in NamedTuples
of arrays.  These helpers take ``np.asarray`` of every leaf and build the
port's NamedTuple of the same name on a given device, so that both packages
can score identical inputs: a test then separates kernel differences from
host-side differences.  This module imports no JAX; it only reads the
leaves' array protocol.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from commonroad_rp_tpu_torch.ops.collision import (BoundaryArrays,
                                                   CorridorArrays,
                                                   ObstacleArrays)
from commonroad_rp_tpu_torch.ops.cycle import CostParams
from commonroad_rp_tpu_torch.ops.frenet import RefPathTables
from commonroad_rp_tpu_torch.ops.kinematics import (RolloutResult,
                                                    VehicleArrays)
from commonroad_rp_tpu_torch.parallel.fleet import (CycleMetrics,
                                                    FleetCarry, FleetScene)
from commonroad_rp_tpu_torch.parallel.replanning_scan import (
    FacadeScanCarry, ReplanningCarry)


def tensor(leaf, device="cpu", dtype: Optional[torch.dtype] = None):
    """One leaf as a tensor on ``device``: floating leaves in ``dtype``
    (their own precision when None), bool and integer leaves as they are;
    None stays None."""
    if leaf is None:
        return None
    arr = np.asarray(leaf)
    if np.issubdtype(arr.dtype, np.floating) and dtype is not None:
        return torch.as_tensor(arr.copy(), dtype=dtype, device=device)
    return torch.as_tensor(arr.copy(), device=device)


def _convert(obj, cls, device, dtype):
    return cls(*(tensor(getattr(obj, name), device, dtype)
                 for name in cls._fields))


def ref_tables(ref, device="cpu", dtype=None) -> RefPathTables:
    return _convert(ref, RefPathTables, device, dtype)


def obstacles(obs, device="cpu", dtype=None) -> ObstacleArrays:
    return _convert(obs, ObstacleArrays, device, dtype)


def corridor(cor, device="cpu", dtype=None) -> CorridorArrays:
    return _convert(cor, CorridorArrays, device, dtype)


def boundary(bnd, device="cpu", dtype=None) -> BoundaryArrays:
    return _convert(bnd, BoundaryArrays, device, dtype)


def rollout(ro, device="cpu", dtype=None) -> RolloutResult:
    """A JAX ``kinematics.RolloutResult`` ([K, T] state arrays, [K] masks)
    as the port's."""
    return _convert(ro, RolloutResult, device, dtype)


def vehicle(veh) -> VehicleArrays:
    """Vehicle scalars as Python floats (the values the JAX arrays hold)."""
    return VehicleArrays(*(float(np.asarray(getattr(veh, name)))
                           for name in VehicleArrays._fields))


def cost_params(params) -> CostParams:
    """Cost parameters as Python floats."""
    return CostParams(*(float(np.asarray(getattr(params, name)))
                        for name in CostParams._fields))


def candidates(coeffs_lon, coeffs_lat, traj_len, goal_valid,
               level_ids=None, device="cpu", dtype=torch.float32):
    """Candidate arrays: coefficient rows [K, 6] in ``dtype``, int32
    lengths, bool goal mask and (optionally) int32 level ids."""
    out = (tensor(coeffs_lon, device, dtype),
           tensor(coeffs_lat, device, dtype),
           tensor(np.asarray(traj_len).astype(np.int32), device),
           tensor(np.asarray(goal_valid).astype(bool), device))
    if level_ids is not None:
        out = out + (tensor(np.asarray(level_ids).astype(np.int32), device),)
    return out


def fleet_scene(scene, device="cpu", dtype=None) -> FleetScene:
    """A JAX ``parallel.fleet.FleetScene`` (leaves [F, ...]) as the port's,
    vehicle leaves as [F] tensors."""
    fields = {name: tensor(getattr(scene, name), device, dtype)
              for name in FleetScene._fields if name not in ("ref", "veh")}
    return FleetScene(ref=ref_tables(scene.ref, device, dtype),
                      veh=_convert(scene.veh, VehicleArrays, device, dtype),
                      **fields)


def fleet_carry(carry, device="cpu") -> FleetCarry:
    """A JAX ``parallel.fleet.FleetCarry`` as the port's."""
    return _convert(carry, FleetCarry, device, None)


def cycle_metrics(metrics, device="cpu") -> CycleMetrics:
    """A JAX ``parallel.fleet.CycleMetrics`` as the port's (``orientation``
    and ``velocity``, which the JAX metrics lack, stay None)."""
    return CycleMetrics(*(tensor(getattr(metrics, name), device)
                          for name in metrics._fields))


def facade_carry(carry, device="cpu") -> FacadeScanCarry:
    """A JAX ``pallas_fleet.FacadeScanCarry`` as the port's."""
    return _convert(carry, FacadeScanCarry, device, None)


def replanning_carry(carry, device="cpu") -> ReplanningCarry:
    """A JAX ``pallas_fleet.PallasCycleCarry`` as the port's."""
    return _convert(carry, ReplanningCarry, device, None)
