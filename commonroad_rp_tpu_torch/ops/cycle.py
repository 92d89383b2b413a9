"""One planning cycle on the fused scorer: score, select, re-roll the winner.

Counterpart of the fast half of ``commonroad_rp_tpu/ops/cycle.py``.  Every
sampling level's bundle is scored in one ``ops.scoring.score_candidates``
launch; the winner comes from the first level with a feasible collision-free
candidate (the reference's escalation loop, reactive_planner.py:616-636),
the rejection counters follow the reference's lazy sorted iteration
(:1031-1046), and the winner is re-rolled as a K=1 batch through
``kinematics.rollout`` for its [14, T] state arrays.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from commonroad_rp_tpu_torch.ops import collision as collision_ops
from commonroad_rp_tpu_torch.ops import frenet as frenet_ops
from commonroad_rp_tpu_torch.ops import kinematics
from commonroad_rp_tpu_torch.ops import scoring

_ROADMAP_SEGMENTS = ("the exact 'segments' boundary and continuous collision "
                     "checking run as lazy winner refinement, not ported yet "
                     "(ROADMAP queue 1 item 3)")


class CostParams(NamedTuple):
    """Cost-function parameters (models.cost_functions.DefaultCostFunction);
    floats or 0-d tensors."""

    w_a: object
    desired_d: object
    desired_speed: object   # ignored unless the structure has a speed target
    desired_s: object       # ignored unless the structure has a stop target


CANDIDATE_FIELDS = ("s", "s_dot", "s_ddot", "d", "d_dot", "d_ddot",
                    "theta_cl", "x", "y", "theta_gl", "v", "a", "kappa_gl",
                    "kappa_dot")


class FastLevelResult(NamedTuple):
    """Output of one fused-scorer cycle (tensors on the planner's device)."""

    found: torch.Tensor           # 0-d bool
    scalars: torch.Tensor         # [6] f32: best_idx, best_cost, n_inf_kin,
                                  #     n_coll, reroll-feasible flag, level
    costs: torch.Tensor           # [K] masked costs (+inf infeasible/colliding)
    kin_costs: torch.Tensor       # [K] kinematic-feasible raw costs
    reasons: torch.Tensor         # [K] int32 first-failure codes (REASON_*)
    optimal: torch.Tensor         # [14, T] best candidate (CANDIDATE_FIELDS)


def unpack_candidate(packed) -> dict:
    """[14, T] packed candidate -> {field: [T] numpy array}."""
    arr = packed.detach().cpu().numpy() if isinstance(packed, torch.Tensor) \
        else np.asarray(packed)
    return {name: arr[i] for i, name in enumerate(CANDIDATE_FIELDS)}


def select_across_levels(masked: torch.Tensor, kin: torch.Tensor,
                         goal_valid: torch.Tensor, level_ids: torch.Tensor,
                         n_levels: int):
    """Level-escalation selection over a union bundle.

    Returns (found, best_idx, best_cost, stat_level, n_inf_kin, n_coll) as
    0-d tensors: the winner comes from the FIRST level with any feasible
    collision-free candidate; statistics follow the selected level (the last
    level when nothing is found).  NaN costs never win (mapped to +inf).
    """
    inf = torch.full((), np.inf, dtype=masked.dtype, device=masked.device)
    sel = torch.where(torch.isnan(masked), inf, masked)
    lv = level_ids.to(torch.int64)
    goal_valid = goal_valid.to(torch.bool)

    # indices stay 0-d device tensors (gather, not item-indexing): the
    # selection never waits for the device
    take = lambda x, i: torch.gather(x, 0, i.reshape(1))[0]
    best_per_level = []
    found_per_level = []
    for level in range(n_levels):
        best, idx = torch.min(torch.where(lv == level, sel, inf), dim=0)
        best_per_level.append(idx)
        found_per_level.append(torch.isfinite(best))
    found_vec = torch.stack(found_per_level)
    any_found = torch.any(found_vec)
    sel_level = torch.argmax(found_vec.to(torch.uint8))
    stat_level = torch.where(any_found, sel_level,
                             torch.full_like(sel_level, n_levels - 1))
    best_idx = take(torch.stack(best_per_level), sel_level)
    best_cost = torch.where(any_found, take(sel, best_idx), inf)

    level_mask = lv == stat_level
    kin_inf = torch.isinf(kin)
    n_inf_kin = torch.sum(goal_valid & kin_inf & level_mask)
    colliding = ~kin_inf & torch.isinf(masked) & level_mask
    n_coll = torch.where(any_found, torch.sum(colliding & (kin < best_cost)),
                         torch.sum(colliding))
    return any_found, best_idx, best_cost, stat_level, n_inf_kin, n_coll


def scorer_arguments(coeffs_lon, coeffs_lat, traj_len, goal_valid, ref,
                     veh, obstacles, corridor, x0_orientation, cost_params,
                     *, dt, n_steps, low_vel_mode, cost_structure,
                     constraint_flags):
    """(args, kwargs) of the ``scoring.score_candidates`` launch of one
    cycle: float32 casts and table packing."""
    f32 = torch.float32
    kind = cost_structure[0]
    if kind == "default":
        _, has_speed, has_s = cost_structure
    elif kind == "fail_safe":
        # DefaultCostFunctionFailSafe is the default formula at w_a=1,
        # desired_d=0 without the velocity and stopping terms (the caller's
        # CostParams carry the weights)
        has_speed, has_s = False, False
    else:
        raise NotImplementedError(
            f"fused scorer: cost structure {cost_structure!r}; custom cost "
            "functions run on the conformance path, not ported yet (ROADMAP "
            "queue 1 item 5)")
    ref = frenet_ops.RefPathTables(*(t.to(f32) for t in ref))
    corridor = collision_ops.CorridorArrays(*(t.to(f32) for t in corridor))
    args = (coeffs_lon.to(f32).contiguous(), coeffs_lat.to(f32).contiguous(),
            traj_len, goal_valid, scoring.pack_ref_tables(ref, corridor),
            obstacles, veh, x0_orientation, dt, bool(low_vel_mode),
            cost_params.desired_speed, cost_params.desired_d,
            cost_params.w_a, scoring.true_path_length(ref),
            cost_params.desired_s if has_s else None)
    kwargs = dict(n_steps=n_steps, check_flags=tuple(constraint_flags),
                  has_desired_v=has_speed)
    return args, kwargs


def _score_union_fast(*args, **kwargs):
    """The scorer launch of one cycle (arguments of
    :func:`scorer_arguments`): (masked, kin, reason) rows [K]."""
    score_args, score_kwargs = scorer_arguments(*args, **kwargs)
    return scoring.score_candidates(*score_args, **score_kwargs)


def evaluate_levels_fast(coeffs_lon: torch.Tensor,
                         coeffs_lat: torch.Tensor,
                         traj_len: torch.Tensor,
                         goal_valid: torch.Tensor,
                         level_ids: torch.Tensor,
                         ref: frenet_ops.RefPathTables,
                         veh: kinematics.VehicleArrays,
                         obstacles: collision_ops.ObstacleArrays,
                         corridor: collision_ops.CorridorArrays,
                         x0_orientation,
                         cost_params: CostParams,
                         boundary: collision_ops.BoundaryArrays = None,
                         *,
                         dt: float,
                         n_steps: int,
                         low_vel_mode: bool,
                         cost_structure: tuple,
                         constraint_flags: tuple,
                         n_levels: int,
                         continuous: bool = False) -> FastLevelResult:
    """All sampling levels scored in ONE kernel launch (the main path).

    The candidate tensors concatenate every level's batch, with
    ``level_ids`` [K] naming each candidate's level.
    """
    if (boundary is not None and boundary.segments.shape[0] > 0) \
            or continuous:
        raise NotImplementedError(_ROADMAP_SEGMENTS)
    masked, kin, reasons = _score_union_fast(
        coeffs_lon, coeffs_lat, traj_len, goal_valid, ref, veh, obstacles,
        corridor, x0_orientation, cost_params, dt=dt, n_steps=n_steps,
        low_vel_mode=low_vel_mode, cost_structure=cost_structure,
        constraint_flags=constraint_flags)
    dtype = masked.dtype

    (found, best_idx, best_cost, stat_level,
     n_inf_kin, n_coll) = select_across_levels(masked, kin, goal_valid,
                                               level_ids, n_levels)

    cv, ca, ck, ckd, cy = constraint_flags
    f32 = torch.float32
    pick = lambda x: torch.index_select(x, 0, best_idx.reshape(1))
    ro = kinematics.rollout(
        pick(coeffs_lon).to(f32), pick(coeffs_lat).to(f32),
        pick(traj_len), ref, veh, x0_orientation, dt, n_steps,
        low_vel_mode, check_velocity=cv, check_acceleration=ca,
        check_kappa=ck, check_kappa_dot=ckd, check_yaw_rate=cy)
    optimal = torch.stack([getattr(ro, f)[0] for f in CANDIDATE_FIELDS])

    scalars = torch.stack([best_idx.to(dtype), best_cost,
                           n_inf_kin.to(dtype), n_coll.to(dtype),
                           ro.feasible[0].to(dtype), stat_level.to(dtype)])
    return FastLevelResult(found=found, scalars=scalars, costs=masked,
                           kin_costs=kin, reasons=reasons.to(torch.int32),
                           optimal=optimal)


def evaluate_level_fast(coeffs_lon, coeffs_lat, traj_len, goal_valid, ref,
                        veh, obstacles, corridor, x0_orientation,
                        cost_params, boundary=None, *, dt, n_steps,
                        low_vel_mode, cost_structure, constraint_flags,
                        continuous=False) -> FastLevelResult:
    """One sampling level on the fused scorer + the K=1 winner re-roll."""
    level_ids = torch.zeros(coeffs_lon.shape[0], dtype=torch.int32,
                            device=coeffs_lon.device)
    return evaluate_levels_fast(
        coeffs_lon, coeffs_lat, traj_len, goal_valid, level_ids, ref, veh,
        obstacles, corridor, x0_orientation, cost_params, boundary, dt=dt,
        n_steps=n_steps, low_vel_mode=low_vel_mode,
        cost_structure=cost_structure, constraint_flags=constraint_flags,
        n_levels=1, continuous=continuous)
