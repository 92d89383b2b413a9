"""The planning-cycle programs: the conformance level program and the
fused-scorer cycle.

Counterpart of ``commonroad_rp_tpu/ops/cycle.py``.

* ``evaluate_level`` -- the conformance level program (the JAX package's
  default path off the TPU, in float32 or float64): the K-wide rollout
  (``ops.kinematics``), the batched costs (``ops.cost``), the exact collision
  checks (``ops.collision``, whose box/disc obstacle pass is the CUDA kernel
  of ``ops.collision_kernel`` on the card), argmin selection and the packed
  host outputs.  It replaces the reference's ``_get_optimal_trajectory``
  stage chain (reactive_planner.py:1065-1136) with mask + argmin semantics.
* ``evaluate_levels_fast`` -- every sampling level's bundle scored in one
  ``ops.scoring.score_candidates`` launch; the winner comes from the first
  level with a feasible collision-free candidate (the reference's escalation
  loop, reactive_planner.py:616-636) and is re-rolled as a K=1 batch for its
  [14, T] state arrays.  The exact ``segments`` boundary and the continuous
  swept pass refine the selection: as the JAX ``while_loop`` does, one
  winner at a time (``lazy_refinement``, a host loop that reads the device
  per re-selection), or ``REFINE_WIDTH`` candidates at once without a
  device read (``refine_cheapest``, what the captured programs run).

``ops.level_program.LevelProgram`` runs both programs as one captured CUDA
graph per jit signature; the functions here are its bodies and the eager
forms.

The rejection counters follow the reference's lazy sorted iteration
(:1031-1046): ``n_coll`` counts kinematically feasible candidates that
collide AND rank before the winner in cost order.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from commonroad_rp_tpu_torch.ops import collision as collision_ops
from commonroad_rp_tpu_torch.ops import cost as cost_ops
from commonroad_rp_tpu_torch.ops import frenet as frenet_ops
from commonroad_rp_tpu_torch.ops import kinematics
from commonroad_rp_tpu_torch.ops import scoring


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


class LevelResult(NamedTuple):
    """Output of one conformance level evaluation (everything the host
    needs), packed into few tensors: one readback of ``scalars`` and
    ``optimal`` per cycle, the masks and costs only when consumed."""

    found: torch.Tensor           # 0-d bool: any feasible & collision-free
    scalars: torch.Tensor         # [4]: best_idx, best_cost, n_inf_kin, n_coll
    masks: torch.Tensor           # [3, K] int32: feasible, collides, reason
    costs: torch.Tensor           # [K] costs (all candidates)
    optimal: torch.Tensor         # [14, T] best candidate (CANDIDATE_FIELDS)
    rollout: kinematics.RolloutResult     # dense [K, T] state arrays


def evaluate_level(coeffs_lon: torch.Tensor,
                   coeffs_lat: torch.Tensor,
                   traj_len: torch.Tensor,
                   goal_valid: torch.Tensor,
                   ref: frenet_ops.RefPathTables,
                   veh: kinematics.VehicleArrays,
                   obstacles: collision_ops.ObstacleArrays,
                   boundary: Optional[collision_ops.BoundaryArrays],
                   corridor: Optional[collision_ops.CorridorArrays],
                   x0_orientation,
                   cost_params: CostParams,
                   *,
                   dt: float,
                   n_steps: int,
                   low_vel_mode: bool,
                   cost_structure: tuple,
                   constraint_flags: tuple,
                   boundary_mode: str,
                   continuous_check: bool = False) -> LevelResult:
    """Evaluate one sampling level end to end on the tensors' device, in
    the coefficients' dtype.

    ``goal_valid`` [K] pre-masks candidates (filter_goals_behind semantics,
    trajectories.py:545-550; all-true in velocity mode).
    ``cost_structure`` is the static cost signature
    (models.cost_functions.*.structure); ``constraint_flags`` the 5-tuple of
    active kinematic constraints in reference order.  ``boundary_mode``
    selects the road-boundary check: 'corridor' (d-band probes), 'segments'
    (exact OBB-vs-segment SAT), or 'none'.
    """
    cv, ca, ck, ckd, cy = constraint_flags
    rollout = kinematics.rollout(
        coeffs_lon, coeffs_lat, traj_len, ref, veh, x0_orientation,
        dt, n_steps, low_vel_mode,
        check_velocity=cv, check_acceleration=ca, check_kappa=ck,
        check_kappa_dot=ckd, check_yaw_rate=cy)
    costs = cost_ops.structure_costs(rollout, cost_structure, cost_params)

    collides = collision_ops.check_collisions(
        rollout.x, rollout.y, rollout.theta_gl, obstacles,
        boundary if boundary_mode == "segments" else None,
        veh.half_length, veh.half_width, veh.wb_rear_axle)
    if boundary_mode == "corridor":
        collides = collides | collision_ops.check_corridor(
            rollout.s, rollout.d, rollout.theta_cl, ref.s, corridor,
            veh.half_length, veh.half_width, veh.wb_rear_axle)
    if continuous_check:
        # swept-OBB pass between consecutive steps (reactive_planner.py:1049-1058)
        collides = collides | collision_ops.check_collisions_continuous(
            rollout.x, rollout.y, rollout.theta_gl, obstacles,
            veh.half_length, veh.half_width, veh.wb_rear_axle)

    goal_valid = goal_valid.to(torch.bool)
    feasible = rollout.feasible & goal_valid
    ok = feasible & ~collides
    inf = torch.full((), np.inf, dtype=costs.dtype, device=costs.device)
    # non-finite costs (NaN/overflow) must not win the argmin: the
    # reference's sorted iteration would skip past them to a finite winner
    masked = torch.where(ok & torch.isfinite(costs), costs, inf)
    best_cost, best_idx = torch.min(masked, dim=0)
    found = torch.isfinite(best_cost)

    # goal-filtered candidates are removed from the bundle BEFORE the
    # kinematic check in the reference (reactive_planner.py:1076-1077), so
    # they do not count as kinematically infeasible
    n_inf_kin = torch.sum(goal_valid & ~rollout.feasible)
    # lazy-iteration collision count: feasible, colliding, cheaper than the
    # winner (strict <: the measure-zero tie class of doc/conformance.md
    # divergence 1); with no winner the lazy loop visits every feasible one
    n_coll = torch.where(found,
                         torch.sum(feasible & collides & (costs < best_cost)),
                         torch.sum(feasible & collides))

    dtype = costs.dtype
    scalars = torch.stack([best_idx.to(dtype), best_cost,
                           n_inf_kin.to(dtype), n_coll.to(dtype)])
    masks = torch.stack([feasible.to(torch.int32), collides.to(torch.int32),
                         rollout.reason])
    return LevelResult(found=found, scalars=scalars, masks=masks, costs=costs,
                       optimal=gather_candidate(rollout, best_idx),
                       rollout=rollout)


def gather_candidate(rollout: kinematics.RolloutResult,
                     idx: torch.Tensor) -> torch.Tensor:
    """One candidate's state arrays as one packed [14, T] tensor
    (CANDIDATE_FIELDS order); ``idx`` is a 0-d index tensor (no device
    read)."""
    pick = idx.reshape(1).to(torch.int64)
    return torch.stack([torch.index_select(getattr(rollout, f), 0, pick)[0]
                        for f in CANDIDATE_FIELDS])


class FastLevelResult(NamedTuple):
    """Output of one fused-scorer cycle (tensors on the planner's device)."""

    found: torch.Tensor           # 0-d bool
    scalars: torch.Tensor         # [6] f32: best_idx, best_cost, n_inf_kin,
                                  #     n_coll, reroll-feasible flag, level
    costs: torch.Tensor           # [K] masked costs (+inf infeasible/colliding)
    kin_costs: torch.Tensor       # [K] kinematic-feasible raw costs
    reasons: torch.Tensor         # [K] int32 first-failure codes (REASON_*)
    optimal: torch.Tensor         # [14, T] best candidate (CANDIDATE_FIELDS)
    overflow: torch.Tensor        # 0-d bool: the bounded refinement stopped
                                  #     short (``refine_cheapest``)


# candidates the bounded refinement re-rolls and checks at once: the bundled
# scenarios need at most 4 re-selections in a cycle (the T-junction with the
# segments boundary, pinned by tests/test_torch_refinement.py); past it
# plan_scan raises after the scan and plan() goes on eagerly
REFINE_WIDTH = 32


def unpack_candidate(packed) -> dict:
    """[14, T] packed candidate -> {field: [T] numpy array}."""
    arr = packed.detach().cpu().numpy() if isinstance(packed, torch.Tensor) \
        else np.asarray(packed)
    return {name: arr[i] for i, name in enumerate(CANDIDATE_FIELDS)}


def exact_refinement(boundary: Optional[collision_ops.BoundaryArrays],
                     continuous: bool):
    """The exact checks that the fused scorer does not mask densely, as
    ``colliding(rollout, obstacles, veh) -> [K']`` bool over re-rolled
    candidates: the ``segments`` road-boundary SAT (when ``boundary`` has
    segments) and the continuous swept-OBB pass against ``obstacles``;
    None when neither applies."""
    segments = boundary is not None and boundary.segments.shape[0] > 0
    if not (segments or continuous):
        return None

    def colliding(ro: kinematics.RolloutResult, obstacles, veh):
        K, T = ro.x.shape
        out = torch.zeros(K, dtype=torch.bool, device=ro.x.device)
        if segments:
            empty = collision_ops.ObstacleArrays(
                pose=ro.x.new_zeros((0, T, 3)),
                half_ext=ro.x.new_zeros((0, 2)),
                valid=torch.zeros((0, T), dtype=torch.bool,
                                  device=ro.x.device))
            out = out | collision_ops.check_collisions(
                ro.x, ro.y, ro.theta_gl, empty, boundary, veh.half_length,
                veh.half_width, veh.wb_rear_axle)
        if continuous:
            out = out | collision_ops.check_collisions_continuous(
                ro.x, ro.y, ro.theta_gl, obstacles, veh.half_length,
                veh.half_width, veh.wb_rear_axle)
        return out

    return colliding


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


def refine_cheapest(masked: torch.Tensor, kin: torch.Tensor,
                    goal_valid: torch.Tensor, level_ids: torch.Tensor,
                    n_levels: int, width: int, reroll, colliding):
    """The lazy winner refinement without device reads (mirror of the JAX
    package's ``while_loop``, cycle.py:316-318 and pallas_fleet.py:647-677).

    The lazy loop (:func:`lazy_refinement`) selects a winner
    (:func:`select_across_levels`), re-rolls it, and masks it to +inf if the
    exact checks find a collision, until a winner passes: it visits the
    selectable candidates in selection order (first level with a finite
    cost, then cost, then index) and masks the colliding run at the head of
    that order.  Here the first ``width`` of that order are re-rolled
    (``reroll(idx) -> RolloutResult``) and checked (``colliding(rollout) ->
    [width]``) at once, and the colliding run at their head is masked: the
    lazy loop's masked row, whenever that run ends inside the width.
    Returns (masked, reselections, overflow) as device tensors:
    ``reselections`` is the lazy loop's count of masked winners, and
    ``overflow`` is true when all ``width`` candidates collided and more
    selectable ones remain, where the lazy loop would go on (from the
    returned row: :func:`lazy_refinement` continues it).
    """
    width = min(width, masked.shape[0])
    inf = torch.full((), np.inf, dtype=masked.dtype, device=masked.device)
    sel = torch.where(torch.isnan(masked), inf, masked)
    finite = torch.isfinite(sel)
    level_key = torch.where(finite, level_ids.to(torch.int64), n_levels)
    order = torch.argsort(sel, stable=True)
    order = order[torch.argsort(level_key[order], stable=True)]
    idx = order[:width]
    bad = colliding(reroll(idx)) & finite[idx]
    head = torch.cumprod(bad.to(torch.int32), 0)
    masked = masked.index_put((idx,), torch.where(head > 0, inf, masked[idx]))
    reselections = torch.sum(head)
    overflow = (torch.sum(finite) > width) & torch.all(bad)
    return masked, reselections, overflow


def lazy_refinement(masked: torch.Tensor, kin: torch.Tensor,
                    goal_valid: torch.Tensor, level_ids: torch.Tensor,
                    n_levels: int, reroll, colliding) -> torch.Tensor:
    """The lazy winner refinement as the JAX ``while_loop`` runs it
    (reference reactive_planner.py:1031-1062): re-roll the current winner
    (``reroll(idx) -> RolloutResult`` for [1] indices), apply the exact
    checks (``colliding(rollout) -> [1]``), mask a colliding winner to +inf
    and re-select until one passes.  A host loop: it reads the device twice
    per re-selection.  Returns the masked row."""
    while True:
        found_i, bi, *_ = select_across_levels(masked, kin, goal_valid,
                                               level_ids, n_levels)
        if not bool(found_i):
            return masked
        if not bool(colliding(reroll(bi.reshape(1)))[0]):
            return masked
        masked = masked.index_fill(0, bi.reshape(1), np.inf)


def scorer_arguments(coeffs_lon, coeffs_lat, traj_len, goal_valid, ref,
                     veh, obstacles, corridor, x0_orientation, cost_params,
                     *, dt, n_steps, low_vel_mode, cost_structure,
                     constraint_flags, scalar_row=None):
    """(args, kwargs) of the ``scoring.score_candidates`` launch of one
    cycle: float32 casts and table packing.  ``scalar_row``: the scorer's
    [17] scalar row when the caller keeps it on the device (a captured
    program); None builds it from the arguments."""
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
        # the JAX package evaluates no other cost structure on any path
        # (its evaluate_level raises the same ValueError)
        raise ValueError(f"unknown cost structure {cost_structure}")
    ref = frenet_ops.RefPathTables(*(t.to(f32) for t in ref))
    corridor = collision_ops.CorridorArrays(*(t.to(f32) for t in corridor))
    args = (coeffs_lon.to(f32).contiguous(), coeffs_lat.to(f32).contiguous(),
            traj_len, goal_valid, scoring.pack_ref_tables(ref, corridor),
            obstacles, veh, x0_orientation, dt, bool(low_vel_mode),
            cost_params.desired_speed, cost_params.desired_d,
            cost_params.w_a, scoring.true_path_length(ref),
            cost_params.desired_s if has_s else None)
    kwargs = dict(n_steps=n_steps, check_flags=tuple(constraint_flags),
                  has_desired_v=has_speed, scalars=scalar_row)
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
                         continuous: bool = False,
                         refine_width: Optional[int] = None,
                         scalar_row: Optional[torch.Tensor] = None
                         ) -> FastLevelResult:
    """All sampling levels scored in ONE kernel launch (the main path).

    The candidate tensors concatenate every level's batch, with
    ``level_ids`` [K] naming each candidate's level; the scene tensors are
    float32, the scorer's dtype.  ``refine_width`` selects the exact
    refinement's form: None, the lazy loop (:func:`lazy_refinement`); a
    width, :func:`refine_cheapest`, which reads nothing from the device and
    reports ``overflow``.  ``scalar_row``: see :func:`scorer_arguments`.
    """
    masked, kin, reasons = _score_union_fast(
        coeffs_lon, coeffs_lat, traj_len, goal_valid, ref, veh, obstacles,
        corridor, x0_orientation, cost_params, dt=dt, n_steps=n_steps,
        low_vel_mode=low_vel_mode, cost_structure=cost_structure,
        constraint_flags=constraint_flags, scalar_row=scalar_row)
    return select_levels_fast(
        masked, kin, reasons, coeffs_lon, coeffs_lat, traj_len, goal_valid,
        level_ids, ref, veh, obstacles, x0_orientation, boundary, dt=dt,
        n_steps=n_steps, low_vel_mode=low_vel_mode,
        constraint_flags=constraint_flags, n_levels=n_levels,
        continuous=continuous, refine_width=refine_width)


def select_levels_fast(masked, kin, reasons, coeffs_lon, coeffs_lat,
                       traj_len, goal_valid, level_ids, ref, veh, obstacles,
                       x0_orientation, boundary=None, *, dt, n_steps,
                       low_vel_mode, constraint_flags, n_levels,
                       continuous=False,
                       refine_width=None) -> FastLevelResult:
    """The fused cycle after the scorer: the exact refinement, the
    escalation selection and the K=1 re-roll of the winner, from the
    scorer's rows (masked, kin, reason) [K]."""
    dtype = masked.dtype
    overflow = torch.zeros((), dtype=torch.bool, device=masked.device)
    colliding = exact_refinement(boundary, continuous)
    if colliding is not None:
        reroll = lambda idx: kinematics.rollout(
            coeffs_lon[idx], coeffs_lat[idx], traj_len[idx], ref, veh,
            x0_orientation, dt, n_steps, low_vel_mode)
        check = lambda ro: colliding(ro, obstacles, veh)
        if refine_width is None:
            masked = lazy_refinement(masked, kin, goal_valid, level_ids,
                                     n_levels, reroll, check)
        else:
            masked, _, overflow = refine_cheapest(
                masked, kin, goal_valid, level_ids, n_levels, refine_width,
                reroll, check)

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
                           optimal=optimal, overflow=overflow)


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
