"""Batched trajectory cost evaluation.

Counterpart of ``commonroad_rp_tpu/ops/cost.py`` (reference:
commonroad_rp/cost_function.py:35-92): the whole bundle's costs are one [K]
reduction over the step axis of the rollout's [T, K] storage.  The exact
weight structure of the reference is preserved, including its mixed squaring
forms (``(5*(v-vd))**2`` vs ``50*(v_end-vd)**2``).
"""

from __future__ import annotations

import torch

from commonroad_rp_tpu_torch.ops.kinematics import RolloutResult


def default_cost(rollout: RolloutResult, w_a, desired_d,
                 desired_speed=None, desired_s=None) -> torch.Tensor:
    """DefaultCostFunction.evaluate for the whole batch (cost_function.py:51-71).

    ``desired_speed``/``desired_s`` are None when unset (velocity cost and
    stopping cost are then omitted, matching the reference's None checks).
    Returns [K] costs; for a fleet's rollout ([F, K, T] arrays) [F, K]
    costs, with per-problem targets [F] (``jax.vmap`` of the JAX function).
    """
    # step-major: the rollout's [(F,) K, T] arrays are views of [T, (F,) K]
    # storage
    v, a = rollout.v.movedim(-1, 0), rollout.a.movedim(-1, 0)
    s, d = rollout.s.movedim(-1, 0), rollout.d.movedim(-1, 0)
    theta_cl = rollout.theta_cl.movedim(-1, 0)
    T = v.shape[0]
    if v.dim() == 3:
        per = lambda x: x.reshape(-1, 1) \
            if isinstance(x, torch.Tensor) and x.dim() == 1 else x
        desired_speed, desired_s = per(desired_speed), per(desired_s)
        desired_d = per(desired_d)

    # acceleration costs (:54)
    costs = torch.sum((w_a * a) ** 2, dim=0)

    # velocity costs (:56-59); the mid index is int(len/2)
    if desired_speed is not None:
        costs = costs + (torch.sum((5.0 * (v - desired_speed)) ** 2, dim=0)
                         + 50.0 * (v[-1] - desired_speed) ** 2
                         + 100.0 * (v[T // 2] - desired_speed) ** 2)

    # longitudinal stopping costs (:60-62)
    if desired_s is not None:
        costs = costs + (torch.sum((0.25 * (desired_s - s)) ** 2, dim=0)
                         + (20.0 * (desired_s - s[-1])) ** 2)

    # lateral distance costs (:65-66)
    costs = costs + (torch.sum((0.25 * (desired_d - d)) ** 2, dim=0)
                     + (20.0 * (desired_d - d[-1])) ** 2)

    # orientation costs (:68-69)
    costs = costs + (torch.sum((0.25 * torch.abs(theta_cl)) ** 2, dim=0)
                     + (5.0 * torch.abs(theta_cl[-1])) ** 2)
    return costs


def fail_safe_cost(rollout: RolloutResult) -> torch.Tensor:
    """DefaultCostFunctionFailSafe.evaluate for the batch (cost_function.py:74-92)."""
    a, d, theta_cl = rollout.a.T, rollout.d.T, rollout.theta_cl.T
    costs = torch.sum((1.0 * a) ** 2, dim=0)
    costs = costs + torch.sum((0.25 * d) ** 2, dim=0) + (20.0 * d[-1]) ** 2
    costs = costs + (torch.sum((0.25 * torch.abs(theta_cl)) ** 2, dim=0)
                     + (5.0 * torch.abs(theta_cl[-1])) ** 2)
    return costs


def structure_costs(rollout: RolloutResult, cost_structure: tuple,
                    cost_params) -> torch.Tensor:
    """[K] costs of the static cost signature ``cost_structure``
    (``models.cost_functions.*.structure``) with ``cost_params``
    (``ops.cycle.CostParams``); any structure other than ``default`` and
    ``fail_safe`` raises ValueError, as the JAX package's
    ``evaluate_level`` does."""
    kind = cost_structure[0]
    if kind == "default":
        _, has_speed, has_s = cost_structure
        return default_cost(
            rollout, w_a=cost_params.w_a, desired_d=cost_params.desired_d,
            desired_speed=cost_params.desired_speed if has_speed else None,
            desired_s=cost_params.desired_s if has_s else None)
    if kind == "fail_safe":
        return fail_safe_cost(rollout)
    raise ValueError(f"unknown cost structure {cost_structure}")

