"""Cost-function objects: parameter holders for the batched cost ops.

Counterpart of ``commonroad_rp_tpu/models/cost_functions.py`` (reference:
commonroad_rp/cost_function.py:17-92).  The classes carry the target-state
parameters that the planner mutates between cycles and a static
``structure`` signature; the fused scorer (``ops.scoring``) and the
conformance level program (``ops.cycle.evaluate_level`` over ``ops.cost``)
evaluate the default and fail-safe formulas.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Optional

import torch

from commonroad_rp_tpu_torch.ops import cost as cost_ops
from commonroad_rp_tpu_torch.ops.kinematics import RolloutResult


class CostFunction(ABC):
    """Abstract base (cost_function.py:17-32)."""

    @property
    @abstractmethod
    def structure(self) -> tuple:
        """Static signature of the cost formula."""


class DefaultCostFunction(CostFunction):
    """Comfort-driving cost (cost_function.py:35-71).

    Attributes are mutated by the planner: ``desired_speed``/``desired_s`` via
    the set_desired_* methods, ``w_a`` flips between 5 (velocity keeping) and
    1 (stopping) (reactive_planner.py:344, :376).
    """

    def __init__(self, desired_speed: Optional[float] = None,
                 desired_d: float = 0.0, desired_s: Optional[float] = None):
        self.desired_speed = desired_speed
        self.desired_d = desired_d
        self.desired_s = desired_s
        self.w_a = 5.0

    def evaluate_batch(self, rollout: RolloutResult) -> torch.Tensor:
        """[K] costs for a rollout batch."""
        return cost_ops.default_cost(
            rollout, w_a=self.w_a, desired_d=self.desired_d,
            desired_speed=self.desired_speed, desired_s=self.desired_s)

    @property
    def structure(self):
        return ("default", self.desired_speed is not None,
                self.desired_s is not None)


class DefaultCostFunctionFailSafe(CostFunction):
    """Fail-safe planning cost (cost_function.py:74-92)."""

    def evaluate_batch(self, rollout: RolloutResult) -> torch.Tensor:
        """[K] costs for a rollout batch."""
        return cost_ops.fail_safe_cost(rollout)

    @property
    def structure(self):
        return ("fail_safe",)
