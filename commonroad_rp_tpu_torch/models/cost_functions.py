"""Cost-function objects: parameter holders for the fused scorer.

Counterpart of ``commonroad_rp_tpu/models/cost_functions.py`` (reference:
commonroad_rp/cost_function.py:17-92).  The classes carry the target-state
parameters that the planner mutates between cycles and a static
``structure`` signature; the scorer (``ops.scoring``) evaluates the default
and fail-safe formulas.  The batched cost ops of the conformance path are not
ported yet (ROADMAP queue 1 item 3).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Optional


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

    @property
    def structure(self):
        return ("default", self.desired_speed is not None,
                self.desired_s is not None)


class DefaultCostFunctionFailSafe(CostFunction):
    """Fail-safe planning cost (cost_function.py:74-92)."""

    @property
    def structure(self):
        return ("fail_safe",)
