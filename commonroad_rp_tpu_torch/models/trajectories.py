"""Trajectory output containers and feasibility labels.

Array-backed equivalents of the reference's trajectory data model
(reference: commonroad_rp/trajectories.py).  The per-candidate object zoo
(TrajectorySample / CartesianSample / CurviLinearSample) exists in the dense
[K, T] rollout arrays on device; these host containers carry the SELECTED
candidate and the host view of an evaluated bundle (trajectory-set
capture, ``draw_traj_set``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, List, Optional

import numpy as np


class FeasibilityStatus(Enum):
    """Feasibility label of a candidate after checking (trajectories.py:18-22)."""

    FEASIBLE = "feasible"
    INFEASIBLE_KINEMATIC = "infeasible_kinematic"
    INFEASIBLE_COLLISION = "infeasible_collision"


@dataclass
class Trajectory:
    """Minimal commonroad-io Trajectory equivalent: time-indexed state list."""

    initial_time_step: int
    state_list: List = field(default_factory=list)


@dataclass
class OptimalTrajectory:
    """The selected candidate of one planning cycle: dense [T] state arrays.

    Field names follow CartesianSample / CurviLinearSample
    (trajectories.py:61-213); ``cost`` is the evaluated total cost.
    """

    arrays: Dict[str, np.ndarray]
    cost: float
    dt: float
    horizon: float

    @property
    def cartesian(self) -> "CartesianView":
        return CartesianView(self.arrays)

    @property
    def curvilinear(self) -> "CurvilinearView":
        return CurvilinearView(self.arrays)


class CartesianView:
    """Cartesian per-step states of a selected candidate."""

    def __init__(self, arrays: Dict[str, np.ndarray]):
        self._arrays = arrays

    x = property(lambda self: self._arrays["x"])
    y = property(lambda self: self._arrays["y"])
    theta = property(lambda self: self._arrays["theta_gl"])
    v = property(lambda self: self._arrays["v"])
    a = property(lambda self: self._arrays["a"])
    kappa = property(lambda self: self._arrays["kappa_gl"])
    kappa_dot = property(lambda self: self._arrays["kappa_dot"])


class CurvilinearView:
    """Curvilinear per-step states of a selected candidate."""

    def __init__(self, arrays: Dict[str, np.ndarray]):
        self._arrays = arrays

    s = property(lambda self: self._arrays["s"])
    d = property(lambda self: self._arrays["d"])
    theta = property(lambda self: self._arrays["theta_cl"])
    s_dot = property(lambda self: self._arrays["s_dot"])
    s_ddot = property(lambda self: self._arrays["s_ddot"])
    d_dot = property(lambda self: self._arrays["d_dot"])
    d_ddot = property(lambda self: self._arrays["d_ddot"])


@dataclass
class BundleSummary:
    """Host view of a fully evaluated level (for draw_traj_set / debugging).

    Carries per-candidate arrays + labels, playing the role of the reference's
    stored_trajectories list (reactive_planner.py:1122-1123).
    """

    x: np.ndarray                 # [K, T]
    y: np.ndarray                 # [K, T]
    costs: np.ndarray             # [K]
    feasible: np.ndarray          # [K] bool
    collides: np.ndarray          # [K] bool
    labels: Optional[List[FeasibilityStatus]] = None

    def __post_init__(self):
        if self.labels is None:
            self.labels = [
                FeasibilityStatus.INFEASIBLE_KINEMATIC if not f
                else (FeasibilityStatus.INFEASIBLE_COLLISION if c
                      else FeasibilityStatus.FEASIBLE)
                for f, c in zip(self.feasible, self.collides)]
