"""Trajectory output containers.

Array-backed equivalents of the reference's trajectory data model
(reference: commonroad_rp/trajectories.py).  The per-candidate object zoo
(TrajectorySample / CartesianSample / CurviLinearSample) exists in the dense
[K, T] rollout arrays on device; these host containers carry the SELECTED
candidate.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np


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
