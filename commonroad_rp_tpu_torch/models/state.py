"""State types for planner input/output.

Equivalents of commonroad-io's state dataclasses as used by the reference:
``ReactivePlannerState`` mirrors commonroad_rp/state.py:7-67 (KSState +
acceleration/yaw_rate, rear-axle position convention), ``InputState`` mirrors
the control-input records of reactive_planner.py:405-408.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Optional

import numpy as np


@dataclass
class TraceState:
    """Generic trajectory state (commonroad-io CustomState equivalent)."""

    time_step: Optional[int] = None
    position: Optional[np.ndarray] = None   # [x, y]
    orientation: Optional[float] = None
    velocity: Optional[float] = None
    acceleration: Optional[float] = None
    yaw_rate: Optional[float] = None
    slip_angle: Optional[float] = None
    steering_angle: Optional[float] = None

    def translate_rotate(self, translation: np.ndarray, angle: float) -> "TraceState":
        """Return a copy with the position translated then rotated by ``angle``."""
        new = self.copy()
        pos = np.asarray(self.position, dtype=float) + np.asarray(translation, dtype=float)
        if angle != 0.0:
            c, s = np.cos(angle), np.sin(angle)
            pos = np.array([c * pos[0] - s * pos[1], s * pos[0] + c * pos[1]])
            if new.orientation is not None:
                new.orientation = new.orientation + angle
        new.position = pos
        return new

    def copy(self):
        kwargs = {f.name: getattr(self, f.name) for f in fields(self)}
        if kwargs.get("position") is not None:
            kwargs["position"] = np.array(kwargs["position"], dtype=float)
        return type(self)(**kwargs)


@dataclass
class InitialState(TraceState):
    """Scenario/planning-problem initial state (commonroad-io InitialState role)."""


@dataclass
class InputState:
    """Control input record (acceleration + steering-angle rate).

    Mirrors the InputState constructed at reactive_planner.py:405-408.
    """

    time_step: int = 0
    acceleration: float = 0.0
    steering_angle_speed: float = 0.0


@dataclass
class ReactivePlannerState(TraceState):
    """Planner output state: position w.r.t. REAR AXLE, plus acceleration and
    yaw rate (reference: commonroad_rp/state.py:7-21)."""

    def __repr__(self):
        return (f"(time_step={self.time_step}, position={self.position},"
                f"steering_angle={self.steering_angle}, velocity={self.velocity}, "
                f"orientation={self.orientation}, acceleration={self.acceleration}, "
                f"yaw_rate = {self.yaw_rate})")

    def shift_positions_to_center(self, wb_rear_axle: float) -> "ReactivePlannerState":
        """Shift position from rear axle to vehicle center (state.py:22-31)."""
        theta = self.orientation
        return self.translate_rotate(
            np.array([wb_rear_axle * np.cos(theta), wb_rear_axle * np.sin(theta)]), 0.0)

    @classmethod
    def create_from_initial_state(cls, initial_state: TraceState, wheelbase: float,
                                  wb_rear_axle: float) -> "ReactivePlannerState":
        """Build the planner initial state from a scenario initial state.

        Mirrors state.py:33-67: add zero acceleration if missing, drop slip
        angle, shift position center -> rear axle, derive steering angle from
        yaw rate via the kinematic single-track relation
        delta = atan2(L * psi_dot, v).
        """
        theta = initial_state.orientation
        shifted = initial_state.translate_rotate(
            np.array([-wb_rear_axle * np.cos(theta), -wb_rear_axle * np.sin(theta)]), 0.0)
        state = cls(
            time_step=shifted.time_step,
            position=shifted.position,
            orientation=shifted.orientation,
            velocity=shifted.velocity,
            acceleration=shifted.acceleration if shifted.acceleration is not None else 0.0,
            yaw_rate=shifted.yaw_rate if shifted.yaw_rate is not None else 0.0,
        )
        state.steering_angle = float(
            np.arctan2(wheelbase * state.yaw_rate, state.velocity))
        return state
