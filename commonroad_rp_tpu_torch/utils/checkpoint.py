"""Checkpoint / resume of planner and fleet state.

Counterpart of ``commonroad_rp_tpu/utils/checkpoint.py``.  The reference has
no checkpointing: its inter-cycle state is (x_0 cart, x_0 curvilinear,
recorded state/input lists) threaded through reset() /
record_state_and_input().  Here exactly that state -- and, for the fleet
path, the replanning-scan carry -- is serialized to a single .npz archive so
a planning run can resume after interruption.  The archive layout is the JAX
package's, field for field, so a file written by either package loads in
the other.
"""

from __future__ import annotations

import json
from typing import Tuple

import numpy as np
import torch

from commonroad_rp_tpu_torch.models.state import (InputState,
                                                  ReactivePlannerState)

_STATE_FIELDS = ("time_step", "position", "orientation", "velocity",
                 "acceleration", "yaw_rate", "steering_angle")


def _states_to_arrays(states) -> dict:
    out = {}
    out["n"] = np.asarray(len(states))
    for field in _STATE_FIELDS:
        if field == "position":
            out["position"] = np.array(
                [s.position if s.position is not None else [np.nan, np.nan]
                 for s in states], dtype=float).reshape(len(states), 2)
        else:
            out[field] = np.array(
                [getattr(s, field) if getattr(s, field) is not None else np.nan
                 for s in states], dtype=float)
    return out


def _arrays_to_states(data: dict, prefix: str):
    n = int(data[f"{prefix}n"])
    states = []
    for i in range(n):
        kwargs = {}
        for field in _STATE_FIELDS:
            value = data[f"{prefix}{field}"][i]
            if field == "position":
                kwargs["position"] = None if np.any(np.isnan(value)) else value
            elif field == "time_step":
                kwargs["time_step"] = int(value)
            else:
                kwargs[field] = None if np.isnan(value) else float(value)
        states.append(ReactivePlannerState(**kwargs))
    return states


def save_planner_state(planner, path: str):
    """Serialize the planner's inter-cycle state (reactive_planner.py:172-216
    reset inputs + the recorded state/input lists :391-408)."""
    payload = {}
    for key, value in _states_to_arrays(planner.record_state_list).items():
        payload[f"rs_{key}"] = value
    payload["inputs"] = np.array(
        [[i.time_step, i.acceleration, i.steering_angle_speed]
         for i in planner.record_input_list], dtype=float).reshape(-1, 3)
    for key, value in _states_to_arrays([planner.x_0]).items():
        payload[f"x0_{key}"] = value
    x0_lon, x0_lat = planner.x_0_cl
    payload["x0_lon"] = np.asarray(x0_lon, dtype=float)
    payload["x0_lat"] = np.asarray(x0_lat, dtype=float)
    payload["meta"] = np.frombuffer(json.dumps({
        "scenario": planner.config.general.name_scenario,
        "planning_times": planner.planning_times,
    }).encode(), dtype=np.uint8)
    np.savez(path, **payload)


def load_planner_state(planner, path: str):
    """Restore a planner (reset + recorded lists) from a checkpoint."""
    data = np.load(path)
    planner._record_state_list = _arrays_to_states(data, "rs_")
    planner._record_input_list = [
        InputState(time_step=int(row[0]), acceleration=float(row[1]),
                   steering_angle_speed=float(row[2]))
        for row in data["inputs"]]
    x_0 = _arrays_to_states(data, "x0_")[0]
    x0_cl = (list(data["x0_lon"]), list(data["x0_lat"]))
    planner.reset(initial_state_cart=x_0, initial_state_curv=x0_cl,
                  collision_checker=planner.collision_checker,
                  coordinate_system=planner.coordinate_system)
    meta = json.loads(bytes(data["meta"]).decode())
    planner._planning_times_list = list(meta.get("planning_times", []))
    return meta


def save_fleet_carry(carry, cycle_index: int, path: str):
    """Serialize a fleet-scan carry (parallel.fleet.FleetCarry) from any
    device."""
    np.savez(path, cycle_index=np.asarray(cycle_index),
             **{f: getattr(carry, f).detach().cpu().numpy()
                for f in carry._fields})


def load_fleet_carry(path: str, device=None) -> Tuple[object, int]:
    """Restore a fleet-scan carry on ``device`` (``cuda`` unless named; it
    raises without a card, as the planner does); returns (FleetCarry,
    cycle_index)."""
    from commonroad_rp_tpu_torch.models.planner import resolve_device
    from commonroad_rp_tpu_torch.parallel.fleet import FleetCarry

    device = resolve_device(device)
    data = np.load(path)
    n = data["velocity"].shape[0]
    zeros = np.zeros(n, np.float32)
    # checkpoints written before the standstill-fallback fields existed
    # lack them
    carry = FleetCarry(**{f: torch.as_tensor(data[f] if f in data else zeros,
                                             device=device)
                          for f in FleetCarry._fields})
    return carry, int(data["cycle_index"])
