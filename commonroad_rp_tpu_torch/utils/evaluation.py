"""Solution evaluation: input reconstruction + forward simulation + validity.

Counterpart of ``commonroad_rp_tpu/utils/evaluation.py`` (reference:
commonroad_rp/utility/evaluation.py:30-165, built on the commonroad-dc
feasibility checker).  This is the physics-level oracle: for each state
transition of the planned trajectory, reconstruct the control inputs of a
kinematic single-track (KS) model by optimization, forward-simulate them, and
compare against the planned states.  The collision report runs the port's
separating-axis tests (``ops.collision``) on CPU tensors in float64.  The
state and input plots draw with matplotlib on the Agg backend.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from commonroad_rp_tpu_torch.models.state import (InputState,
                                                  ReactivePlannerState,
                                                  TraceState)
from commonroad_rp_tpu_torch.models.trajectories import Trajectory
from commonroad_rp_tpu_torch.utils.vehicle_params import (VehicleParameters,
                                                          vehicle_parameters)


# ---------------------------------------------------------------------------
# KS vehicle dynamics (commonroad-dc VehicleDynamics.KS equivalent)
# ---------------------------------------------------------------------------

@dataclass
class VehicleDynamicsKS:
    """Kinematic single-track model: state [x, y, delta, v, psi],
    input [v_delta, a_long].

    ``reference_point='center'`` expresses the same rear-axle kinematics at
    the vehicle-center position (the CommonRoad solution convention used by
    create_full_solution_trajectory, evaluation.py:76-84): the center of a
    rigid body at offset b ahead of the rear axle moves with the additional
    lateral term b * psi_dot.
    """

    params: VehicleParameters
    reference_point: str = "center"

    @classmethod
    def from_vehicle_type(cls, id_type_vehicle: int,
                          reference_point: str = "center"
                          ) -> "VehicleDynamicsKS":
        return cls(vehicle_parameters(id_type_vehicle), reference_point)

    def _derivative(self, x: np.ndarray, u: np.ndarray) -> np.ndarray:
        p = self.params
        # input saturation (steering rate / acceleration limits incl. the
        # velocity-switched acceleration bound of the vehicle models docs)
        v_delta = np.clip(u[0], p.v_delta_min, p.v_delta_max)
        a_max = p.a_max * p.v_switch / x[3] if x[3] > p.v_switch else p.a_max
        a = np.clip(u[1], -p.a_max, a_max)
        # steering-angle hard stops
        if (x[2] <= p.delta_min and v_delta < 0) or \
                (x[2] >= p.delta_max and v_delta > 0):
            v_delta = 0.0
        psi_dot = x[3] / p.wheelbase * np.tan(x[2])
        x_dot = x[3] * np.cos(x[4])
        y_dot = x[3] * np.sin(x[4])
        if self.reference_point == "center":
            x_dot -= p.b * psi_dot * np.sin(x[4])
            y_dot += p.b * psi_dot * np.cos(x[4])
        return np.array([x_dot, y_dot, v_delta, a, psi_dot])

    def forward_simulation(self, x0: np.ndarray, u: np.ndarray, dt: float,
                           throw: bool = True,
                           substeps: int = 4) -> np.ndarray:
        """RK4 forward simulation over one planner step."""
        x = np.asarray(x0, dtype=float).copy()
        h = dt / substeps
        for _ in range(substeps):
            k1 = self._derivative(x, u)
            k2 = self._derivative(x + 0.5 * h * k1, u)
            k3 = self._derivative(x + 0.5 * h * k2, u)
            k4 = self._derivative(x + h * k3, u)
            x = x + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
        return x

    def state_to_array(self, state: TraceState) -> Tuple[np.ndarray, int]:
        return (np.array([state.position[0], state.position[1],
                          state.steering_angle or 0.0, state.velocity,
                          state.orientation]), state.time_step)

    def array_to_state(self, x: np.ndarray, time_step: int) -> TraceState:
        return TraceState(time_step=time_step,
                          position=np.array([x[0], x[1]]),
                          steering_angle=float(x[2]), velocity=float(x[3]),
                          orientation=float(x[4]))

    def input_to_array(self, inp: InputState) -> Tuple[np.ndarray, int]:
        return (np.array([inp.steering_angle_speed, inp.acceleration]),
                inp.time_step)


def _angle_diff(a: float, b: float) -> float:
    return float(np.arctan2(np.sin(a - b), np.cos(a - b)))


# ---------------------------------------------------------------------------
# input reconstruction (state_transition_feasibility equivalent)
# ---------------------------------------------------------------------------

def position_orientation_objective(u: np.ndarray, x0: np.ndarray,
                                   x1: np.ndarray, dt: float,
                                   dynamics: VehicleDynamicsKS) -> float:
    """Squared position + orientation error of the forward-simulated
    state."""
    sim = dynamics.forward_simulation(x0, u, dt, throw=False)
    return float((sim[0] - x1[0]) ** 2 + (sim[1] - x1[1]) ** 2 +
                 _angle_diff(sim[4], x1[4]) ** 2)


def state_transition_feasibility(
        x0_state: TraceState, x1_state: TraceState,
        dynamics: VehicleDynamicsKS, dt: float,
        e: np.ndarray = np.array([2e-2, 2e-2, 3e-2])
        ) -> Tuple[bool, InputState]:
    """Reconstruct the input for one transition by optimization and check
    the simulation error against tolerances (commonroad-dc
    feasibility_checker.state_transition_feasibility semantics, used at
    evaluation.py:127-132)."""
    from scipy.optimize import minimize

    x0, t0 = dynamics.state_to_array(x0_state)
    x1, _ = dynamics.state_to_array(x1_state)
    p = dynamics.params

    # initial guess from finite differences
    u0 = np.array([(x1[2] - x0[2]) / dt, (x1[3] - x0[3]) / dt])
    bounds = [(p.v_delta_min, p.v_delta_max), (-p.a_max, p.a_max)]
    res = minimize(position_orientation_objective, u0,
                   args=(x0, x1, dt, dynamics), bounds=bounds,
                   method="L-BFGS-B", options={"ftol": 1e-10})
    u = res.x
    sim = dynamics.forward_simulation(x0, u, dt, throw=False)
    err = np.array([abs(sim[0] - x1[0]), abs(sim[1] - x1[1]),
                    abs(_angle_diff(sim[4], x1[4]))])
    feasible = bool(np.all(err <= e))
    return feasible, InputState(time_step=t0 + 1, acceleration=float(u[1]),
                                steering_angle_speed=float(u[0]))


# ---------------------------------------------------------------------------
# solution objects (commonroad-io Solution equivalents)
# ---------------------------------------------------------------------------

@dataclass
class PlanningProblemSolution:
    planning_problem_id: int
    vehicle_type: int
    vehicle_model: str
    cost_function: str
    trajectory: Trajectory


@dataclass
class Solution:
    scenario_id: str
    planning_problem_solutions: List[PlanningProblemSolution] = field(
        default_factory=list)


def create_full_solution_trajectory(config,
                                    state_list: List[ReactivePlannerState]
                                    ) -> Trajectory:
    """Shift recorded rear-axle states to the vehicle center
    (evaluation.py:76-84)."""
    shifted = [s.shift_positions_to_center(config.vehicle.wb_rear_axle)
               for s in state_list]
    return Trajectory(initial_time_step=shifted[0].time_step,
                      state_list=shifted)


def create_planning_problem_solution(config, solution_trajectory: Trajectory,
                                     scenario, planning_problem) -> Solution:
    """(evaluation.py:87-100)"""
    pps = PlanningProblemSolution(
        planning_problem_id=planning_problem.planning_problem_id,
        vehicle_type=config.vehicle.id_type_vehicle, vehicle_model="KS",
        cost_function="JB1", trajectory=solution_trajectory)
    return Solution(scenario.scenario_id, [pps])


def reconstruct_inputs(config, pps: PlanningProblemSolution):
    """Per-transition input reconstruction (evaluation.py:117-135)."""
    dynamics = VehicleDynamicsKS.from_vehicle_type(
        config.vehicle.id_type_vehicle)
    feasible_list, inputs = [], []
    states = pps.trajectory.state_list
    for x0, x1 in zip(states[:-1], states[1:]):
        feasible, inp = state_transition_feasibility(x0, x1, dynamics,
                                                     config.planning.dt)
        feasible_list.append(feasible)
        inputs.append(inp)
    return feasible_list, inputs


def reconstruct_states(config, states: List[TraceState],
                       inputs: List[InputState]) -> List[TraceState]:
    """Forward simulation of reconstructed inputs (evaluation.py:103-114)."""
    dynamics = VehicleDynamicsKS.from_vehicle_type(
        config.vehicle.id_type_vehicle)
    out = [states[0]]
    for idx, inp in enumerate(inputs):
        x0, t0 = dynamics.state_to_array(states[idx])
        u = dynamics.input_to_array(inp)[0]
        x1 = dynamics.forward_simulation(x0, u, config.planning.dt,
                                         throw=False)
        out.append(dynamics.array_to_state(x1, t0 + 1))
    return out


def check_acceleration(config, state_list: List[TraceState]) -> bool:
    """dv/dt consistency of the planned accelerations
    (evaluation.py:138-165)."""
    a_planned = np.array([s.acceleration for s in state_list])
    a_pc = 0.5 * (a_planned[:-1] + a_planned[1:])
    v = np.array([s.velocity for s in state_list])
    a_recalc = np.diff(v) / config.planning.dt
    diff = np.abs(a_pc - a_recalc)
    correct = bool(np.all(diff < 1e-1))
    print(f"Acceleration correct: {correct}, with max deviation "
          f"{diff.max()}")
    return correct


def solution_collision_report(scenario, states: List[TraceState],
                              length: float, width: float) -> dict:
    """Per-step ego-obstacle and road-boundary hits of a recorded solution.

    Batched equivalent of the CollisionException / boundary checks in
    commonroad-dc's solution checker (reference consumer: valid_solution at
    utility/evaluation.py:71).  Solution states are vehicle-CENTER positions
    (create_full_solution_trajectory), so the ego OBB is placed directly on
    them (no rear-axle shift).  Exact shape semantics match
    ``ops.collision.check_collisions``: OBB SAT / closest-point disc /
    convex-piece polygon SAT per scenario time step, float64 on the CPU.
    """
    from commonroad_rp_tpu_torch.ops import collision as co

    f64 = torch.float64
    T = len(states)
    t0 = states[0].time_step
    obstacles = co.compile_obstacles(scenario, t0, T - 1, 1)
    boundary = co.compile_road_boundary(scenario)

    center = torch.as_tensor(np.stack([s.position for s in states]),
                             dtype=f64)                            # [T, 2]
    theta = torch.as_tensor([s.orientation for s in states], dtype=f64)
    half = torch.tensor([0.5 * length, 0.5 * width], dtype=f64)

    hit_obstacle = np.zeros(T, dtype=bool)
    if obstacles.pose.shape[0] > 0:
        obs_pose = obstacles.pose.transpose(0, 1)                  # [T, M, 3]
        box_hit = co.obb_overlap(
            center[:, None, :], theta[:, None], half[None, None, :],
            obs_pose[..., :2], obs_pose[..., 2],
            obstacles.half_ext[None, :, :])                        # [T, M]
        if obstacles.radius is not None:
            disc_hit = co.disc_obb_overlap(
                obs_pose[..., :2], obstacles.radius[None, :],
                center[:, None, :], theta[:, None], half[None, None, :])
            box_hit = torch.where(obstacles.radius[None, :] > 0, disc_hit,
                                  box_hit)
        box_hit = box_hit & obstacles.valid.T
        hit_obstacle |= torch.any(box_hit, dim=1).numpy()
    if obstacles.poly_verts is not None:
        poly_hit = co._poly_obb_overlap_tmajor(
            obstacles.poly_verts.transpose(0, 1),                  # [T, Mp, V, 2]
            obstacles.poly_valid.T, center[:, 0:1], center[:, 1:2],
            torch.cos(theta)[:, None], torch.sin(theta)[:, None],
            float(half[0]), float(half[1]))                        # [T, Mp, 1]
        hit_obstacle |= torch.any(poly_hit[..., 0], dim=1).numpy()

    hit_boundary = np.zeros(T, dtype=bool)
    if boundary.segments.shape[0] > 0:
        seg_hit = co.obb_segment_overlap(
            center[:, None, :], theta[:, None], half[None, None, :],
            boundary.segments[None, :, 0, :],
            boundary.segments[None, :, 1, :])
        seg_hit = seg_hit & boundary.valid[None, :]
        hit_boundary = torch.any(seg_hit, dim=1).numpy()

    return dict(
        collision_free=not bool(hit_obstacle.any()),
        collision_steps=[t0 + int(i) for i in np.flatnonzero(hit_obstacle)],
        boundary_ok=not bool(hit_boundary.any()),
        boundary_steps=[t0 + int(i) for i in np.flatnonzero(hit_boundary)])


def valid_solution(scenario, planning_problem_set, solution: Solution
                   ) -> Tuple[bool, dict]:
    """CommonRoad solution validity (commonroad-dc solution_checker role,
    evaluation.py:71): initial-state consistency, goal satisfaction,
    per-transition kinematic feasibility, ego-obstacle collision, and
    road-boundary compliance -- with per-violation detail (colliding time
    steps) like commonroad-dc's CollisionException."""
    results = {}
    overall = True
    for pps in solution.planning_problem_solutions:
        pp = planning_problem_set.find_planning_problem_by_id(
            pps.planning_problem_id)
        states = pps.trajectory.state_list

        start_ok = bool(np.linalg.norm(
            states[0].position - pp.initial_state.position) < 2e-2 + 1e-8)

        goal_ok = any(pp.goal.is_reached(s) for s in states)

        dynamics = VehicleDynamicsKS.from_vehicle_type(pps.vehicle_type)
        feasible = all(
            state_transition_feasibility(x0, x1, dynamics, scenario.dt)[0]
            for x0, x1 in zip(states[:-1], states[1:]))

        params = dynamics.params
        collision = solution_collision_report(scenario, states,
                                              params.l, params.w)

        # validity gates on obstacle collision like commonroad-dc's
        # CollisionException (the raw scenario carries no boundary
        # obstacle); the boundary report stays informational detail
        ok = (start_ok and goal_ok and feasible and
              collision["collision_free"])
        results[pps.planning_problem_id] = dict(
            start=start_ok, goal=goal_ok, feasible=feasible, **collision)
        overall = overall and ok
    return overall, results


# the bound on the open-loop drift of the reconstructed inputs' forward
# simulation, metres per recorded state (the certificate of the JAX
# package's tests/test_production_certification.py)
DRIFT_PER_STATE = 2e-2


def certify_drive(config, state_list: List[ReactivePlannerState]) -> dict:
    """The physics certificate of a drive's recorded states: their solution
    through ``valid_solution`` (start, goal, collision and road-boundary
    compliance) and the KS input reconstruction, whose forward simulation
    stays within ``DRIFT_PER_STATE`` per state of the recorded positions.
    Returns ``valid_solution``'s detail with ``valid`` (its verdict),
    ``transitions`` (the per-transition reconstruction verdicts),
    ``failing`` (the indices of those that fail), ``drift`` (m) and
    ``drift_bound`` (m), and ``certified``: start, goal, collision,
    boundary and drift hold (every transition's feasibility is left to
    the caller: divergence 7 makes some fail on the T-junction)."""
    trajectory = create_full_solution_trajectory(config, state_list)
    solution = create_planning_problem_solution(
        config, trajectory, config.scenario, config.planning_problem)
    valid, detail = valid_solution(config.scenario,
                                   config.planning_problem_set, solution)
    cert = dict(detail[config.planning_problem.planning_problem_id],
                valid=valid)
    pps = solution.planning_problem_solutions[0]
    transitions, inputs = reconstruct_inputs(config, pps)
    simulated = reconstruct_states(config, pps.trajectory.state_list, inputs)
    cert.update(
        transitions=transitions,
        failing=[i for i, ok in enumerate(transitions) if not ok],
        drift=max(float(np.linalg.norm(a.position - b.position))
                  for a, b in zip(pps.trajectory.state_list, simulated)),
        drift_bound=DRIFT_PER_STATE * len(simulated))
    cert["certified"] = bool(
        cert["start"] and cert["goal"] and cert["collision_free"]
        and cert["boundary_ok"] and cert["drift"] < cert["drift_bound"])
    return cert


def plot_states(config, state_list: List[TraceState],
                reconstructed_states: Optional[List[TraceState]] = None,
                plot_bounds: bool = False, save_path: Optional[str] = None):
    """State plots: trajectory, steering angle, velocity, orientation, yaw
    rate — planned vs reconstructed (evaluation.py:168-259)."""
    import matplotlib
    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    fig = plt.figure(figsize=(7, 8.0))
    plt.suptitle("States")
    steps = list(range(len(state_list)))

    plt.subplot(5, 1, 1)
    plt.plot([s.position[0] for s in state_list],
             [s.position[1] for s in state_list], color="black", label="planned")
    if reconstructed_states:
        plt.plot([s.position[0] for s in reconstructed_states],
                 [s.position[1] for s in reconstructed_states],
                 color="blue", label="reconstructed")
    plt.ylabel("y")

    for i, (attr, label) in enumerate([("steering_angle", "delta"),
                                       ("velocity", "v"),
                                       ("orientation", "theta")], start=2):
        plt.subplot(5, 1, i)
        plt.plot(steps, [getattr(s, attr) or 0.0 for s in state_list],
                 color="black")
        if reconstructed_states:
            plt.plot(list(range(len(reconstructed_states))),
                     [getattr(s, attr) or 0.0 for s in reconstructed_states],
                     color="blue")
        if plot_bounds and attr == "steering_angle":
            plt.axhline(config.vehicle.delta_min, color="red")
            plt.axhline(config.vehicle.delta_max, color="red")
        plt.ylabel(label)

    plt.subplot(5, 1, 5)
    plt.plot(steps, [s.yaw_rate or 0.0 for s in state_list], color="black")
    if reconstructed_states:
        rec_theta = np.array([s.orientation for s in reconstructed_states])
        rec_yaw = np.insert(np.diff(rec_theta) / config.planning.dt, 0,
                            state_list[0].yaw_rate or 0.0)
        plt.plot(list(range(len(rec_yaw))), rec_yaw, color="blue")
    plt.ylabel("theta_dot")
    plt.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return fig


def plot_inputs(config, input_list: List[InputState],
                reconstructed_inputs: Optional[List[InputState]] = None,
                plot_bounds: bool = False, save_path: Optional[str] = None):
    """Input plots: steering rate + acceleration, planned vs reconstructed
    (evaluation.py:262-301)."""
    import matplotlib
    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    fig = plt.figure()
    plt.suptitle("Inputs")
    steps = list(range(len(input_list)))

    plt.subplot(2, 1, 1)
    plt.plot(steps, [i.steering_angle_speed for i in input_list],
             color="black", label="planned")
    if reconstructed_inputs:
        plt.plot(list(range(len(reconstructed_inputs))),
                 [i.steering_angle_speed for i in reconstructed_inputs],
                 color="blue", label="reconstructed")
    if plot_bounds:
        plt.axhline(config.vehicle.v_delta_min, color="red")
        plt.axhline(config.vehicle.v_delta_max, color="red")
    plt.legend()
    plt.ylabel("v_delta in rad/s")

    plt.subplot(2, 1, 2)
    plt.plot(steps, [i.acceleration for i in input_list], color="black")
    if reconstructed_inputs:
        plt.plot(list(range(len(reconstructed_inputs))),
                 [i.acceleration for i in reconstructed_inputs], color="blue")
    if plot_bounds:
        plt.axhline(-config.vehicle.a_max, color="red")
        plt.axhline(config.vehicle.a_max, color="red")
    plt.ylabel("a_long in m/s^2")
    plt.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return fig


def run_evaluation(config, state_list: List[ReactivePlannerState],
                   input_list: List[InputState]):
    """Full evaluation pipeline (evaluation.py:30-41)."""
    ego_solution_trajectory = create_full_solution_trajectory(config,
                                                              state_list)
    solution = create_planning_problem_solution(
        config, ego_solution_trajectory, config.scenario,
        config.planning_problem)
    feasible, reconstructed_inputs = reconstruct_inputs(
        config, solution.planning_problem_solutions[0])
    reconstruct_states(config, ego_solution_trajectory.state_list,
                       reconstructed_inputs)
    check_acceleration(config, ego_solution_trajectory.state_list)
    if config.planning_problem_set is not None:
        ok, detail = valid_solution(config.scenario,
                                    config.planning_problem_set, solution)
        print(f"Feasibility Check Result: ({ok}, {detail})")
    return solution, feasible
