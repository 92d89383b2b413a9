"""ReactivePlanner facade: the reference planner API over the device cycle.

Counterpart of ``commonroad_rp_tpu/models/planner.py`` (reference:
commonroad_rp/reactive_planner.py:52-1159).  ``plan()``: the host compiles
the scene, generates the sampling levels' candidate grids, and assembles
the output.  Two scoring paths, chosen by ``debug.fast_scoring`` and
``debug.kernel_dtype`` as the JAX planner chooses them:

* the fused float32 path (the default: ``"auto"``/None resolve to it): one
  ``ops.cycle.evaluate_levels_fast`` per cycle scores the union of the
  levels in one kernel launch, selects the winner with the reference's
  escalation semantics, and re-rolls it;
* the conformance level program (``fast_scoring: False`` or
  ``kernel_dtype: float64``): the sequential escalation loop, one
  ``ops.cycle.evaluate_level`` per level, in the planner's dtype.

Both run as compiled level programs (``ops.level_program.LevelProgram``, the
counterpart of the JAX package's jits): one built program per signature,
kept in an LRU on the planner, one staging copy in, one replay of the
captured body on the card (``graph=False``: the body eagerly) and one
packed readback per call.

``plan_scan(n)``: n replanning cycles of the fused path on the device
(``parallel.replanning_scan.make_facade_replanning_scan``) with one readback
at the end; on the card each call replays one captured cycle n times.
With ``debug.draw_traj_set`` and plots on, every cycle also stores its
evaluated bundle in ``stored_trajectories`` for the plots
(``utils.visualization``).
"""

from __future__ import annotations

import logging
import time
import weakref
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from commonroad_rp_tpu_torch.models.cost_functions import (
    CostFunction, DefaultCostFunction)
from commonroad_rp_tpu_torch.models.sampling import (CandidateBatch,
                                                     CorridorSampling,
                                                     PositionSampling,
                                                     SamplingSpace,
                                                     TimeSampling,
                                                     VelocitySampling,
                                                     sampling_space_factory)
from commonroad_rp_tpu_torch.models.state import (InputState,
                                                  ReactivePlannerState,
                                                  TraceState)
from commonroad_rp_tpu_torch.models.trajectories import (BundleSummary,
                                                         OptimalTrajectory,
                                                         Trajectory)
from commonroad_rp_tpu_torch.ops import collision as collision_ops
from commonroad_rp_tpu_torch.ops import cycle as cycle_ops
from commonroad_rp_tpu_torch.ops import grid as grid_ops
from commonroad_rp_tpu_torch.ops import kinematics as kin_ops
from commonroad_rp_tpu_torch.ops import level_program
from commonroad_rp_tpu_torch.parallel import replanning_scan
from commonroad_rp_tpu_torch.utils.config import ReactivePlannerConfiguration
from commonroad_rp_tpu_torch.utils.coordinate_system import CoordinateSystem
from commonroad_rp_tpu_torch.utils.general import (
    retrieve_desired_velocity_from_pp, shift_orientation_states)
from commonroad_rp_tpu_torch.utils.geometry import interpolate_angle
from commonroad_rp_tpu_torch.utils import profiling
from commonroad_rp_tpu_torch.utils.scenario import (DynamicObstacle,
                                                    Rectangle, Scenario)

logger = logging.getLogger("RP_LOGGER")

_CONSTRAINT_ORDER = ("velocity", "acceleration", "kappa", "kappa_dot",
                     "yaw_rate")
# built level programs kept per planner: a drive's signatures (each level x
# low_vel_mode of plan(level), the fused union, the capture bundle's level)
LEVEL_PROGRAMS = 8


def resolve_device(device=None) -> torch.device:
    """The planner's device: ``cuda`` when none is named.  A CUDA device
    without a card raises (nothing carries on on the CPU unasked); the CPU
    runs only when named (``device="cpu"``)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but "
                           "torch.cuda.is_available() is false; pass "
                           "device='cpu' to run on the CPU")
    return device


def check_fast_scope(config: ReactivePlannerConfiguration):
    """Resolve the 'auto'/None defaults to the fused float32 path and check
    the dtype and boundary mode."""
    debug = config.debug
    if debug.kernel_dtype == "auto":
        debug.kernel_dtype = "float32"
    if debug.fast_scoring is None:
        debug.fast_scoring = True
    if debug.kernel_dtype not in ("float32", "float64"):
        raise ValueError(f"unknown kernel_dtype {debug.kernel_dtype!r}")
    if config.planning.boundary_mode not in ("corridor", "segments"):
        raise ValueError(f"unknown boundary_mode "
                         f"{config.planning.boundary_mode!r}")


class CollisionChecker:
    """Compiled scene: road boundary, per-reference-path corridors, and
    per-window obstacle tables, all on the planner's device
    (reactive_planner.py:218-256; reused across cycles via reset())."""

    def __init__(self, scenario: Scenario, device: torch.device,
                 dtype=torch.float32):
        self.scenario = scenario
        self.device = device
        self.dtype = dtype
        self.boundary = collision_ops.compile_road_boundary(
            scenario, dtype=dtype, device=device)
        self._window_cache: Dict[Tuple[int, int, int],
                                 collision_ops.ObstacleArrays] = {}
        self._corridor_cache = weakref.WeakKeyDictionary()

    def corridor_for(self, coordinate_system) -> collision_ops.CorridorArrays:
        """Drivable d-band tables for a reference path (cached per CoSys)."""
        if coordinate_system not in self._corridor_cache:
            self._corridor_cache[coordinate_system] = \
                collision_ops.compile_corridor(
                    self.boundary, coordinate_system.tables,
                    dtype=self.dtype, device=self.device)
        return self._corridor_cache[coordinate_system]

    def obstacles_for_window(self, t_start: int, horizon_steps: int,
                             factor: int) -> collision_ops.ObstacleArrays:
        key = (t_start, horizon_steps, factor)
        if key not in self._window_cache:
            self._window_cache[key] = collision_ops.compile_obstacles(
                self.scenario, t_start, horizon_steps, factor,
                dtype=self.dtype, device=self.device)
        return self._window_cache[key]


class ReactivePlanner:
    """Sampling-based reactive trajectory planner on the device cycle.

    ``device`` is ``cuda`` unless one is named, and raises without a card
    (``resolve_device``); the CPU runs only when asked (``device="cpu"``),
    and there the kernels run their plain PyTorch versions.

    ``plan()`` and ``plan_scan()`` run compiled programs: on the card each
    ``plan()`` replays one captured CUDA graph per level program call
    (``ops.level_program``; the LRU ``level_programs`` holds up to
    ``LEVEL_PROGRAMS`` signatures) and ``plan_scan`` one per cycle
    (``ops.program.ScanProgram``).  ``graph=False`` runs the
    same programs eagerly: the twin the captured forms are held against.
    ``refine_continuations`` counts the fused calls whose exact refinement
    needed more than ``ops.cycle.REFINE_WIDTH`` re-selections and went on
    eagerly.
    """

    def __init__(self, config: ReactivePlannerConfiguration, device=None,
                 graph: bool = True):
        self.device = resolve_device(device)
        self.graph = bool(graph)
        self.level_programs = OrderedDict()     # signature -> LevelProgram
        self.refine_continuations = 0
        self._unbounded = None
        check_fast_scope(config)
        self._dtype = torch.float64 if config.debug.kernel_dtype == "float64" \
            else torch.float32

        self.dt: float = config.planning.dt
        self.N: int = config.planning.time_steps_computation
        self.horizon: float = config.planning.dt * \
            config.planning.time_steps_computation
        self.vehicle_params = config.vehicle

        self.x_0: Optional[ReactivePlannerState] = None
        self.x_0_cl: Optional[Tuple[List, List]] = None
        self._co: Optional[CoordinateSystem] = None
        self._cc: Optional[CollisionChecker] = None

        # statistics (reactive_planner.py:79-88)
        self._infeasible_count_collision: int = 0
        self._infeasible_count_kinematics: int = 0
        self._infeasible_reason_dict: Dict[str, int] = {}
        self._optimal_cost: float = 0.0
        self._planning_times_list: List[float] = []
        self.stage_timers = profiling.StageTimers()
        self._record_state_list: List[ReactivePlannerState] = []
        self._record_input_list: List[InputState] = []
        self.stored_trajectories: Optional[BundleSummary] = None

        self._desired_speed: Optional[float] = None
        self._desired_lon_position: Optional[float] = None
        self._low_vel_mode = False

        self._draw_traj_set = config.debug.draw_traj_set and \
            (config.debug.show_plots or config.debug.save_plots)

        self.config: Optional[ReactivePlannerConfiguration] = None
        self.reset(config)

        self.sampling_space: Optional[SamplingSpace] = None
        self.set_sampling_space()
        self.sampling_level = config.sampling.num_sampling_levels

        self.cost_function: Optional[CostFunction] = None
        self.set_cost_function()

        self._standstill_lookahead = config.planning.standstill_lookahead

    # ------------------------------------------------------------------
    # properties (reactive_planner.py:115-160)
    # ------------------------------------------------------------------

    @property
    def collision_checker(self) -> CollisionChecker:
        return self._cc

    @property
    def coordinate_system(self) -> CoordinateSystem:
        return self._co

    @property
    def reference_path(self) -> np.ndarray:
        return self._co.reference

    @property
    def infeasible_count_collision(self) -> int:
        return self._infeasible_count_collision

    @property
    def infeasible_count_kinematics(self) -> int:
        return self._infeasible_count_kinematics

    @property
    def infeasible_reason_dict(self) -> dict:
        return self._infeasible_reason_dict

    @property
    def optimal_cost(self) -> float:
        return self._optimal_cost

    @property
    def planning_times(self) -> List[float]:
        return self._planning_times_list

    @property
    def record_state_list(self) -> List[ReactivePlannerState]:
        return self._record_state_list

    @property
    def record_input_list(self) -> List[InputState]:
        return self._record_input_list

    # ------------------------------------------------------------------
    # setup / reset
    # ------------------------------------------------------------------

    def goal_reached(self) -> bool:
        """Initial state within the goal region (reactive_planner.py:162-170)."""
        x_0_shifted = self.x_0.shift_positions_to_center(
            self.vehicle_params.wb_rear_axle)
        if self.config.planning_problem.goal.is_reached(x_0_shifted):
            logger.info("Goal of planning problem reached")
            return True
        return False

    def goal_center_s(self) -> Optional[float]:
        """Arclength of the goal region's center on the current reference
        path, or None when the goal has no position constraint (the stop
        target of stop-at-goal missions, ``run_planner.drive_mission``)."""
        assert self._co is not None, "set_reference_path first"
        goal = self.config.planning_problem.goal
        centers = []
        for gs in goal.state_list:
            for shape in gs.position_shapes:
                center = getattr(shape, "center", None)
                if center is None and hasattr(shape, "vertices"):
                    center = np.mean(np.asarray(shape.vertices), axis=0)
                if center is not None:
                    centers.append(np.asarray(center, dtype=float))
            for lanelet_id in gs.position_lanelets:
                lanelet = self.config.scenario.lanelet_network \
                    .find_lanelet_by_id(lanelet_id)
                if lanelet is not None:
                    cv = lanelet.center_vertices
                    centers.append(np.asarray(cv[len(cv) // 2], dtype=float))
        if not centers:
            return None
        center = np.mean(np.stack(centers), axis=0)
        s, _ = self._co.convert_to_curvilinear_coords(center[0], center[1])
        return float(s)

    def reset(self, config: ReactivePlannerConfiguration = None,
              initial_state_cart: ReactivePlannerState = None,
              initial_state_curv: Tuple[List, List] = None,
              collision_checker: CollisionChecker = None,
              coordinate_system: CoordinateSystem = None):
        """Re-initialize for replanning (reactive_planner.py:172-216)."""
        if config is not None:
            self.config = config
        else:
            assert self.config is not None, \
                "<ReactivePlanner.reset(). No Configuration object provided>"

        self._reset_statistics()

        if collision_checker is None:
            self.set_collision_checker(scenario=self.config.scenario)
        else:
            self.set_collision_checker(collision_checker=collision_checker)

        if coordinate_system is not None:
            self.set_reference_path(coordinate_system=coordinate_system)

        if self.x_0 is None and initial_state_cart is None:
            if self.config.planning_problem:
                self.x_0 = ReactivePlannerState.create_from_initial_state(
                    self.config.planning_problem.initial_state,
                    self.vehicle_params.wheelbase,
                    self.vehicle_params.wb_rear_axle)
            else:
                self.x_0 = None
        else:
            self.x_0 = initial_state_cart if initial_state_cart is not None \
                else self.x_0

        self.x_0_cl = initial_state_curv if initial_state_curv is not None \
            else self._compute_initial_states(self.x_0)

    def set_collision_checker(self, scenario: Scenario = None,
                              collision_checker: CollisionChecker = None):
        """Compile or adopt the scene (reactive_planner.py:218-256)."""
        if collision_checker is None:
            assert scenario is not None, \
                "<ReactivePlanner.set_collision_checker>: provide a scenario OR a checker"
            self._cc = CollisionChecker(scenario, self.device, self._dtype)
        else:
            assert scenario is None, \
                "<ReactivePlanner.set_collision_checker>: provide a scenario OR a checker"
            self._cc = collision_checker

    def set_reference_path(self, reference_path: np.ndarray = None,
                           coordinate_system: CoordinateSystem = None):
        """Build or adopt the curvilinear frame (reactive_planner.py:258-272)."""
        if coordinate_system is None:
            assert reference_path is not None, \
                "<set reference path>: provide a reference path OR a CoordinateSystem"
            self._co = CoordinateSystem(reference_path, dtype=self._dtype,
                                        device=self.device)
        else:
            assert reference_path is None, \
                "<set reference path>: provide a reference path OR a CoordinateSystem"
            self._co = coordinate_system

    # sampling-parameter setters (reactive_planner.py:274-307)

    def set_t_sampling_parameters(self, t_min):
        self.sampling_space.samples_t = TimeSampling(
            t_min, self.horizon, self.sampling_level, self.dt)

    def set_d_sampling_parameters(self, delta_d_min, delta_d_max):
        self.sampling_space.samples_d = PositionSampling(
            delta_d_min, delta_d_max, self.sampling_level)

    def set_v_sampling_parameters(self, v_min, v_max):
        self.sampling_space.samples_v = VelocitySampling(
            v_min, v_max, self.sampling_level)

    def set_s_sampling_parameters(self, s_min, s_max):
        self.sampling_space.samples_s = PositionSampling(
            s_min, s_max, self.sampling_level)

    def set_desired_velocity(self, desired_velocity: float = None,
                             current_speed: float = None,
                             stopping: bool = False):
        """Velocity target + sampled interval (reactive_planner.py:309-347)."""
        self._desired_lon_position = None
        if desired_velocity is None and self._desired_speed is None:
            self._desired_speed = retrieve_desired_velocity_from_pp(
                self.config.planning_problem)
        else:
            self._desired_speed = desired_velocity \
                if desired_velocity is not None else self._desired_speed
        assert self._desired_speed >= 0.0, \
            f"<ReactivePlanner.set_desired_velocity(): desired speed has to " \
            f"be positive. Provided speed{self._desired_speed}>"

        if not stopping:
            reference_speed = current_speed if current_speed is not None \
                else self._desired_speed
            min_v = max(0, reference_speed - (0.125 * self.horizon *
                                              self.vehicle_params.a_max))
            max_v = max(min_v + 5.0, reference_speed + 2)
            self.set_v_sampling_parameters(min_v, max_v)
        else:
            self.set_v_sampling_parameters(self._desired_speed,
                                           self._desired_speed)

        if hasattr(self.cost_function, "desired_speed"):
            self.cost_function.desired_speed = self._desired_speed
        if hasattr(self.cost_function, "w_a"):
            self.cost_function.w_a = 5
        if hasattr(self.cost_function, "desired_s"):
            self.cost_function.desired_s = self._desired_lon_position

    def set_desired_lon_position(self, lon_position: float,
                                 delta_s_min: Optional[float] = None,
                                 delta_s_max: Optional[float] = None):
        """Stop-position target (reactive_planner.py:349-376)."""
        self._desired_lon_position = lon_position
        self._desired_speed = 0.0
        if delta_s_min is None and delta_s_max is None:
            delta_s_min = self.config.sampling.s_min
            delta_s_max = self.config.sampling.s_max
        self.set_s_sampling_parameters(lon_position + delta_s_min,
                                       lon_position + delta_s_max)
        if hasattr(self.cost_function, "desired_s"):
            self.cost_function.desired_s = self._desired_lon_position
        if hasattr(self.cost_function, "desired_speed"):
            self.cost_function.desired_speed = self._desired_speed
        if hasattr(self.cost_function, "w_a"):
            self.cost_function.w_a = 1

    def set_cost_function(self, cost_function: CostFunction = None):
        """Default or fail-safe cost.  Any other cost structure raises
        ValueError: the JAX package evaluates none on any path either (its
        ``evaluate_level`` raises the same error)."""
        if cost_function:
            structure = getattr(cost_function, "structure", None)
            if not structure or structure[0] not in ("default", "fail_safe"):
                raise ValueError(
                    f"unknown cost structure {structure!r} of "
                    f"{type(cost_function).__name__}: the planner evaluates "
                    "DefaultCostFunction and DefaultCostFunctionFailSafe "
                    "only")
            self.cost_function = cost_function
        else:
            self.cost_function = DefaultCostFunction(
                self._desired_speed, desired_d=0.0,
                desired_s=self._desired_lon_position)

    def set_sampling_space(self, sampling_space: SamplingSpace = None):
        if sampling_space:
            self.sampling_space = sampling_space
        else:
            self.sampling_space = sampling_space_factory(self.config)

    def record_state_and_input(self, state: ReactivePlannerState):
        """Append state + derived control input (reactive_planner.py:391-408)."""
        self._record_state_list.append(state)
        if len(self._record_state_list) > 1:
            steering_angle_speed = (
                state.steering_angle -
                self._record_state_list[-2].steering_angle) / self.dt
        else:
            steering_angle_speed = 0.0
        self._record_input_list.append(InputState(
            time_step=state.time_step, acceleration=state.acceleration,
            steering_angle_speed=steering_angle_speed))

    def _reset_statistics(self):
        """(reactive_planner.py:410-419)"""
        self._optimal_cost = 0
        self._infeasible_count_kinematics = 0
        self._infeasible_count_collision = 0
        for constraint in self.config.planning.constraints_to_check:
            self._infeasible_reason_dict[constraint] = 0

    def _add_reason_counts(self, counts: np.ndarray):
        """The per-constraint counters from a level program's readback
        (goal-valid, kinematically infeasible candidates of the evaluated or
        selected level, per first-failure reason code)."""
        for code, name in kin_ops.REASON_NAMES.items():
            if name in self._infeasible_reason_dict:
                self._infeasible_reason_dict[name] += int(counts[code])

    def _create_trajectory_bundle(self, x_0_lon, x_0_lat,
                                  samp_level: int) -> CandidateBatch:
        """Candidate grid of one level (reactive_planner.py:421-444)."""
        return self.sampling_space.generate_trajectories_at_level(
            samp_level, np.asarray(x_0_lon), np.asarray(x_0_lat),
            self.config.sampling.longitudinal_mode, self._low_vel_mode)

    def _compute_initial_states(self, x_0: ReactivePlannerState):
        """Cartesian -> curvilinear initial state (Werling Eqs. A.3/A.5)."""
        if not self._co:
            return None
        try:
            return self._co.compute_initial_curvilinear_states(
                x_0.position, x_0.orientation, x_0.velocity,
                x_0.acceleration, x_0.steering_angle,
                self.vehicle_params.wheelbase, self._low_vel_mode)
        except ValueError:
            logger.critical("Initial state could not be transformed.")
            raise ValueError("Initial state could not be transformed.")

    # ------------------------------------------------------------------
    # planning cycle (reactive_planner.py:570-665)
    # ------------------------------------------------------------------

    def begin_cycle(self):
        """Checks and initial curvilinear state of a planning cycle; sets the
        low-velocity mode.  Returns (x_0_lon, x_0_lat)."""
        check_fast_scope(self.config)
        assert self.x_0 is not None, \
            "<ReactivePlanner.plan(): Planner Cartesian initial state is empty!>"
        assert self._co is not None, \
            "<ReactivePlanner.plan(): No coordinate system given. Call set_reference_path()>"
        if not self.x_0_cl:
            self.x_0_cl = self._compute_initial_states(self.x_0)
        assert self.x_0_cl is not None, \
            "<ReactivePlanner.plan(): Planner curvilinear initial state is empty!>"
        self._low_vel_mode = \
            self.x_0.velocity < self.config.planning.low_vel_mode_threshold
        return self.x_0_cl

    def plan(self, current_sampling_level: int = None) -> Optional[tuple]:
        """Plan an optimal trajectory; returns (cartesian Trajectory,
        curvilinear Trajectory, lon list, lat list), or None."""
        with profiling.span("planner.plan"):
            planning_start_time = time.perf_counter()
            x_0_lon, x_0_lat = self.begin_cycle()
            logger.info("=== Starting Planning Cycle (time_step=%s, "
                        "v=%.3f) ===", self.x_0.time_step, self.x_0.velocity)

            optimal_trajectory: Optional[OptimalTrajectory] = None
            if current_sampling_level is None and self._kernel_ok():
                # every level scored in one kernel launch
                if self.sampling_level > 1:
                    optimal_trajectory = self._plan_all_levels_fast(
                        x_0_lon, x_0_lat, 1)
            else:
                # sequential escalation (reactive_planner.py:616-636)
                i = 1 if current_sampling_level is None \
                    else current_sampling_level
                while optimal_trajectory is None and i < self.sampling_level:
                    with self.stage_timers.stage("grid_generation"):
                        batch = self._create_trajectory_bundle(
                            x_0_lon, x_0_lat, i)
                    logger.info("Sampling level %d/%d: %d candidates", i + 1,
                                self.sampling_level, batch.size)
                    optimal_trajectory = self._get_optimal_trajectory(batch)
                    logger.info("Rejected %d kinematically infeasible, %d "
                                "colliding", self._infeasible_count_kinematics,
                                self._infeasible_count_collision)
                    if current_sampling_level is not None:
                        break
                    i += 1

            # standstill fallback (reactive_planner.py:638-653)
            if ((optimal_trajectory is None or
                 optimal_trajectory.cartesian.v[self._standstill_lookahead]
                 <= 0.05) and self.x_0.velocity <= 0.05):
                logger.info("Planning standstill for the current scenario")
                optimal_trajectory = self._compute_standstill_trajectory()

            planning_result = None
            if optimal_trajectory is not None:
                self._optimal_cost = optimal_trajectory.cost
                with profiling.span("planner.result"):
                    planning_result = self._compute_trajectory_pair(
                        optimal_trajectory)

            self._planning_times_list.append(
                time.perf_counter() - planning_start_time)
        logger.info("Total planning time: %.7f", self._planning_times_list[-1])
        if planning_result is None:
            logger.warning("Planner failed to find an optimal trajectory "
                           "with given sampling configuration!")
        return planning_result

    def _goal_valid_mask(self, batch: CandidateBatch) -> np.ndarray:
        """filter_goals_behind in stopping mode (:1076-1077)."""
        if self.config.sampling.longitudinal_mode == "stopping":
            return np.where(np.isnan(batch.lon_xd_pos), True,
                            batch.lon_x0_pos < batch.lon_xd_pos)
        return np.ones(batch.size, dtype=bool)

    def _scalar(self, x) -> float:
        """A host scalar in the planner's dtype (float32 values rounded)."""
        return float(x) if self._dtype == torch.float64 \
            else float(np.float32(x))

    def _kernel_ok(self) -> bool:
        """The fused float32 scorer applies (fast_scoring, float32 kernels;
        ``set_cost_function`` admits only the costs it scores); otherwise
        the conformance level program runs.  The ``segments`` boundary and
        the continuous pass run on the fused path as lazy winner
        refinement."""
        return bool(self.config.debug.fast_scoring
                    and self._dtype == torch.float32)

    def _boundary_mode(self) -> str:
        """The road-boundary check: 'none' without boundary segments, else
        ``planning.boundary_mode`` ('corridor' or 'segments')."""
        if self._cc.boundary.segments.shape[0] == 0:
            return "none"
        return self.config.planning.boundary_mode

    def _scene_context(self):
        """Per-cycle scene pack shared by the level paths: vehicle scalars,
        obstacle window, boundary mode + corridor, constraint flags and cost
        parameters, all in the planner's dtype."""
        veh = self._vehicle_arrays()
        obstacles = self._cc.obstacles_for_window(
            self.x_0.time_step, self.N, self.config.planning.factor)
        boundary_mode = self._boundary_mode()
        corridor = self._cc.corridor_for(self._co) \
            if boundary_mode == "corridor" else None
        constraints = self.config.planning.constraints_to_check
        flags = tuple(c in constraints for c in _CONSTRAINT_ORDER)

        cf = self.cost_function
        # fail-safe cost = the default formula at w_a=1, desired_d=0 without
        # the velocity and stopping terms (cost_function.py:74-92)
        fail_safe = cf.structure[0] == "fail_safe"
        sc = self._scalar
        cost_params = cycle_ops.CostParams(
            w_a=sc(1.0 if fail_safe else getattr(cf, "w_a", 0.0)),
            desired_d=sc(0.0 if fail_safe
                         else getattr(cf, "desired_d", 0.0)),
            desired_speed=sc(getattr(cf, "desired_speed", None) or 0.0),
            desired_s=sc(getattr(cf, "desired_s", None) or 0.0))
        return dict(veh=veh, obstacles=obstacles, boundary=self._cc.boundary,
                    boundary_mode=boundary_mode, corridor=corridor,
                    flags=flags, cost_params=cost_params)

    def _corridor_or_unbounded(self, corridor):
        """Without a road boundary the bands are unbounded (+-BAND_CLAMP,
        which never binds under the 19.9 m lateral domain cap); built once
        per reference path."""
        if corridor is not None:
            return corridor
        P = int(self._co.tables.s.shape[0])
        if self._unbounded is None or self._unbounded[0] is not self._co:
            full = lambda v: torch.full((P,), v, dtype=torch.float32,
                                        device=self.device)
            self._unbounded = (self._co, collision_ops.CorridorArrays(
                d_lo=full(-collision_ops.BAND_CLAMP),
                d_hi=full(collision_ops.BAND_CLAMP)))
        return self._unbounded[1]

    def _level_program(self, kind: str, args: level_program.LevelArgs,
                       static: dict) -> level_program.LevelProgram:
        """The built level program of this call's signature (LRU of
        ``LEVEL_PROGRAMS``), built on a miss."""
        key = level_program.signature(kind, args, static, self.graph)
        program = self.level_programs.get(key)
        if program is None:
            program = level_program.LevelProgram(kind, args, static,
                                                 self.graph)
            self.level_programs[key] = program
            while len(self.level_programs) > LEVEL_PROGRAMS:
                self.level_programs.popitem(last=False)
        else:
            self.level_programs.move_to_end(key)
        return program

    def fast_arguments(self, batches: List[CandidateBatch]):
        """(LevelArgs, static arguments) of the fused level program for the
        union of ``batches``."""
        ctx = self._scene_context()
        cat = lambda parts: np.concatenate(parts)
        args = level_program.LevelArgs(
            coeffs_lon=cat([b.coeffs_lon for b in batches]),
            coeffs_lat=cat([b.coeffs_lat for b in batches]),
            traj_len=cat([b.traj_len for b in batches]),
            goal_valid=cat([self._goal_valid_mask(b) for b in batches]),
            level_ids=cat([np.full(b.size, j, np.int32)
                           for j, b in enumerate(batches)]),
            x0_orientation=float(np.float32(self.x_0.orientation)),
            cost_params=ctx["cost_params"], veh=ctx["veh"],
            ref=self._co.tables,
            corridor=self._corridor_or_unbounded(ctx["corridor"]),
            obstacles=ctx["obstacles"],
            boundary=ctx["boundary"] if ctx["boundary_mode"] == "segments"
            else None)
        static = dict(dt=self.dt, n_steps=self.N,
                      low_vel_mode=self._low_vel_mode,
                      cost_structure=self.cost_function.structure,
                      constraint_flags=ctx["flags"], n_levels=len(batches),
                      continuous=self.config.planning
                      .continuous_collision_check)
        return args, static

    def cycle_inputs(self, batches: List[CandidateBatch]) -> dict:
        """Keyword arguments of ``ops.cycle.evaluate_levels_fast`` for the
        union of ``batches`` (tensors on the planner's device), without the
        refinement's (``boundary``, ``continuous``)."""
        args, static = self.fast_arguments(batches)
        kwargs = level_program.eager_arguments(level_program.FAST, args,
                                               self.device)
        kwargs.pop("boundary")
        static.pop("continuous")
        return dict(kwargs, **static)

    def _evaluate(self, batches: List[CandidateBatch]):
        """Score the union of ``batches`` in one launch through the fused
        level program and read back the winner (one device->host transfer;
        one more when the bounded refinement overflows and the lazy loop
        goes on eagerly)."""
        self._reset_statistics()
        with self.stage_timers.stage("device_cycle"):
            with profiling.span("planner.arguments"):
                args, static = self.fast_arguments(batches)
                program = self._level_program(level_program.FAST, args,
                                              static)
            out = program(args)
            if out.overflow:
                self.refine_continuations += 1
                logger.info("exact refinement: more than %d re-selections, "
                            "continued eagerly", cycle_ops.REFINE_WIDTH)
                out = program.continue_lazy()
            scalars = out.scalars
            found = bool(np.isfinite(scalars[1]))

        self._infeasible_count_kinematics = int(scalars[2])
        self._infeasible_count_collision = int(scalars[3])
        if found and scalars[4] < 0.5:
            logger.warning("fused scorer: the selected winner fails the "
                           "exact feasibility re-check (a boundary-tight "
                           "verdict flipped)")
        level = int(scalars[5])
        self._add_reason_counts(out.reason_counts)
        logger.info("Selected sampling level %d (%d candidates)", level,
                    batches[level].size)
        logger.info("Rejected %d kinematically infeasible, %d colliding",
                    self._infeasible_count_kinematics,
                    self._infeasible_count_collision)
        if self._draw_traj_set:
            # the selected level's slice: the level the escalation loop of
            # the conformance path stops at
            batch = batches[level]
            self._capture_bundle_fast(batch, self._goal_valid_mask(batch))
        return self._finalize_level(found, scalars, out.optimal)

    def _capture_bundle_fast(self, batch: CandidateBatch,
                             goal_valid: np.ndarray):
        """Trajectory-set capture on the fused path (draw_traj_set): one
        conformance level program call on ``batch`` after the selection, in
        float32 on the planner's device, for its dense [K, T] states and
        feasibility/collision labels (reactive_planner.py:1122-1123).  The
        fused scorer stays the selection path: nothing of the selection,
        the counters or the reason statistics is touched, and x, y, the
        costs and the two label rows come back in the call's one
        readback."""
        self.stored_trajectories = BundleSummary(*self._conformance_level(
            batch, goal_valid, bundle=True).bundle)

    def _finalize_level(self, found: bool, scalars: np.ndarray,
                        optimal_packed: np.ndarray):
        """Shared tail of both level paths: the winner's [14, T] pack as an
        OptimalTrajectory, or None when nothing was found."""
        if not found:
            return None
        arrays = cycle_ops.unpack_candidate(optimal_packed)
        optimal = OptimalTrajectory(arrays=arrays, cost=float(scalars[1]),
                                    dt=self.dt, horizon=self.horizon)
        logger.debug("Selected candidate %d with cost %.3f", int(scalars[0]),
                     optimal.cost)
        return optimal

    def _plan_all_levels_fast(self, x_0_lon, x_0_lat, start_level: int):
        """Fused level escalation: every remaining sampling level's bundle in
        ONE kernel launch; the winner comes from the first level with a
        feasible candidate (reactive_planner.py:616-636)."""
        levels = list(range(start_level, self.sampling_level))
        with self.stage_timers.stage("grid_generation"):
            batches = [self._create_trajectory_bundle(x_0_lon, x_0_lat, lv)
                       for lv in levels]
        logger.info("Fused levels %d..%d: %d candidates, one launch",
                    start_level + 1, self.sampling_level,
                    sum(b.size for b in batches))
        return self._evaluate(batches)

    def _get_optimal_trajectory(self, batch: CandidateBatch):
        """One sampling level (replaces reactive_planner.py:1065-1136): on
        the fused scorer when it applies, else through the conformance level
        program ``ops.cycle.evaluate_level``."""
        if self._kernel_ok():
            return self._evaluate([batch])
        self._reset_statistics()
        goal_valid = self._goal_valid_mask(batch)
        # one device->host transfer: the [4] scalar pack, the [14, T]
        # winner, the reason counts (and the bundle when captured)
        with self.stage_timers.stage("device_cycle"):
            out = self._conformance_level(batch, goal_valid,
                                          bundle=self._draw_traj_set)
            scalars = out.scalars
            found = bool(np.isfinite(scalars[1]))

        # statistics with reference lazy-iteration semantics; goal-filtered
        # candidates never enter the kinematic check (:1076-1077)
        self._infeasible_count_kinematics = int(scalars[2])
        self._infeasible_count_collision = int(scalars[3])
        self._add_reason_counts(out.reason_counts)
        if self._draw_traj_set:
            self.stored_trajectories = BundleSummary(*out.bundle)
        return self._finalize_level(found, scalars, out.optimal)

    def level_arguments(self, batch: CandidateBatch, goal_valid: np.ndarray,
                        bundle: bool = False):
        """(LevelArgs, static arguments) of the conformance level program
        for ``batch`` in the planner's dtype; ``bundle`` asks for the dense
        bundle in the readback."""
        ctx = self._scene_context()
        boundary_mode = ctx["boundary_mode"]
        args = level_program.LevelArgs(
            coeffs_lon=batch.coeffs_lon, coeffs_lat=batch.coeffs_lat,
            traj_len=batch.traj_len, goal_valid=goal_valid, level_ids=None,
            x0_orientation=self._scalar(self.x_0.orientation),
            cost_params=ctx["cost_params"], veh=ctx["veh"],
            ref=self._co.tables, corridor=ctx["corridor"],
            obstacles=ctx["obstacles"],
            boundary=ctx["boundary"] if boundary_mode == "segments" else None)
        static = dict(dt=self.dt, n_steps=self.N,
                      low_vel_mode=self._low_vel_mode,
                      cost_structure=self.cost_function.structure,
                      constraint_flags=ctx["flags"],
                      boundary_mode=boundary_mode,
                      continuous_check=self.config.planning
                      .continuous_collision_check, bundle=bool(bundle))
        return args, static

    def _conformance_level(self, batch: CandidateBatch,
                           goal_valid: np.ndarray, bundle: bool = False
                           ) -> level_program.LevelOutput:
        """``batch`` through the conformance level program
        (``ops.cycle.evaluate_level``) in the planner's dtype, on its
        device."""
        args, static = self.level_arguments(batch, goal_valid, bundle)
        return self._level_program(level_program.LEVEL, args, static)(args)

    # ------------------------------------------------------------------
    # device replanning loop (commonroad_rp_tpu models/planner.py:586-825)
    # ------------------------------------------------------------------

    def scan_program(self, n_cycles: int, scorer=None, graph: bool = True):
        """(run, carry) of the device loop ``plan_scan`` drives: ``run(carry,
        desired_speed)`` runs ``n_cycles`` cycles from the planner's current
        state and returns (carry, metrics) without reading the device.
        Built scans are cached (LRU of 4) on everything they close over; a
        built scan on the card holds its captured cycle and the graph's
        memory pool (``ops.program.ScanProgram``), and
        ``graph=False`` builds the uncaptured twin (the CPU runs eagerly
        whatever ``graph`` says).  ``scorer`` replaces
        the scan's scoring function (``ops.scoring.score_prepared``), e.g.
        by its plain version."""
        check_fast_scope(self.config)
        assert self.x_0 is not None and self._co is not None
        if not self.x_0_cl:
            self.x_0_cl = self._compute_initial_states(self.x_0)
        self._low_vel_mode = \
            self.x_0.velocity < self.config.planning.low_vel_mode_threshold

        cf = self.cost_function
        cf_structure = cf.structure
        if not self._kernel_ok() or cf_structure[0] != "default" \
                or not cf_structure[1]:
            raise ValueError("plan_scan requires the fused-kernel scope "
                             "(debug.fast_scoring, float32 kernels, "
                             "default cost with speed target)")
        longitudinal_mode = self.config.sampling.longitudinal_mode
        if longitudinal_mode not in ("velocity_keeping", "stopping"):
            raise ValueError(f"plan_scan: unknown longitudinal mode "
                             f"{longitudinal_mode!r}")
        stopping = longitudinal_mode == "stopping"
        if stopping and self._desired_lon_position is None:
            raise ValueError("stopping mode: call set_desired_lon_position() "
                             "before plan_scan")
        factor = self.config.planning.factor
        if self.x_0.time_step % factor != 0:
            raise ValueError(f"plan_scan: initial time_step "
                             f"{self.x_0.time_step} must be divisible by "
                             f"planning.factor {factor}")
        if self._desired_speed is None:
            raise ValueError("call set_desired_velocity() before plan_scan")
        desired_s = float(self._desired_lon_position) if stopping else None
        s_window = None
        if stopping:
            samples_s = self.sampling_space.samples_s
            s_window = (float(samples_s.low), float(samples_s.up))

        cs = self.config.sampling
        corridor_grids = None
        corridor_pin = None
        if isinstance(self.sampling_space, CorridorSampling):
            corridor_pin = self.sampling_space.driving_corridor
            if corridor_pin is None:
                raise ValueError("corridor sampling: set driving_corridor "
                                 "before plan_scan")
            corridor_grids = tuple(
                grid_ops.make_corridor_grid(self.sampling_space, level,
                                            self.dt, self.device)
                for level in range(1, self.sampling_level))
            grids = ()
        else:
            grids = tuple(
                grid_ops.make_static_grid(level, cs.t_min, self.horizon,
                                          self.dt, cs.d_min, cs.d_max,
                                          cs.num_sampling_levels)
                for level in range(1, self.sampling_level))

        # full-span obstacle tables: every scenario step the scan can touch,
        # sampled at planning.factor stride (one table row per planned step,
        # reference reactive_planner.py:1032 scaling)
        freq = self.config.planning.replanning_frequency
        span = self.x_0.time_step // factor + n_cycles * freq + self.N + 1
        constraints = self.config.planning.constraints_to_check
        flags = tuple(c in constraints for c in _CONSTRAINT_ORDER)
        lookahead = min(self._standstill_lookahead, self.N)
        boundary_mode = self._boundary_mode()
        continuous = self.config.planning.continuous_collision_check
        w_a = float(getattr(cf, "w_a", 5.0))
        desired_d = float(getattr(cf, "desired_d", 0.0))
        # the key holds the CoordinateSystem object itself (identity compare
        # + a strong ref); the cached value pins the corridor object
        cache_key = (n_cycles, freq, self.N, span, self._co, w_a, desired_d,
                     flags, longitudinal_mode, desired_s, s_window, lookahead,
                     factor, boundary_mode, continuous,
                     None if corridor_pin is None else id(corridor_pin),
                     scorer, bool(graph))
        cache = self.__dict__.setdefault("_plan_scan_cache", OrderedDict())
        hit = cache.get(cache_key)
        if hit is not None and hit[1] is corridor_pin:
            cache.move_to_end(cache_key)          # LRU refresh
            run = hit[0]
        else:
            obstacles_full = collision_ops.compile_obstacles(
                self._cc.scenario, 0, span, factor, dtype=torch.float32,
                device=self.device)
            corridor = self._cc.corridor_for(self._co) \
                if boundary_mode == "corridor" else None
            run = replanning_scan.make_facade_replanning_scan(
                self._co.tables, self._corridor_or_unbounded(corridor),
                obstacles_full, self._vehicle_arrays(), grids, self.dt,
                self.N, freq, self.config.planning.low_vel_mode_threshold,
                self.horizon, float(self._desired_speed), w_a, desired_d,
                flags, n_cycles, longitudinal_mode=longitudinal_mode,
                desired_s=desired_s, s_window=s_window,
                standstill_lookahead=lookahead,
                boundary=self._cc.boundary if boundary_mode == "segments"
                else None,
                continuous=continuous, corridor_grids=corridor_grids,
                graph=graph,
                **({} if scorer is None else dict(scorer=scorer)))
            # LRU over the last few built scans: mode-alternating missions
            # (velocity keeping <-> stopping) must not rebuild per switch
            cache[cache_key] = (run, corridor_pin)
            self._plan_scan_builds = getattr(self, "_plan_scan_builds", 0) + 1
            while len(cache) > 4:
                cache.popitem(last=False)

        x0_lon, x0_lat = self.x_0_cl
        kappa_0 = np.tan(self.x_0.steering_angle) / \
            self.vehicle_params.wheelbase
        f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32),
                                        device=self.device)
        carry = replanning_scan.FacadeScanCarry(
            x0_lon=f32(x0_lon), x0_lat=f32(x0_lat),
            orientation=f32(self.x_0.orientation),
            velocity=f32(self.x_0.velocity),
            # the scan indexes obstacle tables in planned steps (tables are
            # factor-strided); scenario steps = planned * factor
            time_step=torch.as_tensor(self.x_0.time_step // factor,
                                      dtype=torch.int32, device=self.device),
            alive=torch.ones((), dtype=torch.bool, device=self.device),
            kappa=f32(kappa_0), px=f32(self.x_0.position[0]),
            py=f32(self.x_0.position[1]))
        return run, carry

    def plan_scan(self, n_cycles: int, record: bool = True,
                  stop_on_goal: bool = True) -> dict:
        """Device-resident multi-cycle replanning: the reference driver's
        cyclic loop (run_planner.py:61-107) with no device readback between
        cycles.

        Each cycle regenerates every sampling level's grid on the device
        around the carried state, scores the level union in one scorer
        launch, selects the first-found level's winner (escalation
        semantics), and advances ``replanning_frequency`` steps.  Scope: the
        fused-kernel scope (``debug.fast_scoring``, float32 kernels, default
        cost with a speed target; ValueError outside it); corridor,
        ``segments`` and no-boundary modes, discrete and continuous
        collision checks, any ``planning.factor``, fixed-interval and
        corridor sampling, and both longitudinal modes (stopping mode
        requires ``set_desired_lon_position`` first).  The exact
        ``segments`` SAT and the swept continuous pass run as a bounded
        device-side refinement of the cheapest candidates
        (``parallel.replanning_scan``); a cycle that would need more
        re-selections than its bound raises RuntimeError after the scan.
        Standstill starts work, and the standstill
        fallback (reactive_planner.py:638-653, :667-713) runs on the device.

        Returns a dict with ``goal_reached``, ``cycles_run``, ``steps``,
        per-cycle ``found``/``best_cost``/rejection counters and
        ``reselections`` (winners the exact refinement masked); with
        ``record=True`` the driven states are appended to
        ``record_state_list`` and the planner state advances to the final
        recorded state (like reset() in the host loop).
        """
        run, carry = self.scan_program(n_cycles)
        freq = self.config.planning.replanning_frequency
        factor = self.config.planning.factor

        with self.stage_timers.stage("device_scan"):
            _, metrics = run(carry, float(self._desired_speed))
            found, best_cost, n_inf_kin, n_coll, states, reselections, \
                overflow = (m.cpu().numpy() for m in metrics)
        wall = self.stage_timers.history["device_scan"][-1]
        logger.info("plan_scan: %d cycles in %.4fs (%.2f ms/cycle)",
                    n_cycles, wall, wall / max(n_cycles, 1) * 1e3)

        goal = self.config.planning_problem.goal
        wb = self.vehicle_params.wb_rear_axle
        cycles_run = 0
        steps = 0
        goal_reached = False
        last_state = None
        t_start = self.x_0.time_step
        prev_theta = self.x_0.orientation
        prev_lon_lat = None
        for c in range(n_cycles):
            if not found[c]:
                break
            cycles_run += 1
            arr = states[c]                          # [14, freq + 1]
            for offset in range(1, freq + 1):
                steps += 1
                theta = float(arr[9, offset])
                state = ReactivePlannerState(
                    # scenario steps advance factor per planned step
                    # (reactive_planner.py:1032)
                    time_step=t_start + factor * ((c * freq) + offset),
                    position=np.array([arr[7, offset], arr[8, offset]]),
                    orientation=theta,
                    velocity=float(arr[10, offset]),
                    acceleration=float(arr[11, offset]),
                    yaw_rate=(theta - prev_theta) / self.dt,
                    steering_angle=float(np.arctan2(
                        self.vehicle_params.wheelbase * arr[12, offset],
                        1.0)))
                prev_theta = theta
                last_state = state
                prev_lon_lat = (list(arr[0:3, offset]),
                                list(arr[3:6, offset]))
                if record:
                    self.record_state_and_input(state)
                if goal.is_reached(state.shift_positions_to_center(wb)):
                    # stop_on_goal=False keeps driving (stop-at-goal
                    # missions continue inside the goal region until the
                    # stopping mode halts the vehicle)
                    goal_reached = True
                    if stop_on_goal:
                        break
            if goal_reached and stop_on_goal:
                break

        if overflow[:cycles_run].any():
            raise RuntimeError(
                "plan_scan: the exact refinement of cycle "
                f"{int(np.argmax(overflow))} needed more than "
                f"{cycle_ops.REFINE_WIDTH} re-selections; plan() has "
                "no such bound")
        if record and last_state is not None:
            # advance the planner like the host loop's reset()
            self.reset(initial_state_cart=last_state,
                       initial_state_curv=prev_lon_lat,
                       collision_checker=self._cc,
                       coordinate_system=self._co)
        if cycles_run:
            self._infeasible_count_kinematics = int(n_inf_kin[cycles_run - 1])
            self._infeasible_count_collision = int(n_coll[cycles_run - 1])
            self._optimal_cost = float(best_cost[cycles_run - 1])

        return dict(goal_reached=goal_reached, cycles_run=cycles_run,
                    steps=steps, found=found[:cycles_run].tolist(),
                    best_cost=best_cost[:cycles_run].tolist(),
                    n_inf_kinematics=n_inf_kin[:cycles_run].tolist(),
                    n_inf_collision=n_coll[:cycles_run].tolist(),
                    reselections=reselections[:cycles_run].tolist(),
                    wall_time=wall)

    def _vehicle_arrays(self) -> kin_ops.VehicleArrays:
        """Vehicle scalars in the planner's dtype (host floats)."""
        v = self.vehicle_params
        sc = self._scalar
        return kin_ops.VehicleArrays(
            wheelbase=sc(v.wheelbase), wb_rear_axle=sc(v.wb_rear_axle),
            a_max=sc(v.a_max), v_switch=sc(v.v_switch),
            kappa_max=sc(np.tan(v.delta_max) / v.wheelbase),
            v_delta_max=sc(v.v_delta_max), half_length=sc(0.5 * v.length),
            half_width=sc(0.5 * v.width))

    # ------------------------------------------------------------------
    # standstill fallback (reactive_planner.py:667-713)
    # ------------------------------------------------------------------

    def _compute_standstill_trajectory(self) -> OptimalTrajectory:
        x_0 = self.x_0
        x_0_lon, x_0_lat = self.x_0_cl
        N = self.N

        kappa_0 = np.tan(x_0.steering_angle) / self.vehicle_params.wheelbase

        a = np.repeat(0.0, N)
        a[1] = -self.x_0.velocity / self.dt

        ref_pos = self._co.ref_pos
        s_idx = int(np.argmax(ref_pos > x_0_lon[0])) - 1
        ref_theta = np.unwrap(self._co.ref_theta)
        theta_cl = x_0.orientation - interpolate_angle(
            x_0_lon[0], ref_pos[s_idx], ref_pos[s_idx + 1],
            ref_theta[s_idx], ref_theta[s_idx + 1])

        rep = lambda val: np.repeat(float(val), N)
        arrays = dict(
            x=rep(x_0.position[0]), y=rep(x_0.position[1]),
            theta_gl=rep(x_0.orientation), v=rep(0.0), a=a,
            kappa_gl=rep(kappa_0), kappa_dot=rep(0.0),
            s=rep(x_0_lon[0]), s_dot=rep(x_0_lon[1]), s_ddot=rep(x_0_lon[2]),
            d=rep(x_0_lat[0]), d_dot=rep(x_0_lat[1]), d_ddot=rep(x_0_lat[2]),
            theta_cl=rep(theta_cl))
        return OptimalTrajectory(arrays=arrays, cost=0.0, dt=self.dt,
                                 horizon=self.horizon)

    # ------------------------------------------------------------------
    # output assembly (reactive_planner.py:514-568)
    # ------------------------------------------------------------------

    def _compute_trajectory_pair(self, trajectory: OptimalTrajectory
                                 ) -> Tuple[Trajectory, Trajectory, List, List]:
        arr = trajectory.arrays
        cart_list, cl_list, lon_list, lat_list = [], [], [], []
        scaling_factor = self.config.planning.factor
        length = len(arr["x"])
        for i in range(length):
            yaw_rate = (arr["theta_gl"][i] - arr["theta_gl"][i - 1]) / self.dt \
                if i > 0 else self.x_0.yaw_rate
            cart_list.append(ReactivePlannerState(
                time_step=self.x_0.time_step + scaling_factor * i,
                position=np.array([arr["x"][i], arr["y"][i]]),
                orientation=arr["theta_gl"][i], velocity=arr["v"][i],
                acceleration=arr["a"][i], yaw_rate=yaw_rate,
                steering_angle=np.arctan2(
                    self.vehicle_params.wheelbase * arr["kappa_gl"][i], 1.0)))
            cl_list.append(TraceState(
                time_step=self.x_0.time_step + scaling_factor * i,
                position=np.array([arr["s"][i], arr["d"][i]]),
                velocity=arr["v"][i], acceleration=arr["a"][i],
                orientation=arr["theta_gl"][i], yaw_rate=arr["kappa_gl"][i]))
            lon_list.append([arr["s"][i], arr["s_dot"][i], arr["s_ddot"][i]])
            lat_list.append([arr["d"][i], arr["d_dot"][i], arr["d_ddot"][i]])

        cart_traj = Trajectory(self.x_0.time_step, cart_list)
        cl_traj = Trajectory(self.x_0.time_step, cl_list)
        # wrap output orientations around x_0 (reactive_planner.py:565-566)
        shift_orientation_states(cart_traj.state_list,
                                 interval_start=self.x_0.orientation - np.pi,
                                 interval_end=self.x_0.orientation + np.pi)
        return cart_traj, cl_traj, lon_list, lat_list

    def convert_state_list_to_commonroad_object(self, state_list,
                                                obstacle_id: int = 42):
        """Planner output -> dynamic-obstacle prediction
        (reactive_planner.py:1138-1159)."""
        shifted = [s.shift_positions_to_center(self.vehicle_params.wb_rear_axle)
                   for s in state_list]
        shape = Rectangle(self.vehicle_params.length, self.vehicle_params.width)
        return DynamicObstacle(obstacle_id, "car", shape, shifted[0],
                               trajectory=shifted)
