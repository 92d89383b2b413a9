"""CommonRoad scenario XML reader and scene data model.

Equivalent of the commonroad-io scenario layer as used by the reference
(SURVEY.md section 2.2): parses CommonRoad XML files (2018b and 2020a formats,
covering the four bundled scenarios) into a lightweight object model —
lanelet network, static/dynamic obstacles with trajectory predictions, and the
planning problem with goal region.  A scenario compiler (``ops.collision``)
flattens obstacles into dense [M, T, pose/extent] device arrays.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from commonroad_rp_tpu_torch.models.state import InitialState, TraceState


# ---------------------------------------------------------------------------
# value primitives
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Interval:
    """Closed interval; scalar exact values are represented as start == end."""

    start: float
    end: float

    def contains(self, value: float) -> bool:
        return self.start <= value <= self.end

    @property
    def mid(self) -> float:
        return 0.5 * (self.start + self.end)


class AngleInterval(Interval):
    """Orientation interval; membership is modulo 2*pi."""

    def contains(self, value: float) -> bool:
        two_pi = 2.0 * np.pi
        span = self.end - self.start
        rel = (value - self.start) % two_pi
        return rel <= span or np.isclose(rel, span) or np.isclose(rel, two_pi)


def _parse_value(node: Optional[ET.Element]):
    """Parse an <exact> or <intervalStart>/<intervalEnd> value node."""
    if node is None:
        return None
    exact = node.find("exact")
    if exact is not None:
        return float(exact.text)
    lo = node.find("intervalStart")
    hi = node.find("intervalEnd")
    if lo is not None and hi is not None:
        return Interval(float(lo.text), float(hi.text))
    return None


def _scalar(value, default=None):
    """Collapse an exact-or-interval value to a scalar (interval midpoint)."""
    if value is None:
        return default
    if isinstance(value, Interval):
        return value.mid
    return float(value)


def _parse_point(node: ET.Element) -> np.ndarray:
    return np.array([float(node.find("x").text), float(node.find("y").text)])


def _parse_points(parent: ET.Element) -> np.ndarray:
    return np.array([_parse_point(p) for p in parent.findall("point")])


# ---------------------------------------------------------------------------
# shapes
# ---------------------------------------------------------------------------

@dataclass
class Rectangle:
    """Oriented rectangle (commonroad-io geometry.shape.Rectangle role)."""

    length: float
    width: float
    orientation: float = 0.0
    center: np.ndarray = field(default_factory=lambda: np.zeros(2))

    def contains_point(self, point: np.ndarray) -> bool:
        rel = np.asarray(point) - self.center
        c, s = np.cos(-self.orientation), np.sin(-self.orientation)
        local = np.array([c * rel[0] - s * rel[1], s * rel[0] + c * rel[1]])
        return (abs(local[0]) <= 0.5 * self.length + 1e-12 and
                abs(local[1]) <= 0.5 * self.width + 1e-12)

    def vertices(self) -> np.ndarray:
        """Corner vertices, counter-clockwise."""
        hl, hw = 0.5 * self.length, 0.5 * self.width
        local = np.array([[hl, hw], [-hl, hw], [-hl, -hw], [hl, -hw]])
        c, s = np.cos(self.orientation), np.sin(self.orientation)
        rot = np.array([[c, -s], [s, c]])
        return local @ rot.T + self.center


@dataclass
class Circle:
    radius: float
    center: np.ndarray = field(default_factory=lambda: np.zeros(2))

    def contains_point(self, point: np.ndarray) -> bool:
        return np.linalg.norm(np.asarray(point) - self.center) <= self.radius + 1e-12


@dataclass
class Polygon:
    points: np.ndarray  # [N, 2]

    def contains_point(self, point: np.ndarray) -> bool:
        return point_in_polygon(np.asarray(point), self.points)


def point_in_polygon(point: np.ndarray, poly: np.ndarray) -> bool:
    """Ray-casting point-in-polygon test."""
    x, y = point
    inside = False
    n = len(poly)
    j = n - 1
    for i in range(n):
        xi, yi = poly[i]
        xj, yj = poly[j]
        if (yi > y) != (yj > y):
            x_cross = (xj - xi) * (y - yi) / (yj - yi) + xi
            if x < x_cross:
                inside = not inside
        j = i
    return inside


def _parse_shape(node: ET.Element):
    rect = node.find("rectangle")
    if rect is not None:
        orient_node = rect.find("orientation")
        center_node = rect.find("center")
        return Rectangle(
            length=float(rect.find("length").text),
            width=float(rect.find("width").text),
            orientation=float(orient_node.text) if orient_node is not None else 0.0,
            center=_parse_point(center_node) if center_node is not None else np.zeros(2),
        )
    circ = node.find("circle")
    if circ is not None:
        center_node = circ.find("center")
        return Circle(
            radius=float(circ.find("radius").text),
            center=_parse_point(center_node) if center_node is not None else np.zeros(2),
        )
    poly = node.find("polygon")
    if poly is not None:
        return Polygon(points=_parse_points(poly))
    raise ValueError(f"Unsupported shape in node <{node.tag}>")


# ---------------------------------------------------------------------------
# lanelet network
# ---------------------------------------------------------------------------

@dataclass
class Lanelet:
    """Lanelet with boundaries and topology (commonroad-io Lanelet role)."""

    lanelet_id: int
    left_vertices: np.ndarray
    right_vertices: np.ndarray
    predecessors: List[int] = field(default_factory=list)
    successors: List[int] = field(default_factory=list)
    adj_left: Optional[int] = None
    adj_left_same_direction: bool = True
    adj_right: Optional[int] = None
    adj_right_same_direction: bool = True
    speed_limit: Optional[float] = None

    @property
    def center_vertices(self) -> np.ndarray:
        return 0.5 * (self.left_vertices + self.right_vertices)

    @property
    def polygon(self) -> np.ndarray:
        """Boundary polygon: left bound + reversed right bound."""
        return np.concatenate((self.left_vertices, self.right_vertices[::-1]), axis=0)

    def contains_point(self, point: np.ndarray) -> bool:
        return point_in_polygon(np.asarray(point), self.polygon)


@dataclass
class LaneletNetwork:
    lanelets: List[Lanelet]

    def __post_init__(self):
        self._by_id: Dict[int, Lanelet] = {l.lanelet_id: l for l in self.lanelets}

    def find_lanelet_by_id(self, lanelet_id: int) -> Lanelet:
        return self._by_id[lanelet_id]

    def find_lanelet_by_position(self, point: np.ndarray) -> List[int]:
        return [l.lanelet_id for l in self.lanelets if l.contains_point(point)]


def _parse_lanelet(node: ET.Element) -> Lanelet:
    left = _parse_points(node.find("leftBound"))
    right = _parse_points(node.find("rightBound"))
    lanelet = Lanelet(lanelet_id=int(node.get("id")), left_vertices=left,
                      right_vertices=right)
    for pred in node.findall("predecessor"):
        lanelet.predecessors.append(int(pred.get("ref")))
    for succ in node.findall("successor"):
        lanelet.successors.append(int(succ.get("ref")))
    adj_l = node.find("adjacentLeft")
    if adj_l is not None:
        lanelet.adj_left = int(adj_l.get("ref"))
        lanelet.adj_left_same_direction = adj_l.get("drivingDir", "same") == "same"
    adj_r = node.find("adjacentRight")
    if adj_r is not None:
        lanelet.adj_right = int(adj_r.get("ref"))
        lanelet.adj_right_same_direction = adj_r.get("drivingDir", "same") == "same"
    sl = node.find("speedLimit")
    if sl is not None:
        lanelet.speed_limit = float(sl.text)
    return lanelet


# ---------------------------------------------------------------------------
# obstacles
# ---------------------------------------------------------------------------

@dataclass
class StaticObstacle:
    obstacle_id: int
    obstacle_type: str
    shape: Rectangle
    initial_state: TraceState


@dataclass
class DynamicObstacle:
    obstacle_id: int
    obstacle_type: str
    shape: Rectangle
    initial_state: TraceState
    trajectory: List[TraceState] = field(default_factory=list)

    def state_at_time(self, time_step: int) -> Optional[TraceState]:
        """Predicted state at a time step; None outside the prediction span."""
        if time_step == self.initial_state.time_step:
            return self.initial_state
        by_step = getattr(self, "_by_step", None)
        if by_step is None:
            by_step = {state.time_step: state for state in self.trajectory}
            object.__setattr__(self, "_by_step", by_step)
        return by_step.get(time_step)


def _parse_state(node: ET.Element) -> TraceState:
    state = TraceState()
    pos = node.find("position")
    if pos is not None:
        point = pos.find("point")
        if point is not None:
            state.position = _parse_point(point)
    state.orientation = _scalar(_parse_value(node.find("orientation")))
    state.velocity = _scalar(_parse_value(node.find("velocity")))
    state.acceleration = _scalar(_parse_value(node.find("acceleration")))
    state.yaw_rate = _scalar(_parse_value(node.find("yawRate")))
    state.slip_angle = _scalar(_parse_value(node.find("slipAngle")))
    time = _parse_value(node.find("time"))
    state.time_step = int(_scalar(time, 0.0))
    return state


def _parse_obstacle(node: ET.Element, role: str):
    obstacle_id = int(node.get("id"))
    type_node = node.find("type")
    obstacle_type = type_node.text if type_node is not None else "unknown"
    shape = _parse_shape(node.find("shape"))
    initial_state = _parse_state(node.find("initialState"))
    if role == "static":
        return StaticObstacle(obstacle_id, obstacle_type, shape, initial_state)
    trajectory: List[TraceState] = []
    traj_node = node.find("trajectory")
    if traj_node is not None:
        trajectory = [_parse_state(s) for s in traj_node.findall("state")]
    return DynamicObstacle(obstacle_id, obstacle_type, shape, initial_state, trajectory)


# ---------------------------------------------------------------------------
# planning problem / goal
# ---------------------------------------------------------------------------

@dataclass
class GoalState:
    """One admissible goal configuration."""

    position_shapes: List[object] = field(default_factory=list)   # Rectangle/Circle/Polygon
    position_lanelets: List[int] = field(default_factory=list)
    orientation: Optional[AngleInterval] = None
    time_step: Optional[Interval] = None
    velocity: Optional[Interval] = None


@dataclass
class GoalRegion:
    """Goal region; reached when ANY goal state is satisfied
    (commonroad-io GoalRegion.is_reached role, used at reactive_planner.py:166)."""

    state_list: List[GoalState]
    lanelet_network: Optional[LaneletNetwork] = None

    def is_reached(self, state: TraceState) -> bool:
        for goal in self.state_list:
            if self._goal_satisfied(goal, state):
                return True
        return False

    def _goal_satisfied(self, goal: GoalState, state: TraceState) -> bool:
        if goal.time_step is not None and not goal.time_step.contains(state.time_step):
            return False
        if goal.velocity is not None and state.velocity is not None \
                and not goal.velocity.contains(state.velocity):
            return False
        if goal.orientation is not None and state.orientation is not None \
                and not goal.orientation.contains(state.orientation):
            return False
        if goal.position_shapes or goal.position_lanelets:
            in_shape = any(s.contains_point(state.position) for s in goal.position_shapes)
            in_lanelet = False
            if goal.position_lanelets and self.lanelet_network is not None:
                in_lanelet = any(
                    self.lanelet_network.find_lanelet_by_id(lid).contains_point(state.position)
                    for lid in goal.position_lanelets)
            if not (in_shape or in_lanelet):
                return False
        return True


@dataclass
class PlanningProblem:
    planning_problem_id: int
    initial_state: InitialState
    goal: GoalRegion


def _parse_planning_problem(node: ET.Element,
                            network: LaneletNetwork) -> PlanningProblem:
    init = _parse_state(node.find("initialState"))
    initial_state = InitialState(**{k: getattr(init, k) for k in (
        "time_step", "position", "orientation", "velocity", "acceleration",
        "yaw_rate", "slip_angle")})
    goal_states = []
    for gs_node in node.findall("goalState"):
        goal = GoalState()
        pos = gs_node.find("position")
        if pos is not None:
            for lanelet_ref in pos.findall("lanelet"):
                goal.position_lanelets.append(int(lanelet_ref.get("ref")))
            # a goal position may hold a shape group: collect EVERY shape
            for child in pos:
                if child.tag in ("rectangle", "circle", "polygon"):
                    wrapper = ET.Element("shape")
                    wrapper.append(child)
                    goal.position_shapes.append(_parse_shape(wrapper))
        orient = _parse_value(gs_node.find("orientation"))
        if isinstance(orient, Interval):
            goal.orientation = AngleInterval(orient.start, orient.end)
        elif orient is not None:
            goal.orientation = AngleInterval(orient, orient)
        time = _parse_value(gs_node.find("time"))
        if isinstance(time, Interval):
            goal.time_step = time
        elif time is not None:
            goal.time_step = Interval(time, time)
        vel = _parse_value(gs_node.find("velocity"))
        if isinstance(vel, Interval):
            goal.velocity = vel
        elif vel is not None:
            goal.velocity = Interval(vel, vel)
        goal_states.append(goal)
    return PlanningProblem(
        planning_problem_id=int(node.get("id")),
        initial_state=initial_state,
        goal=GoalRegion(goal_states, lanelet_network=network),
    )


# ---------------------------------------------------------------------------
# scenario
# ---------------------------------------------------------------------------

@dataclass
class Scenario:
    scenario_id: str
    dt: float
    lanelet_network: LaneletNetwork
    static_obstacles: List[StaticObstacle] = field(default_factory=list)
    dynamic_obstacles: List[DynamicObstacle] = field(default_factory=list)

    @property
    def obstacles(self):
        return list(self.static_obstacles) + list(self.dynamic_obstacles)


@dataclass
class PlanningProblemSet:
    planning_problem_dict: Dict[int, PlanningProblem]

    def find_planning_problem_by_id(self, pp_id: int) -> PlanningProblem:
        return self.planning_problem_dict[pp_id]


def read_scenario_xml(path: str) -> Tuple[Scenario, PlanningProblemSet]:
    """Parse a CommonRoad XML file (2018b or 2020a) into the object model.

    Covers the constructs used by the four bundled scenarios: lanelets with
    topology, static/dynamic obstacles with trajectory predictions, planning
    problems with rectangle or lanelet goal regions (reference consumer:
    CommonRoadFileReader at commonroad_rp/utility/general.py:19).
    """
    root = ET.parse(path).getroot()
    dt = float(root.get("timeStepSize", "0.1"))
    benchmark_id = root.get("benchmarkID", "unknown")

    lanelets = [_parse_lanelet(n) for n in root.findall("lanelet")]
    network = LaneletNetwork(lanelets)

    static_obstacles: List[StaticObstacle] = []
    dynamic_obstacles: List[DynamicObstacle] = []

    # 2018b style: <obstacle> with <role>
    for node in root.findall("obstacle"):
        role_node = node.find("role")
        role = role_node.text.strip() if role_node is not None else "static"
        obstacle = _parse_obstacle(node, role)
        if role == "static":
            static_obstacles.append(obstacle)
        else:
            dynamic_obstacles.append(obstacle)
    # 2020a style: <staticObstacle> / <dynamicObstacle>
    for node in root.findall("staticObstacle"):
        static_obstacles.append(_parse_obstacle(node, "static"))
    for node in root.findall("dynamicObstacle"):
        dynamic_obstacles.append(_parse_obstacle(node, "dynamic"))

    scenario = Scenario(benchmark_id, dt, network, static_obstacles, dynamic_obstacles)

    problems = {}
    for node in root.findall("planningProblem"):
        pp = _parse_planning_problem(node, network)
        problems[pp.planning_problem_id] = pp
    return scenario, PlanningProblemSet(problems)
