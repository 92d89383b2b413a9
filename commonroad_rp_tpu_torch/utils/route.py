"""Route planning: lanelet-graph search -> reference path polyline.

Equivalent of the commonroad-route-planner usage in the reference run script
(reference: run_planner.py:43-44 — ``RoutePlanner(scenario, planning_problem)
.plan_routes().retrieve_first_route().reference_path``): find a lanelet
sequence from the initial position to the goal region and emit a reference
polyline for the curvilinear frame.

Graph model: directed edges lanelet -> successor (weight = lanelet length) and
lanelet -> same-direction adjacent (lane change, small constant weight).
Reference-path assembly concatenates successor-chain centerlines; a lane
change blends laterally between the two lane centerlines with a smoothstep
window.  The result feeds CoordinateSystem, which smooths it again with cubic
splines (utils_coordinate_system.py:74-83).
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from commonroad_rp_tpu_torch.utils import geometry
from commonroad_rp_tpu_torch.utils.scenario import (Lanelet, PlanningProblem,
                                              Scenario)

_LANE_CHANGE_WEIGHT = 5.0


@dataclass
class Route:
    """A planned route: lanelet id sequence + derived reference path."""

    lanelet_ids: List[int]
    reference_path: np.ndarray


class RouteCandidates:
    def __init__(self, routes: List[Route]):
        self._routes = routes

    def retrieve_first_route(self) -> Route:
        if not self._routes:
            raise RuntimeError("No route found from initial state to goal")
        return self._routes[0]

    def __len__(self):
        return len(self._routes)


class RoutePlanner:
    """Shortest-path lanelet routing (commonroad-route-planner role)."""

    def __init__(self, scenario: Scenario, planning_problem: PlanningProblem):
        self.scenario = scenario
        self.planning_problem = planning_problem
        self.network = scenario.lanelet_network

    # ------------------------------------------------------------------

    def _start_lanelets(self) -> List[int]:
        pos = self.planning_problem.initial_state.position
        found = self.network.find_lanelet_by_position(pos)
        if found:
            return found
        # fall back to the nearest lanelet by centerline distance
        best, best_d = None, np.inf
        for lanelet in self.network.lanelets:
            d = np.min(np.linalg.norm(lanelet.center_vertices - pos, axis=1))
            if d < best_d:
                best, best_d = lanelet.lanelet_id, d
        return [best]

    def _goal_lanelets(self) -> List[int]:
        goal = self.planning_problem.goal
        ids: List[int] = []
        for state in goal.state_list:
            ids.extend(state.position_lanelets)
            for shape in state.position_shapes:
                center = getattr(shape, "center", None)
                if center is not None:
                    ids.extend(self.network.find_lanelet_by_position(center))
        if not ids:
            # survival scenario without goal position: stay on start lanelet
            ids = self._start_lanelets()
        return list(dict.fromkeys(ids))

    def _edges(self, lanelet: Lanelet) -> List[Tuple[int, float]]:
        length = geometry.compute_pathlength(lanelet.center_vertices)[-1]
        out = [(succ, length) for succ in lanelet.successors]
        if lanelet.adj_left is not None and lanelet.adj_left_same_direction:
            out.append((lanelet.adj_left, _LANE_CHANGE_WEIGHT))
        if lanelet.adj_right is not None and lanelet.adj_right_same_direction:
            out.append((lanelet.adj_right, _LANE_CHANGE_WEIGHT))
        return out

    def plan_routes(self) -> RouteCandidates:
        starts = self._start_lanelets()
        goals = set(self._goal_lanelets())

        # Dijkstra over the lanelet graph
        dist: Dict[int, float] = {s: 0.0 for s in starts}
        prev: Dict[int, Optional[int]] = {s: None for s in starts}
        heap = [(0.0, s) for s in starts]
        heapq.heapify(heap)
        visited = set()
        reached: Optional[int] = None
        while heap:
            cost, node = heapq.heappop(heap)
            if node in visited:
                continue
            visited.add(node)
            if node in goals:
                reached = node
                break
            for nxt, weight in self._edges(self.network.find_lanelet_by_id(node)):
                new_cost = cost + weight
                if new_cost < dist.get(nxt, np.inf):
                    dist[nxt] = new_cost
                    prev[nxt] = node
                    heapq.heappush(heap, (new_cost, nxt))

        if reached is None:
            # no goal lanelet reachable: stay on the start lanelet chain
            chain = [starts[0]]
            lanelet = self.network.find_lanelet_by_id(starts[0])
            while lanelet.successors:
                chain.append(lanelet.successors[0])
                lanelet = self.network.find_lanelet_by_id(lanelet.successors[0])
            ids = chain
        else:
            ids = [reached]
            while prev[ids[0]] is not None:
                ids.insert(0, prev[ids[0]])

        reference = self._build_reference_path(ids)
        return RouteCandidates([Route(lanelet_ids=ids, reference_path=reference)])

    # ------------------------------------------------------------------

    def _build_reference_path(self, ids: List[int]) -> np.ndarray:
        """Concatenate centerlines; blend laterally across lane changes."""
        lanelets = [self.network.find_lanelet_by_id(i) for i in ids]

        # group consecutive lanelets connected by successor into "lanes"
        lanes: List[np.ndarray] = []
        current = [lanelets[0]]
        for prev_l, lanelet in zip(lanelets, lanelets[1:]):
            if lanelet.lanelet_id in prev_l.successors:
                current.append(lanelet)
            else:
                lanes.append(self._concat_centerlines(current))
                current = [lanelet]
        lanes.append(self._concat_centerlines(current))

        path = lanes[0]
        for nxt in lanes[1:]:
            path = self._blend_lane_change(path, nxt)

        # extend the path when the goal projects near its end, so candidate
        # terminal s-values within the planning horizon stay inside the
        # projection domain (extrapolate_ref_path role,
        # utils_coordinate_system.py:46-57)
        goal_points = []
        for state in self.planning_problem.goal.state_list:
            for shape in state.position_shapes:
                center = getattr(shape, "center", None)
                if center is not None:
                    goal_points.append(np.asarray(center))
            for lanelet_id in state.position_lanelets:
                lanelet = self.network.find_lanelet_by_id(lanelet_id)
                goal_points.append(lanelet.center_vertices[-1])
        if goal_points:
            s_total = geometry.compute_pathlength(path)[-1]
            end_margin = min(
                float(np.linalg.norm(path[-1] - g)) for g in goal_points)
            # a generous horizon bound: 6 s at highway speed
            if end_margin < 150.0:
                extension = max(150.0 - end_margin, 20.0)
                while geometry.compute_pathlength(path)[-1] < s_total + extension:
                    path = geometry.extrapolate_ref_path(path, resample_step=2.0)
        return path

    @staticmethod
    def _concat_centerlines(lanelets: List[Lanelet]) -> np.ndarray:
        parts = [lanelets[0].center_vertices]
        for lanelet in lanelets[1:]:
            center = lanelet.center_vertices
            # successor shares its first vertex with the previous last vertex
            if np.allclose(center[0], parts[-1][-1], atol=1e-6):
                center = center[1:]
            parts.append(center)
        return geometry.remove_duplicate_vertices(np.concatenate(parts, axis=0))

    @staticmethod
    def _blend_lane_change(lane_a: np.ndarray, lane_b: np.ndarray) -> np.ndarray:
        """Smoothstep lateral blend from lane A's centerline into lane B's.

        The blend spans the arclength overlap of the two (parallel) lanes:
        before the overlap the path follows A, after it B.
        """
        s_a = geometry.compute_pathlength(lane_a)

        # project B's endpoints onto A to find the overlap window
        def nearest_s(point):
            d = np.linalg.norm(lane_a - point, axis=1)
            return s_a[int(np.argmin(d))]

        s_start = max(nearest_s(lane_b[0]), s_a[0])
        s_end = min(nearest_s(lane_b[-1]), s_a[-1])
        if s_end <= s_start:                      # disjoint: hard concatenate
            return geometry.remove_duplicate_vertices(
                np.concatenate([lane_a, lane_b], axis=0))
        span = s_end - s_start
        lo = s_start + 0.2 * span
        hi = s_start + 0.8 * span

        out = []
        for point, s in zip(lane_a, s_a):
            w = np.clip((s - lo) / max(hi - lo, 1e-9), 0.0, 1.0)
            w = w * w * (3 - 2 * w)               # smoothstep
            if w <= 0.0:
                out.append(point)
            else:
                d = np.linalg.norm(lane_b - point, axis=1)
                out.append((1 - w) * point + w * lane_b[int(np.argmin(d))])
        # continue on lane B beyond A's end
        d_end = np.linalg.norm(lane_b - lane_a[-1], axis=1)
        b_idx = int(np.argmin(d_end))
        if b_idx + 1 < len(lane_b):
            out.extend(lane_b[b_idx + 1:])
        return geometry.remove_duplicate_vertices(np.asarray(out))
