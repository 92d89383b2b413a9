"""CommonRoad solution XML writer.

Counterpart of ``commonroad_rp_tpu/utils/solution_writer.py``: serializes the
evaluation harness's Solution objects (``utils/evaluation.py``) to the
CommonRoad solution file format, in the role of commonroad-io's
CommonRoadSolutionWriter, and reads them back.  The bytes written are the
JAX package's.
"""

from __future__ import annotations

import datetime
import xml.etree.ElementTree as ET
from typing import Optional

from commonroad_rp_tpu_torch.utils.evaluation import Solution


def _benchmark_id(pps, scenario_id: str) -> str:
    """CommonRoad benchmark id: MODEL+TYPE:COST:SCENARIO:VERSION."""
    return f"{pps.vehicle_model}{pps.vehicle_type}:{pps.cost_function}:" \
           f"{scenario_id}:2020a"


def solution_to_xml(solution: Solution,
                    computation_time: Optional[float] = None) -> ET.Element:
    """Build the <CommonRoadSolution> element tree."""
    root = ET.Element("CommonRoadSolution")
    root.set("date", datetime.date.today().isoformat())
    if solution.planning_problem_solutions:
        root.set("benchmark_id", _benchmark_id(
            solution.planning_problem_solutions[0], solution.scenario_id))
    if computation_time is not None:
        root.set("computation_time", f"{computation_time:.6f}")

    for pps in solution.planning_problem_solutions:
        pp_node = ET.SubElement(root, "planningProblemSolution")
        pp_node.set("planning_problem_id", str(pps.planning_problem_id))
        traj_node = ET.SubElement(pp_node, "trajectory")
        traj_node.set("type", f"{pps.vehicle_model.lower()}Trajectory")
        for state in pps.trajectory.state_list:
            state_node = ET.SubElement(
                traj_node, f"{pps.vehicle_model.lower()}State")
            for tag, value in [
                    ("x", state.position[0]), ("y", state.position[1]),
                    ("steeringAngle", state.steering_angle or 0.0),
                    ("velocity", state.velocity),
                    ("orientation", state.orientation)]:
                child = ET.SubElement(state_node, tag)
                child.text = f"{float(value):.10f}"
            time_node = ET.SubElement(state_node, "time")
            time_node.text = str(int(state.time_step))
    return root


def write_solution_file(solution: Solution, path: str,
                        computation_time: Optional[float] = None):
    """Write the solution XML to disk."""
    root = solution_to_xml(solution, computation_time)
    tree = ET.ElementTree(root)
    ET.indent(tree)
    tree.write(path, encoding="utf-8", xml_declaration=True)


def read_solution_file(path: str) -> Solution:
    """Read a solution file back (round-trip support for checkpoints)."""
    import numpy as np

    from commonroad_rp_tpu_torch.models.state import ReactivePlannerState
    from commonroad_rp_tpu_torch.models.trajectories import Trajectory
    from commonroad_rp_tpu_torch.utils.evaluation import \
        PlanningProblemSolution

    root = ET.parse(path).getroot()
    benchmark = root.get("benchmark_id", "KS2:JB1:unknown:2020a")
    model_type, cost, scenario_id, _ = benchmark.split(":")

    solutions = []
    for pp_node in root.findall("planningProblemSolution"):
        states = []
        traj_node = pp_node.find("trajectory")
        for state_node in traj_node:
            states.append(ReactivePlannerState(
                time_step=int(state_node.find("time").text),
                position=np.array([float(state_node.find("x").text),
                                   float(state_node.find("y").text)]),
                steering_angle=float(state_node.find("steeringAngle").text),
                velocity=float(state_node.find("velocity").text),
                orientation=float(state_node.find("orientation").text)))
        solutions.append(PlanningProblemSolution(
            planning_problem_id=int(pp_node.get("planning_problem_id")),
            vehicle_type=int(model_type[2:]), vehicle_model=model_type[:2],
            cost_function=cost,
            trajectory=Trajectory(states[0].time_step if states else 0,
                                  states)))
    return Solution(scenario_id, solutions)
