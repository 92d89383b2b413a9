"""General helpers: scenario loading, desired-velocity heuristic, orientation wrap.

Equivalents of commonroad_rp/utility/general.py:11-55.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from commonroad_rp_tpu_torch.utils.scenario import (Interval, PlanningProblem,
                                              PlanningProblemSet, Scenario,
                                              read_scenario_xml)


def load_scenario_and_planning_problem(path_scenario: str,
                                       idx_planning_problem: Optional[int] = None
                                       ) -> Tuple[Scenario, PlanningProblem, PlanningProblemSet]:
    """Load scenario + planning problem from an XML file (general.py:11-29)."""
    scenario, pp_set = read_scenario_xml(path_scenario)
    if idx_planning_problem is not None:
        planning_problem = pp_set.find_planning_problem_by_id(idx_planning_problem)
    else:
        planning_problem = list(pp_set.planning_problem_dict.values())[0]
    return scenario, planning_problem, pp_set


def retrieve_desired_velocity_from_pp(planning_problem: PlanningProblem) -> float:
    """Average goal velocity, else initial velocity (general.py:32-46)."""
    goal_state = planning_problem.goal.state_list[0]
    velocity: Optional[Interval] = goal_state.velocity
    if velocity is not None:
        if velocity.start > 0:
            return 0.5 * (velocity.start + velocity.end)
        return 0.5 * velocity.end
    return planning_problem.initial_state.velocity


def shift_orientation_states(states: List, interval_start: float = -np.pi,
                             interval_end: float = np.pi) -> List:
    """Wrap each state's orientation into [interval_start, interval_end]
    (general.py:49-55)."""
    for state in states:
        while state.orientation < interval_start:
            state.orientation += 2 * np.pi
        while state.orientation > interval_end:
            state.orientation -= 2 * np.pi
    return states
