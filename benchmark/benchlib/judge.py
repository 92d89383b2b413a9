"""The comparison that decides ``correct``.

Every cell's answers are judged by the same numbers, each against its
limit from the cell's file (``cells/<cell>.json``, ``limits``):

* ``found_mismatch``: answers where the program and the reference disagree
  on whether a trajectory exists (the standstill fallback counts as one);
* ``rejected``: answers whose candidate the reference rejects (infeasible,
  colliding, or of another sampling level than the reference selects);
* ``count_gap``: the largest difference in the rejection counts
  (kinematically infeasible plus colliding candidates) of an answer;
* ``regret``: the largest cost, relative to the reference's best, by which
  the reference's cost of the program's chosen candidate lies above the
  reference's best.  The program's candidate is the one whose reference
  states lie nearest to the program's answer, so a near-tie decided the
  other way costs nothing here;
* ``cost_err``: the largest relative gap between the program's cost of
  its answer and the reference's cost of the same candidate;
* ``state_gap``: the largest distance between the program's answer and
  the reference states of that candidate (metres, metres per second and
  radians alike);
* ``start_gap``: the largest difference between the program's initial
  curvilinear state and the reference's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

NUMBERS = ("found_mismatch", "rejected", "count_gap", "regret", "cost_err",
           "state_gap", "start_gap")
# metres, and relative cost: far below the distance between two distinct
# candidates' states or costs
TIE_M = 1e-9
# metres (and m/s, rad): candidates whose states lie this close to the
# nearest one are told apart by their cost; float32 rounding of positions
# some hundred metres from the origin is about 1e-5 m
MATCH = 1e-4
class Judge:
    """Accumulates the six numbers over the answers judged."""

    def __init__(self):
        self.values = {name: 0.0 for name in NUMBERS}

    def worst(self, name: str, value: float):
        value = float(value)
        if math.isnan(value):
            value = math.inf
        self.values[name] = max(self.values[name], value)

    def count(self, name: str, n: int = 1):
        self.values[name] += n

    def candidate(self, gap: torch.Tensor, masked: torch.Tensor,
                  raw: torch.Tensor, ok_level: torch.Tensor,
                  best_cost: float, program_cost: float) -> int:
        """One found answer: ``gap`` [K] the distance of each reference
        candidate to the program's answer, ``masked`` [K] the reference's
        cost of each selectable candidate (+inf otherwise), ``raw`` [K]
        every candidate's cost, ``ok_level`` [K] whether a candidate is of
        the reference's selected level.  Returns the index of the candidate
        taken for the program's: of those within ``MATCH`` of the nearest,
        the reference's cheapest selectable one (a candidate of the
        selected level before its duplicate in another level, whose sample
        ladders nest), else the one whose reference cost lies nearest to
        the program's.  Taking the cheapest keeps a walk that follows the
        program's answers on the choices the planner itself makes where
        the answer cannot tell two candidates apart."""
        gap = torch.nan_to_num(gap, nan=math.inf) + \
            torch.where(ok_level, 0.0, TIE_M)
        near = gap <= torch.min(gap) + MATCH
        cheapest = torch.where(near & ok_level, masked, math.inf)
        if bool(torch.isfinite(torch.min(cheapest))):
            j = int(torch.argmin(cheapest))
        else:
            off = torch.abs(torch.nan_to_num(raw, posinf=1e300)
                            - program_cost) / max(abs(program_cost), 1.0)
            j = int(torch.argmin(torch.where(near, off, math.inf)))
        self.worst("state_gap", float(gap[j]))
        ref_cost = float(raw[j])
        if not (bool(ok_level[j]) and math.isfinite(float(masked[j]))):
            self.count("rejected")
        self.worst("regret", (ref_cost - best_cost) / max(abs(best_cost), 1.0))
        self.worst("cost_err",
                   abs(program_cost - ref_cost) / max(abs(ref_cost), 1.0))
        return j

    def result(self, limits: dict):
        """(correct, [(name, value, limit)]) against ``limits``, the cell's
        limit of each number it compares."""
        rows = [(name, self.values[name], float(limits[name]))
                for name in NUMBERS if name in limits]
        return all(value <= limit for _, value, limit in rows), rows


def state_distance(program: dict, reference: dict, steps) -> torch.Tensor:
    """[K]: the largest absolute difference over ``steps`` and over the
    fields the program gave (``program[field]`` [n] against
    ``reference[field]`` [K, T]); positions count as one Euclidean
    distance."""
    gap = None
    for field, ref in reference.items():
        if field not in program or field == "y":
            continue
        p = torch.as_tensor(np.asarray(program[field], dtype=np.float64),
                            dtype=ref.dtype, device=ref.device)
        r = ref[:, steps]
        if field == "x":
            py = torch.as_tensor(np.asarray(program["y"], dtype=np.float64),
                                 dtype=ref.dtype, device=ref.device)
            diff = torch.hypot(r - p[None], reference["y"][:, steps] - py[None])
        elif field == "theta_gl":
            diff = torch.abs(torch.remainder(r - p[None] + math.pi,
                                             2 * math.pi) - math.pi)
        else:
            diff = torch.abs(r - p[None])
        diff = torch.amax(diff, dim=1)
        gap = diff if gap is None else torch.maximum(gap, diff)
    return gap
