"""The fleet of a fleet cell and the reference's judgement of its episodes.

The fleet: every (scenario, vehicle type) base of the configuration,
cycled up to ``fleet_size`` problems, each built by the program's public
``parallel.fleet.problem_from_planner_setup`` and then jittered from the
seed (start speed, lateral offset, desired speed), stacked by
``parallel.fleet.build_fleet_scene``.

The check judges sampled members cycle by cycle from the program's own
state: each cycle the reference evaluates the member's candidates from the
curvilinear state the program carried into that cycle, and judges the
program's answer (found, cost, rejection counts) and the state it carried
out of the cycle (the next curvilinear state, pose and speed) against the
candidate they match.  The control, the reference in the program's place,
gives its answers and states in the same form (``closed_loop``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from benchlib import inputs
from benchlib.judge import Judge, state_distance
from reference import path as ref_path
from reference import planner as ref_planner
from reference.scene import desired_speed, obstacles


class Base:
    def __init__(self, scenario, vtype, scn, pp, polyline, problem):
        self.scenario = scenario
        self.vtype = vtype
        self.scn = scn
        self.pp = pp
        self.polyline = polyline
        self.problem = problem


def build(config: dict, fleet_size: int, horizon_pad: int, seed: int,
          device):
    """(scene, carry, bases, members): the program's fleet and, per member,
    (base index, speed factor, lateral offset, desired-speed factor)."""
    from commonroad_rp_tpu_torch.parallel import fleet
    from commonroad_rp_tpu_torch.utils.config import VehicleConfiguration

    planner = config["planner"]
    n_steps = planner["planning"]["time_steps_computation"]
    bases = []
    for scenario in config["scenarios"]:
        scn, pp, polyline = inputs.load_scenario(scenario)
        for vtype in config["vehicle_types"]:
            problem = fleet.problem_from_planner_setup(
                scn, pp, polyline, n_steps=n_steps, horizon_pad=horizon_pad,
                vehicle=VehicleConfiguration(id_type_vehicle=vtype))
            bases.append(Base(scenario, vtype, scn, pp, polyline, problem))
    rng = np.random.default_rng(seed)
    problems, members = [], []
    for i in range(fleet_size):
        b = i % len(bases)
        v_f, d_off, ds_f = inputs.jitter(config, rng)
        p = dict(bases[b].problem)
        p["velocity"] = float(p["velocity"]) * v_f
        p["x0_lon"] = np.asarray(p["x0_lon"], np.float64).copy()
        p["x0_lon"][1] *= v_f
        p["x0_lat"] = np.asarray(p["x0_lat"], np.float64).copy()
        p["x0_lat"][0] += d_off
        p["desired_speed"] = float(p["desired_speed"]) * ds_f
        problems.append(p)
        members.append((b, v_f, d_off, ds_f))
    scene, carry = fleet.build_fleet_scene(problems, n_steps, device=device)
    return scene, carry, bases, members


def sample_members(members, n: int, seed: int) -> list:
    """``n`` members drawn from the seed, one of each base first."""
    rng = np.random.default_rng([seed, 2])
    by_base = {}
    for f, (b, *_) in enumerate(members):
        by_base.setdefault(b, []).append(f)
    chosen = [int(rng.choice(fs)) for _, fs in sorted(by_base.items())]
    rest = [f for f in range(len(members)) if f not in set(chosen)]
    extra = rng.choice(rest, size=max(0, min(n - len(chosen), len(rest))),
                       replace=False)
    return sorted(chosen + [int(f) for f in extra])


# columns of a member's state row: the curvilinear state, then the pose
LON, LAT, THETA, V, STEP, KAPPA, X, Y, DESIRED = (slice(0, 3), slice(3, 6), 6,
                                                  7, 8, 9, 10, 11, 12)
# the answer of a cycle, per member: (found, cost, x, y, theta, v,
# kinematically infeasible count, colliding count)
ANSWER = ("alive", "cost", "x", "y", "theta", "v", "n_kin", "n_coll")
# the fields of a candidate's step-1 state that the carry holds
CARRIED = (("s", LON, 0), ("s_dot", LON, 1), ("s_ddot", LON, 2),
           ("d", LAT, 0), ("d_dot", LAT, 1), ("d_ddot", LAT, 2),
           ("x", X, None), ("y", Y, None), ("theta_gl", THETA, None),
           ("v", V, None), ("kappa_gl", KAPPA, None))


class Evaluation(NamedTuple):
    masked: torch.Tensor        # [S, K] cost of each selectable candidate
    kin: torch.Tensor           # [S, K] +inf where kinematically infeasible
    states: dict                # [S, K, T] each
    best_cost: torch.Tensor     # [S]
    best: torch.Tensor          # [S]
    found: torch.Tensor         # [S]
    still: torch.Tensor         # [S] the standstill fallback applies


class Reference:
    """The plain reference of sampled members, in ``dtype``."""

    def __init__(self, config: dict, bases, members, sample, span: int,
                 device, dtype=torch.float64):
        planner = config["planner"]
        self.p = planner["planning"]
        self.s = planner["sampling"]
        self.level = int(config["fleet_level"])
        self.dt = self.p["dt"]
        self.n_steps = self.p["time_steps_computation"]
        self.horizon = self.dt * self.n_steps
        self.look = min(int(self.p["standstill_lookahead"]), self.n_steps)
        self.device = torch.device(device)
        self.dtype = dtype
        scenes = {}
        for b in sorted({members[f][0] for f in sample}):
            base = bases[b]
            scenes[b] = inputs.reference_scene(
                base.scn, base.polyline, config["vehicles"][str(base.vtype)],
                span)
        self.sample = sample
        self.batch = ref_planner.make_batch(
            [scenes[members[f][0]] for f in sample], dtype, self.device)
        rows = []
        for f in sample:
            b, v_f, d_off, ds_f = members[f]
            base, vehicle = bases[b], config["vehicles"][str(bases[b].vtype)]
            ist = base.pp.initial_state
            theta, v = float(ist.orientation), float(ist.velocity)
            wheelbase = vehicle["a"] + vehicle["b"]
            steer = float(np.arctan2(wheelbase * float(ist.yaw_rate or 0.0),
                                     v))
            rear = inputs.rear_axle(ist.position, theta, vehicle["b"])
            lon, lat = ref_path.initial_states(
                scenes[b]["tables"], rear, theta, v,
                float(ist.acceleration or 0.0), steer, wheelbase,
                v < self.p["low_vel_mode_threshold"])
            lon[1] *= v_f
            lat[0] += d_off
            rows.append(lon + lat + [theta, v * v_f, 0.0,
                                     math.tan(steer) / wheelbase, rear[0],
                                     rear[1], desired_speed(base.pp) * ds_f])
        self.start = torch.tensor(rows, dtype=dtype, device=self.device)

    def start_gap(self, start) -> float:
        """The largest gap between an initial curvilinear state [S, 6] (the
        program's, or the control's own) and the reference's."""
        ref = self.start[:, :6].double()
        return float(torch.max(torch.abs(start.double().to(ref.device)
                                         - ref)))

    def evaluate(self, state) -> Evaluation:
        """One cycle of the sampled members from ``state`` [S, 13]."""
        state = state.to(self.dtype)
        vel = state[:, V]
        v_min = torch.clamp(vel - 0.125 * self.horizon * self.batch.veh[:, 2],
                            min=0.0)
        v_max = torch.maximum(v_min + 5.0, vel + 2.0)
        low_vel = vel < self.p["low_vel_mode_threshold"]
        cl, ca, tl = ref_planner.grid(state[:, LON], state[:, LAT], v_min,
                                      v_max, low_vel, self.s, self.level,
                                      self.dt, self.horizon, unique_d=False)
        masked, kin, st = ref_planner.evaluate(
            self.batch, cl, ca, tl, state[:, THETA], low_vel,
            state[:, STEP].double().round().to(torch.int64),
            state[:, DESIRED], self.dt, self.n_steps)
        best_cost, best = torch.min(masked, dim=1)
        found = torch.isfinite(best_cost)
        rows = torch.arange(len(vel), device=self.device)
        still = (vel <= 0.05) & (~found | (st["v"][rows, best, self.look]
                                           <= 0.05))
        return Evaluation(masked, kin, st, best_cost, best, found, still)

    def counts(self, ev: Evaluation):
        """(kinematically infeasible [S], colliding [S]) candidates."""
        kin_inf = torch.isinf(ev.kin)
        return (torch.sum(kin_inf, 1),
                torch.sum(~kin_inf & torch.isinf(ev.masked), 1))


def judge_episode(judge: Judge, ref: Reference, states, answers):
    """Judge an episode of the sampled members.  ``states`` [C + 1, S, 13]:
    the state each member carried into each cycle (and out of the last);
    ``answers``: each of ``ANSWER`` [C, S].  A member is followed until the
    program or the reference finds no trajectory for it."""
    states = torch.as_tensor(states, dtype=torch.float64, device=ref.device)
    answers = {k: torch.as_tensor(np.asarray(a, dtype=np.float64),
                                  device=ref.device)
               for k, a in answers.items()}
    S = len(ref.sample)
    following = torch.ones(S, dtype=torch.bool, device=ref.device)
    for c in range(states.shape[0] - 1):
        if not bool(torch.any(following)):
            break
        state, nxt = states[c], states[c + 1]
        a = {k: v[c] for k, v in answers.items()}
        ev = ref.evaluate(state)
        n_kin, n_coll = ref.counts(ev)
        gap = torch.abs(n_kin - a["n_kin"]) + torch.abs(n_coll - a["n_coll"])
        judge.worst("count_gap", float(torch.max(torch.where(following, gap,
                                                             0))))
        alive = a["alive"] > 0.5
        ref_alive = ev.found | ev.still
        judge.count("found_mismatch", int(torch.sum(following
                                                    & (ref_alive != alive))))
        prog_still = alive & (a["cost"] == 0.0) & (a["v"] == 0.0)
        both = following & alive & ref_alive
        judge.count("found_mismatch", int(torch.sum(both & (ev.still
                                                            != prog_still))))
        # a standstill keeps the curvilinear state and the pose
        kept = both & ev.still & prog_still
        if bool(torch.any(kept)):
            judge.worst("state_gap", float(torch.max(torch.abs(
                nxt[kept][:, :6] - state[kept][:, :6]))))
        moving = both & ev.found & ~ev.still & ~prog_still
        for m in torch.nonzero(moving)[:, 0].tolist():
            cand = {k: ev.states[k][m] for k, *_ in CARRIED}
            carried = {k: [float(nxt[m, col] if i is None else
                                 nxt[m, col][i])] for k, col, i in CARRIED}
            answered = dict(x=[float(a["x"][m])], y=[float(a["y"][m])],
                            theta_gl=[float(a["theta"][m])],
                            v=[float(a["v"][m])])
            g = torch.maximum(state_distance(carried, cand, [1]),
                              state_distance(answered, cand, [1]))
            judge.candidate(g, ev.masked[m], ev.states["cost"][m],
                            torch.ones_like(g, dtype=torch.bool),
                            float(ev.best_cost[m]), float(a["cost"][m]))
        following = following & alive & ref_alive


def work_of_cycles(bases, members, K: int, T: int, cycles, span: int):
    """(operations, bytes) of scoring every member's candidates over
    ``cycles`` (each member at scenario step = cycle), counted by
    ``work/planning.py`` at the reference's own scene of each base."""
    from benchlib.core import load_module

    work = load_module("work", "planning")
    per_base = {}
    for b, base in enumerate(bases):
        tables = ref_path.tables(ref_path.prepare(base.polyline))
        per_base[b] = (len(tables.s), obstacles(base.scn, span).valid)
    count = np.bincount([b for b, *_ in members], minlength=len(bases))
    ops = nbytes = 0
    for c in cycles:
        for b, n in enumerate(count):
            if not n:
                continue
            P, valid = per_base[b]
            o, y = work.scoring(K, T, P, len(valid),
                                int(valid[:, c:c + T].sum()))
            ops, nbytes = ops + n * o, nbytes + n * y
    return ops, nbytes


def closed_loop(ref: Reference, cycles: int):
    """The reference put in the program's place, in its own dtype: each
    sampled member driven by its own choices for ``cycles`` cycles.
    Returns (states [C + 1, S, 13], answers), as ``judge_episode`` takes
    them."""
    S = len(ref.sample)
    state = ref.start.clone()
    alive = torch.ones(S, dtype=torch.bool, device=ref.device)
    rows = torch.arange(S, device=ref.device)
    states = [state]
    out = {k: [] for k in ANSWER}
    for _ in range(cycles):
        ev = ref.evaluate(state)
        step_alive = alive & (ev.found | ev.still)
        pick = lambda k: ev.states[k][rows, ev.best, 1]
        new = state.clone()
        for k, col, i in CARRIED:
            if i is None:
                new[:, col] = pick(k)
            else:
                new[:, col][:, i] = pick(k)
        new[ev.still] = state[ev.still]
        new[ev.still, V] = 0.0
        new[:, STEP] = state[:, STEP] + 1
        state = torch.where(step_alive[:, None], new, state)
        cost = torch.where(ev.still, torch.zeros_like(ev.best_cost),
                           ev.best_cost)
        values = (step_alive, torch.where(step_alive, cost, math.inf),
                  state[:, X], state[:, Y], state[:, THETA], state[:, V],
                  *ref.counts(ev))
        for k, value in zip(ANSWER, values):
            out[k].append(value.double().cpu().numpy())
        states.append(state)
        alive = step_alive
    return (torch.stack(states).double(),
            {k: np.stack(v) for k, v in out.items()})
