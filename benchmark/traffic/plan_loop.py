"""Closed-loop online replanning through ``ReactivePlanner.plan()``.

One drive per scenario of the configuration, each from its jittered start
toward its goal; a tick is one ``plan()`` call of the next drive in turn
(round-robin), followed by the ``replanning_frequency`` steps along the
returned trajectory (the upstream run script's loop).  A drive that
reaches its goal, finds no trajectory, or has planned ``max_cycles``
times starts again from its start.  Set-up drives each scenario once, so
that every level program the window needs is built and captured before it.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from benchlib import inputs
from benchlib.core import load_module
from benchlib.driver import DriverBase
from benchlib.judge import Judge, state_distance
from reference import path as ref_path
from reference import planner as ref_planner


work = load_module("work", "planning")


class Drive:
    def __init__(self, index, scenario, settings, planner, start, desired,
                 scn, polyline, vehicle, ist):
        self.index = index
        self.scenario = scenario
        self.settings = settings
        self.planner = planner
        self.start = start
        self.desired = desired
        self.scn = scn
        self.polyline = polyline
        self.vehicle = vehicle
        self.initial = ist
        self.cycles = 0
        self.low_vel_at_start = False


def grid_size(settings: dict, levels, x0_lat0: float) -> int:
    """Candidates of the fused levels of one ``plan()`` call."""
    s, p = settings["sampling"], settings["planning"]
    horizon = p["dt"] * p["time_steps_computation"]
    total = 0
    for level in levels:
        n = ref_planner.ladder(level)
        d = np.unique(np.linspace(s["d_min"], s["d_max"], n))
        nd = len(np.unique(np.concatenate([d, [x0_lat0]])))
        nt = len(ref_planner.time_samples(s["t_min"], horizon, p["dt"], level))
        total += nt * n * nd
    return total


class Driver(DriverBase):
    def __init__(self, cell_name, cell, config, seed, device):
        super().__init__(cell_name, cell, config, seed, device)
        from commonroad_rp_tpu_torch.models.planner import ReactivePlanner

        rng = np.random.default_rng(self.seed)
        self.drives = []
        for i, scenario in enumerate(config["scenarios"]):
            settings = inputs.scenario_settings(config, scenario)
            scn, pp, polyline = inputs.load_scenario(scenario)
            v_f, d_off, ds_f = inputs.jitter(config, rng)
            ist = pp.initial_state
            theta = float(ist.orientation)
            ist.position = np.asarray(ist.position, dtype=np.float64) + \
                d_off * np.array([-math.sin(theta), math.cos(theta)])
            from reference.scene import desired_speed
            desired = desired_speed(pp) * ds_f
            ist.velocity = float(ist.velocity) * v_f
            vtype = settings["vehicle_type"]
            port_cfg = inputs.port_config(scenario, settings, vtype, scn, pp)
            planner = ReactivePlanner(port_cfg, device=device)
            planner.set_reference_path(polyline)
            self.drives.append(Drive(i, scenario, settings, planner,
                                     planner.x_0, desired, scn, polyline,
                                     config["vehicles"][str(vtype)], ist))
        self.turn = 0
        self.plan_ms = []
        self.host_ms = []
        self.level_ms = []
        self.grid_k = []
        self.sample = []
        self.starts = {}
        self.n_check = int(self.params["check_calls"])
        self.sample_rng = np.random.default_rng([self.seed, 1])
        self.recording = False

    # -- the loop --------------------------------------------------------

    def warm(self):
        """Every drive once from its start to its end: builds and captures
        the level programs of every signature the window meets."""
        for drive in self.drives:
            while True:
                if self._step(drive):
                    break
        self.plan_ms.clear()
        self.host_ms.clear()
        self.level_ms.clear()
        self.grid_k.clear()
        self.units = 0
        self.attempted = self.no_trajectory = 0
        self.recording = True

    def tick(self):
        drive = self.drives[self.turn % len(self.drives)]
        self.turn += 1
        self._step(drive)
        self.units += 1

    def _step(self, drive: Drive) -> bool:
        """One ``plan()`` call of ``drive`` and the steps along its answer;
        True when the drive started again from its start."""
        planner = drive.planner
        first = drive.cycles == 0
        planner.set_desired_velocity(desired_velocity=drive.desired,
                                     current_speed=planner.x_0.velocity)
        t0 = time.perf_counter()
        optimal = planner.plan()
        elapsed = time.perf_counter() - t0
        if self.recording:
            self._record(drive, first, optimal, elapsed)
        drive.cycles += 1
        low_vel = planner.x_0.velocity < \
            drive.settings["planning"]["low_vel_mode_threshold"]
        done = optimal is None
        if not done:
            freq = drive.settings["planning"]["replanning_frequency"]
            for offset in range(1, freq + 1):
                planner.reset(initial_state_cart=optimal[0].state_list[offset],
                              initial_state_curv=(optimal[2][offset],
                                                  optimal[3][offset]),
                              collision_checker=planner.collision_checker,
                              coordinate_system=planner.coordinate_system)
                if planner.goal_reached():
                    done = True
                    break
        if done or drive.cycles >= int(self.params["max_cycles"]):
            planner.reset(initial_state_cart=drive.start.copy(),
                          collision_checker=planner.collision_checker,
                          coordinate_system=planner.coordinate_system)
            drive.cycles = 0
            drive.low_vel_at_start = low_vel
            return True
        return False

    def _record(self, drive, first, optimal, elapsed):
        planner = drive.planner
        self.attempted += 1
        self.no_trajectory += optimal is None
        self.plan_ms.append(elapsed * 1e3)
        total = planner.planning_times[-1]
        device = planner.stage_timers.history["device_cycle"][-1]
        self.host_ms.append((total - device) * 1e3)
        self.level_ms.append(device * 1e3)
        x0_lon, x0_lat = planner.x_0_cl
        self.grid_k.append((drive.index, float(x0_lat[0]),
                            int(planner.x_0.time_step)))
        keep_start = first and drive.index not in self.starts
        n_seen = len(self.plan_ms)
        slot = None
        if len(self.sample) < self.n_check:
            slot = len(self.sample)
        else:
            j = int(self.sample_rng.integers(0, n_seen))
            if j < self.n_check:
                slot = j
        if slot is None and not keep_start:
            return
        x0 = planner.x_0
        record = dict(drive=drive.index, x0_lon=[float(v) for v in x0_lon],
                      x0_lat=[float(v) for v in x0_lat],
                      theta=float(x0.orientation), v=float(x0.velocity),
                      time_step=int(x0.time_step),
                      answer=self.answer_of(planner, optimal))
        if keep_start:
            self.starts[drive.index] = dict(record,
                                            low_vel=drive.low_vel_at_start)
        if slot is not None:
            if slot == len(self.sample):
                self.sample.append(record)
            else:
                self.sample[slot] = record

    @staticmethod
    def answer_of(planner, optimal) -> dict:
        answer = dict(found=optimal is not None,
                      n_kin=int(planner.infeasible_count_kinematics),
                      n_coll=int(planner.infeasible_count_collision))
        if optimal is None:
            return answer
        states = optimal[0].state_list
        answer["cost"] = float(planner.optimal_cost)
        answer["arrays"] = dict(
            x=[float(s.position[0]) for s in states],
            y=[float(s.position[1]) for s in states],
            theta_gl=[float(s.orientation) for s in states],
            v=[float(s.velocity) for s in states],
            s=[float(v[0]) for v in optimal[2]],
            d=[float(v[0]) for v in optimal[3]])
        answer["standstill"] = answer["cost"] == 0.0 and \
            all(v == 0.0 for v in answer["arrays"]["v"])
        return answer

    @staticmethod
    def levels(drive: Drive):
        return list(range(1, drive.settings["sampling"]["num_sampling_levels"]))

    # -- results ---------------------------------------------------------

    def end_to_end(self, window_s: float) -> dict:
        from benchlib.core import percentile

        return {"plan_ms.p50": percentile(self.plan_ms, 50),
                "plan_ms.p95": percentile(self.plan_ms, 95)}

    def layer_record(self) -> dict:
        first, last = self.traced
        ops = nbytes = 0
        for index, x0_lat0, step in self.grid_k[first:last]:
            drive = self.drives[index]
            k = grid_size(drive.settings, self.levels(drive), x0_lat0)
            T = drive.settings["planning"]["time_steps_computation"] + 1
            scene = self._scenes()[index]
            valid = scene["obstacles"].valid
            o, b = work.scoring(k, T, len(scene["tables"].s), len(valid),
                                int(valid[:, step:step + T].sum()))
            ops, nbytes = ops + o, nbytes + b
        return dict(host_ms=self.host_ms, level_ms=self.level_ms,
                    plan_ms=self.plan_ms, units=last - first,
                    scoring_work=(ops, nbytes))

    # -- the check -------------------------------------------------------

    def _scenes(self):
        if not hasattr(self, "_scene_cache"):
            span = int(self.params["obstacle_span"])
            self._scene_cache = [inputs.reference_scene(
                d.scn, d.polyline, d.vehicle, span) for d in self.drives]
        return self._scene_cache

    def evaluate(self, record: dict, dtype=torch.float64):
        """The reference's evaluation of one recorded call: (masked, kin,
        states, level ids, selection) of the union of its levels."""
        drive = self.drives[record["drive"]]
        dev = torch.device(self.device)
        batch = ref_planner.make_batch([self._scenes()[drive.index]], dtype,
                                       dev)
        p, s = drive.settings["planning"], drive.settings["sampling"]
        horizon = p["dt"] * p["time_steps_computation"]
        t = lambda x: torch.tensor([x], dtype=dtype, device=dev)
        x0_lon = torch.tensor([record["x0_lon"]], dtype=dtype, device=dev)
        x0_lat = torch.tensor([record["x0_lat"]], dtype=dtype, device=dev)
        v = record["v"]
        a_max = drive.vehicle["a_max"]
        v_min = max(0.0, v - 0.125 * horizon * a_max)
        v_max = max(v_min + 5.0, v + 2.0)
        low_vel = torch.tensor([v < p["low_vel_mode_threshold"]], device=dev)
        parts, ids = [], []
        levels = self.levels(drive)
        for j, level in enumerate(levels):
            cl, ca, tl = ref_planner.grid(x0_lon, x0_lat, t(v_min), t(v_max),
                                          low_vel, s, level, p["dt"],
                                          horizon, unique_d=True)
            parts.append((cl, ca, tl))
            ids.append(torch.full((cl.shape[1],), j, device=dev))
        cl, ca, tl = (torch.cat([q[i] for q in parts], dim=1)
                      for i in range(3))
        level_ids = torch.cat(ids)
        masked, kin, states = ref_planner.evaluate(
            batch, cl, ca, tl, t(record["theta"]), low_vel,
            torch.tensor([record["time_step"]], device=dev),
            t(self.drives[record["drive"]].desired), p["dt"],
            p["time_steps_computation"])
        sel = ref_planner.select(masked, kin, level_ids, len(levels))
        return masked, kin, states, level_ids, sel

    def reference_answer(self, record: dict, dtype=torch.float64):
        """The reference's answer to one recorded call, as ``answer_of``
        gives the program's, and its evaluation (masked, states, level
        ids, selected level, best cost)."""
        masked, kin, states, level_ids, sel = self.evaluate(record, dtype)
        found, best, best_cost, level, n_kin, n_coll = (x[0] for x in sel)
        drive = self.drives[record["drive"]]
        look = drive.settings["planning"]["standstill_lookahead"]
        still = record["v"] <= 0.05 and (
            not bool(found) or float(states["v"][0, int(best), look]) <= 0.05)
        answer = dict(found=bool(found) or still, n_kin=int(n_kin),
                      n_coll=int(n_coll), standstill=still)
        if still:
            answer["cost"] = 0.0
        elif bool(found):
            answer.update(cost=float(best_cost), arrays={
                k: list(states[k][0, int(best)].double().cpu().numpy())
                for k in ("x", "y", "theta_gl", "v", "s", "d")})
        return answer, (masked, states, level_ids, level, best_cost)

    def control(self, dtype):
        """The reference in the program's place in ``dtype``: its answers
        to the sampled calls."""
        return [self.reference_answer(r, dtype)[0] for r in self.sample]

    def check(self, answers=None):
        """Judge the sampled calls (and each drive's first call's start
        state) against the reference.  ``answers`` replaces the program's
        answers (the control)."""
        judge = Judge()
        for i, record in enumerate(self.sample):
            answer = record["answer"] if answers is None else answers[i]
            self.judge_call(judge, record, answer)
        for index, record in self.starts.items():
            drive = self.drives[index]
            ist = drive.initial
            wb = drive.vehicle["b"]
            wheelbase = drive.vehicle["a"] + wb
            theta = float(ist.orientation)
            v = float(ist.velocity)
            yaw = float(ist.yaw_rate or 0.0)
            lon, lat = ref_path.initial_states(
                self._scenes()[index]["tables"],
                inputs.rear_axle(ist.position, theta, wb), theta, v,
                float(ist.acceleration or 0.0),
                float(np.arctan2(wheelbase * yaw, v)), wheelbase,
                record["low_vel"])
            start = np.array(record["x0_lon"] + record["x0_lat"])
            if answers is not None:
                # the control computes the start in its own precision
                start = torch.tensor(lon + lat, dtype=torch.float64).to(
                    torch.bfloat16).double().numpy()
            judge.worst("start_gap", np.max(np.abs(np.array(lon + lat)
                                                   - start)))
        return judge.result(self.cell["limits"])

    def judge_call(self, judge: Judge, record: dict, answer: dict):
        ref, (masked, states, level_ids, level, best_cost) = \
            self.reference_answer(record)
        judge.worst("count_gap", abs(ref["n_kin"] - answer["n_kin"])
                    + abs(ref["n_coll"] - answer["n_coll"]))
        prog_still = answer["found"] and answer.get("standstill", False)
        if ref["standstill"] or prog_still:
            judge.count("found_mismatch", int(ref["standstill"] != prog_still))
            return
        if ref["found"] != answer["found"]:
            judge.count("found_mismatch")
            return
        if not answer["found"]:
            return
        arrays = answer["arrays"]
        n = len(arrays["x"])
        cand = {k: states[k][0] for k in ("x", "y", "theta_gl", "v", "s", "d")}
        gap = state_distance(arrays, cand, list(range(n)))
        judge.candidate(gap, masked[0], states["cost"][0], level_ids == level,
                        float(best_cost), answer["cost"])
