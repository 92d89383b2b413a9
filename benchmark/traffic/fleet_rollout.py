"""Fleet replanning through the dense XLA fleet path, captured.

``params``: ``fleet_size`` problems (each with its own vehicle) at
replanning offset 1, ``cycles`` cycles a call, episodes of ``episode``
cycles.  A tick is one call of the captured rollout
(``parallel.fleet.make_fleet_rollout``: one captured cycle replayed
``cycles`` times, every candidate of every problem rolled out and checked
densely), the carry chained from call to call and restarted from the
seed's initial fleet after every episode; each call's metrics are read back
to the host.

The check runs one episode more through the same program, reading the
sampled members' carry after every cycle through the program's public
per-cycle read (``ScanProgram``'s ``observe``), and judges each cycle from
the state the program carried into it.  The XLA path reports no rejection
counts, so ``count_gap`` is not among the cell's limits.
"""

from __future__ import annotations

import inspect

import numpy as np
import torch

from benchlib import fleet as fleet_lib
from benchlib.core import load_module
from benchlib.driver import DriverBase
from benchlib.judge import Judge


class Driver(DriverBase):
    def __init__(self, cell_name, cell, config, seed, device):
        super().__init__(cell_name, cell, config, seed, device)
        from commonroad_rp_tpu_torch.ops import grid
        from commonroad_rp_tpu_torch.ops.program import ScanProgram
        from commonroad_rp_tpu_torch.parallel import fleet

        if "observe" not in inspect.signature(ScanProgram.__call__).parameters:
            raise SystemExit("the program's ScanProgram has no per-cycle read "
                             "of its carry (observe): this cell cannot be "
                             "checked")
        self.cycles = int(self.params["cycles"])
        self.episode = int(self.params["episode"])
        if self.episode % self.cycles:
            raise ValueError("an episode must be a whole number of calls")
        self.fleet_size = int(self.params["fleet_size"])
        self.scene, self.start, self.bases, self.members = fleet_lib.build(
            config, self.fleet_size, self.episode + 10, self.seed, device)
        p = config["planner"]["planning"]
        s = config["planner"]["sampling"]
        self.n_steps = p["time_steps_computation"]
        dt = p["dt"]
        static_grid = grid.make_static_grid(
            int(config["fleet_level"]), s["t_min"], self.n_steps * dt, dt,
            s["d_min"], s["d_max"], s["num_sampling_levels"])
        self.K = static_grid.size
        self.run = fleet.make_fleet_rollout(
            None, None, static_grid, dt, self.n_steps, replan_offset=1,
            low_vel_threshold=p["low_vel_mode_threshold"],
            horizon=self.n_steps * dt, n_cycles=self.cycles, device=device)
        self.carry = self.start
        self.done = 0             # cycles of the current episode
        self.offsets = []         # each tick's first cycle in its episode
        self.window = {}          # episode offset -> that call's metrics
        self.counted = {}         # units -> the program's cycle counter

    def warm(self):
        self.tick()
        self.units = 0
        self.attempted = self.no_trajectory = 0
        self.carry, self.done = self.start, 0
        self.offsets, self.window = [], {}

    def tick(self):
        if self.done == self.episode:
            self.carry, self.done = self.start, 0
        self.carry, metrics = self.run(self.carry, self.scene)
        host = [m.cpu().numpy() for m in metrics]
        self.window[self.done] = host
        self.offsets.append(self.done)
        self.done += self.cycles
        self.units += 1
        self.attempted += self.fleet_size * self.cycles
        self.no_trajectory += int(np.sum(~host[0]))

    def mark(self) -> int:
        from commonroad_rp_tpu_torch.utils import profiling

        self.counted[self.units] = profiling.counters().get(
            "scan_program.cycles")
        return self.units

    def end_to_end(self, window_s: float) -> dict:
        return {"replans_per_s":
                self.units * self.cycles * self.fleet_size / window_s}

    def layer_record(self) -> dict:
        first, last = self.traced
        cycles = [o + i for o in self.offsets[first:last]
                  for i in range(self.cycles)]
        a, b = self.counted.get(first), self.counted.get(last)
        span = int(self.params["obstacle_span"])
        T = self.n_steps + 1
        return dict(
            units=last - first, cycles=len(cycles),
            program_cycles=None if a is None or b is None else b - a,
            scoring_work=fleet_lib.work_of_cycles(
                self.bases, self.members, self.K, T, cycles, span),
            collision_work=load_module("work", "collision").of_cycles(
                self.bases, self.members, self.K, T, cycles, span))

    # -- the check -------------------------------------------------------

    def reference(self, dtype=torch.float64):
        sample = fleet_lib.sample_members(
            self.members, int(self.params["check_members"]), self.seed)
        return fleet_lib.Reference(self.config, self.bases, self.members,
                                   sample, int(self.params["obstacle_span"]),
                                   self.device, dtype)

    def observe(self, sample):
        """One more episode of the program from the seed's carry, the
        sampled members' carry read after every cycle: (states [C + 1, S,
        12] on the device, answers), as ``judge_episode`` takes them but for
        the desired speed, which the carry does not hold."""
        idx = torch.tensor(sample, device=self.start.x0_lon.device)
        rows = []

        def read(carry):
            rows.append(torch.cat([
                carry.x0_lon[idx], carry.x0_lat[idx],
                torch.stack([carry.orientation[idx], carry.velocity[idx],
                             carry.time_step[idx].to(carry.px.dtype),
                             carry.kappa[idx], carry.px[idx],
                             carry.py[idx]], dim=1)], dim=1).double())

        read(self.start)
        carry, calls = self.start, []
        for _ in range(self.episode // self.cycles):
            carry, metrics = self.run(carry, self.scene, observe=read)
            calls.append([m.cpu().numpy() for m in metrics])
        return torch.stack(rows), self.answers(
            [np.concatenate(parts) for parts in zip(*calls)], sample)

    @staticmethod
    def answers(metrics, sample) -> dict:
        """The rollout's metrics (``CycleMetrics`` fields, host arrays
        [C, F]) of the sampled members, as ``ANSWER``; no rejection
        counts."""
        found, cost, x, y = metrics[:4]
        theta, v = metrics[6:8]
        out = {k: np.asarray(a)[:, sample].astype(np.float64) for k, a in
               zip(("alive", "cost", "x", "y", "theta", "v"),
                   (found, cost, x, y, theta, v))}
        for k in ("n_kin", "n_coll"):
            out[k] = np.full_like(out["cost"], np.nan)
        return out

    def control(self, dtype):
        """The reference in the program's place in ``dtype``: the sampled
        members' states and answers over one episode."""
        return fleet_lib.closed_loop(self.reference(dtype), self.episode)

    def check(self, control=None):
        """Judge an episode of the sampled members: the program's, or
        ``control``'s.  The program's episode is run once more with its
        carry read after every cycle, and its answers must be the window's
        at every cycle the window ran: a gap counts under the number of its
        kind."""
        judge = Judge()
        ref = self.reference()
        if control is None:
            states, answers = self.observe(ref.sample)
            if self.window:
                done = sorted(self.window)
                at = np.concatenate([np.arange(o, o + self.cycles)
                                     for o in done])
                window = self.answers([np.concatenate(parts) for parts in zip(
                    *(self.window[o] for o in done))], ref.sample)
                load_module("traffic", "fleet_scan").Driver.match_window(
                    judge, {k: a[at] for k, a in answers.items()}, window)
        else:
            states, answers = control
        desired = ref.start[:, fleet_lib.DESIRED].to(states.device)
        states = torch.cat([states, desired.expand(states.shape[0], -1)
                            [..., None].to(states.dtype)], dim=2)
        judge.worst("start_gap", ref.start_gap(states[0, :, :6]))
        fleet_lib.judge_episode(judge, ref, states, answers)
        return judge.result(self.cell["limits"])
