"""Fleet replanning through the fused fleet scan, captured.

``params``: ``fleet_size`` problems, episodes of ``cycles`` cycles at
replanning offset 1.  A tick is one episode from the initial carry of the
seed's fleet (``parallel.replanning_scan.make_fleet_scan``, one captured
cycle replayed ``cycles`` times), its metrics read back to the host.
"""

from __future__ import annotations

import numpy as np
import torch

from benchlib import fleet as fleet_lib
from benchlib.driver import DriverBase
from benchlib.judge import Judge


class Driver(DriverBase):
    def __init__(self, cell_name, cell, config, seed, device):
        super().__init__(cell_name, cell, config, seed, device)
        from commonroad_rp_tpu_torch.ops import grid
        from commonroad_rp_tpu_torch.parallel import replanning_scan

        self.cycles = int(self.params["cycles"])
        self.fleet_size = int(self.params["fleet_size"])
        self.scene, self.carry, self.bases, self.members = fleet_lib.build(
            config, self.fleet_size, self.cycles + 10, self.seed, device)
        p = config["planner"]["planning"]
        s = config["planner"]["sampling"]
        self.n_steps = p["time_steps_computation"]
        dt = p["dt"]
        static_grid = grid.make_static_grid(
            int(config["fleet_level"]), s["t_min"], self.n_steps * dt, dt,
            s["d_min"], s["d_max"], s["num_sampling_levels"])
        self.K = static_grid.size
        self.run = replanning_scan.make_fleet_scan(
            self.scene, static_grid, dt, self.n_steps, replan_offset=1,
            low_vel_threshold=p["low_vel_mode_threshold"],
            horizon=self.n_steps * dt, n_cycles=self.cycles)
        self.metrics = None

    def warm(self):
        self.tick()
        self.units = 0
        self.attempted = self.no_trajectory = 0

    def tick(self):
        _, metrics = self.run(self.carry)
        self.metrics = [m.cpu().numpy() for m in metrics]
        self.units += 1
        self.attempted += self.fleet_size * self.cycles
        self.no_trajectory += int(np.sum(~self.metrics[0]))

    def end_to_end(self, window_s: float) -> dict:
        return {"replans_per_s":
                self.units * self.cycles * self.fleet_size / window_s}

    def layer_record(self) -> dict:
        first, last = self.traced
        cycles = list(range(self.cycles)) * (last - first)
        return dict(units=last - first, cycles=len(cycles),
                    scoring_work=fleet_lib.work_of_cycles(
                        self.bases, self.members, self.K, self.n_steps + 1,
                        cycles, int(self.params["obstacle_span"])))

    # -- the check -------------------------------------------------------

    def reference(self, dtype=torch.float64):
        sample = fleet_lib.sample_members(
            self.members, int(self.params["check_members"]), self.seed)
        return fleet_lib.Reference(self.config, self.bases, self.members,
                                   sample, int(self.params["obstacle_span"]),
                                   self.device, dtype)

    def observe(self, sample):
        """One more episode of the program from the seed's carry, the
        sampled members' carry read after every replayed cycle: (states
        [C + 1, S, 12] on the device, answers), as ``judge_episode`` takes
        them but for the desired speed, which the carry does not hold."""
        from commonroad_rp_tpu_torch.parallel.fleet import FleetCarry

        run = self.run
        step = run._program
        idx = torch.tensor(sample, device=self.carry.x0_lon.device)
        rows = []

        def read(carry):
            rows.append(torch.cat([
                carry.x0_lon[idx], carry.x0_lat[idx],
                torch.stack([carry.orientation[idx], carry.velocity[idx],
                             carry.time_step[idx].to(carry.px.dtype),
                             carry.kappa[idx], carry.px[idx],
                             carry.py[idx]], dim=1)], dim=1).double())

        class Observed:
            """The program's captured cycle, its carry read after each
            replay (the carry's static buffers hold the next cycle's)."""

            def capture(self):
                return step.capture()

            def __call__(self):
                out = step()
                read(FleetCarry(*run._carry.value))
                return out

        read(self.carry)
        run._program = Observed()
        try:
            _, metrics = run(self.carry)
        finally:
            run._program = step
        return torch.stack(rows), self.answers(metrics, sample)

    @staticmethod
    def answers(metrics, sample) -> dict:
        """The scan's metrics of the sampled members, as ``ANSWER``."""
        order = (0, 1, 2, 3, 8, 9, 6, 7)
        return {k: np.asarray(metrics[i].cpu().numpy()
                              if torch.is_tensor(metrics[i])
                              else metrics[i])[:, sample].astype(np.float64)
                for k, i in zip(fleet_lib.ANSWER, order)}

    def control(self, dtype):
        """The reference in the program's place in ``dtype``: the sampled
        members' states and answers."""
        return fleet_lib.closed_loop(self.reference(dtype), self.cycles)

    def check(self, control=None):
        """Judge an episode of the sampled members: the program's, or
        ``control``'s.  The program's episode is run once more with its
        carry read after every cycle, and its answers must be the window's
        last episode's: a gap counts under the number of its kind."""
        judge = Judge()
        ref = self.reference()
        if control is None:
            states, answers = self.observe(ref.sample)
            window = self.answers(self.metrics, ref.sample)
            self.match_window(judge, answers, window)
        else:
            states, answers = control
        desired = ref.start[:, fleet_lib.DESIRED].to(states.device)
        states = torch.cat([states, desired.expand(states.shape[0], -1)
                            [..., None].to(states.dtype)], dim=2)
        judge.worst("start_gap", ref.start_gap(states[0, :, :6]))
        fleet_lib.judge_episode(judge, ref, states, answers)
        return judge.result(self.cell["limits"])

    @staticmethod
    def match_window(judge: Judge, observed: dict, window: dict):
        judge.count("found_mismatch", int(np.sum(
            (observed["alive"] > 0.5) != (window["alive"] > 0.5))))
        both = (observed["alive"] > 0.5) & (window["alive"] > 0.5)
        pose = max(float(np.max(np.abs(observed[k] - window[k])[both],
                                initial=0.0)) for k in ("x", "y", "v"))
        turn = np.abs(np.remainder(observed["theta"] - window["theta"]
                                   + np.pi, 2 * np.pi) - np.pi)
        judge.worst("state_gap", max(pose, float(np.max(turn[both],
                                                        initial=0.0))))
        judge.worst("cost_err", float(np.max(
            np.abs(observed["cost"] - window["cost"])[both]
            / np.maximum(np.abs(window["cost"][both]), 1.0), initial=0.0)))
        judge.worst("count_gap", float(np.max(
            np.abs(observed["n_kin"] - window["n_kin"])
            + np.abs(observed["n_coll"] - window["n_coll"]), initial=0.0)))
