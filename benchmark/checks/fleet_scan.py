"""The harness's own checks of the ``fleet_scan`` traffic kind
(``traffic/fleet_scan.py``): its tiny CPU case and the faults planted
underneath its timed path (``benchlib/faults.py`` loads this file by the
kind's name).

Planted in the scan's cycle before it is captured: ``unchanged`` (the
cycle returns its carry unchanged), ``half`` (every second member left
out), ``altered`` (every member's position moved by 0.5 m where the cycle
produces it), ``scorer`` (the fleet scorer built with twice the
acceleration weight of its cost).
"""

from __future__ import annotations

import contextlib

import torch

# the cell's params for a tiny run on the CPU
TINY = {"fleet_size": 12, "cycles": 3, "check_members": 12}

# fault -> (params over TINY, window seconds) of its broken-path test.
# ``half`` samples enough members that half of them exceed the limit on
# answers where only one side finds a trajectory.
FAULTS = {"unchanged": ({}, 0.5),
          "half": ({"fleet_size": 36, "check_members": 36, "cycles": 2}, 0.5),
          "altered": ({}, 0.5),
          "scorer": ({}, 0.5)}


@contextlib.contextmanager
def planted(kind: str):
    """While open, every fused fleet scan built is broken by ``kind``.
    Yields the ``driver_hook`` that ``core.run_cell`` takes: None, since
    the fault sits in the program's build."""
    from commonroad_rp_tpu_torch.parallel import replanning_scan

    original = replanning_scan.make_fleet_scan

    def broken_build(*args, **kwargs):
        if kind == "scorer":
            kwargs["w_a"] = 2.0 * kwargs.get("w_a", 5.0)
            return original(*args, **kwargs)
        program = original(*args, **kwargs)
        program.cycle = _broken_cycle(program.cycle, kind)
        return program

    replanning_scan.make_fleet_scan = broken_build
    try:
        yield None
    finally:
        replanning_scan.make_fleet_scan = original


def _broken_cycle(cycle, kind):
    def broken(carry):
        new, metrics = cycle(carry)
        metrics = list(metrics)
        if kind == "unchanged":
            new = carry
            metrics[2], metrics[3] = carry.px, carry.py
            metrics[8], metrics[9] = carry.orientation, carry.velocity
        elif kind == "half":
            odd = torch.arange(len(new.alive), device=new.alive.device) % 2
            alive = new.alive & (odd == 0)
            new = new._replace(alive=alive)
            metrics[0] = alive
        elif kind == "altered":
            new = new._replace(px=new.px + 0.5)
            metrics[2] = new.px
        return new, tuple(metrics)
    return broken
