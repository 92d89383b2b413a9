"""Faults planted underneath the timed path, for the checks that
``correct`` comes out false (``tests/test_bench_control.py``,
``control.py --fault``).

``plan_loop``: ``unchanged`` (``plan()`` returns the previous call's
answer), ``altered`` (every answer's positions moved by 0.5 m).
``fleet_scan``, planted in the scan's cycle before it is captured:
``unchanged`` (the cycle returns its carry unchanged), ``half`` (every
second member left out), ``altered`` (every member's position moved by
0.5 m where the cycle produces it), ``scorer`` (the fleet scorer built
with twice the acceleration weight of its cost).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

KINDS = {"plan_loop": ("unchanged", "altered"),
         "fleet_scan": ("unchanged", "half", "altered", "scorer")}


@contextlib.contextmanager
def planted(traffic: str, kind: str):
    """While open, runs of ``traffic`` are broken by ``kind``.  Yields the
    ``driver_hook`` that ``core.run_cell`` takes (None where the fault sits
    in the program's build)."""
    if kind not in KINDS[traffic]:
        raise ValueError(f"no fault {kind!r} for {traffic}")
    if traffic == "plan_loop":
        yield _plan_hook(kind)
        return
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


def _plan_hook(kind):
    def hook(driver):
        for drive in driver.drives:
            plan = drive.planner.plan
            last = {}

            def broken(*args, _plan=plan, _last=last, **kwargs):
                optimal = _plan(*args, **kwargs)
                if optimal is None:
                    return optimal
                if kind == "unchanged" and "prev" in _last:
                    stale = _last["prev"]
                    _last["prev"] = optimal
                    return stale
                _last["prev"] = optimal
                if kind == "altered":
                    for state in optimal[0].state_list:
                        state.position = state.position + np.array([0.5, 0.0])
                return optimal

            drive.planner.plan = broken
    return hook
