"""The harness's own checks of the ``fleet_rollout`` traffic kind
(``traffic/fleet_rollout.py``): its tiny CPU case and the faults planted
underneath its timed path (``benchlib/faults.py`` loads this file by the
kind's name).

Planted in the XLA fleet step before the rollout is built and captured:
``unchanged`` (the step returns its carry unchanged), ``half`` (every
second member left out), ``altered`` (every member's position moved by
0.5 m where the step produces it), ``padded_end`` (each route's end read
from the padded table's last row again, so that members plan past their
route's true end into the padding's unbounded corridor).
"""

from __future__ import annotations

import contextlib

import torch

# the cell's params for a tiny run on the CPU
TINY = {"fleet_size": 12, "cycles": 2, "episode": 4, "check_members": 12}

# fault -> (params over TINY, window seconds) of its broken-path test.
# ``half`` samples enough members that half of them exceed the limit on
# answers where only one side finds a trajectory; ``padded_end`` drives a
# whole episode, in which members reach their route's end.
FAULTS = {"unchanged": ({}, 0.5),
          "half": ({"fleet_size": 36, "check_members": 36}, 0.5),
          "altered": ({}, 0.5),
          "padded_end": ({"cycles": 10, "episode": 150}, 0.5)}


@contextlib.contextmanager
def planted(kind: str):
    """While open, every XLA fleet rollout built is broken by ``kind``.
    Yields the ``driver_hook`` that ``core.run_cell`` takes: None, since
    the fault sits in the program's build."""
    from commonroad_rp_tpu_torch.parallel import fleet

    if kind == "padded_end":
        name, broken = "true_path_lengths", lambda ref_s: ref_s[:, -1]
    else:
        original_step = fleet.make_fleet_step
        name = "make_fleet_step"

        def broken(*args, **kwargs):
            return _broken_step(original_step(*args, **kwargs), kind)
    original = getattr(fleet, name)
    setattr(fleet, name, broken)
    try:
        yield None
    finally:
        setattr(fleet, name, original)


def _broken_step(step, kind):
    def broken(carry, scene):
        new, metrics = step(carry, scene)
        if kind == "unchanged":
            new = carry
            metrics = metrics._replace(x=carry.px, y=carry.py,
                                       orientation=carry.orientation,
                                       velocity=carry.velocity)
        elif kind == "half":
            odd = torch.arange(len(new.alive), device=new.alive.device) % 2
            alive = new.alive & (odd == 0)
            new = new._replace(alive=alive)
            metrics = metrics._replace(found=alive)
        elif kind == "altered":
            new = new._replace(px=new.px + 0.5)
            metrics = metrics._replace(x=new.px)
        return new, metrics
    return broken
