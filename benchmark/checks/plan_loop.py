"""The harness's own checks of the ``plan_loop`` traffic kind
(``traffic/plan_loop.py``): its tiny CPU case and the faults planted
underneath its timed path (``benchlib/faults.py`` loads this file by the
kind's name).

``unchanged``: ``plan()`` returns the previous call's answer.
``altered``: every answer's positions moved by 0.5 m.
"""

from __future__ import annotations

import contextlib

import numpy as np

# the cell's params for a tiny run on the CPU
TINY = {"max_cycles": 3, "check_calls": 4}

# fault -> (params over TINY, window seconds) of its broken-path test:
# judge every call of the window, which holds several calls of each
# drive: a stale answer exists from a drive's second call on
FAULTS = {"unchanged": ({"check_calls": 256}, 4.0),
          "altered": ({"check_calls": 256}, 4.0)}


@contextlib.contextmanager
def planted(kind: str):
    """While open, runs are broken by ``kind``.  Yields the
    ``driver_hook`` that ``core.run_cell`` takes."""
    yield _plan_hook(kind)


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
