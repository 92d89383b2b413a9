"""Faults planted underneath the timed path, for the checks that
``correct`` comes out false (``tests/test_bench_control.py``,
``control.py --fault``).

Each traffic kind declares its own in ``checks/<kind>.py``, beside
``traffic/<kind>.py``: ``TINY`` (the cell's params for a tiny run on the
CPU), ``FAULTS`` (each fault's name -> the params over ``TINY`` and the
window seconds of its broken-path test) and ``planted(fault)`` (a context
manager that yields the ``driver_hook`` of ``core.run_cell``).  A new kind
brings that file and needs no edit here.
"""

from __future__ import annotations

import contextlib

from benchlib import core


def checks(traffic: str):
    """``checks/<traffic>.py`` as a module; a kind without that file
    raises ``FileNotFoundError`` naming it."""
    return core.load_module("checks", traffic)


def kinds(traffic: str) -> tuple:
    """The names of the faults that ``traffic`` can have."""
    return tuple(checks(traffic).FAULTS)


@contextlib.contextmanager
def planted(traffic: str, kind: str):
    """While open, runs of ``traffic`` are broken by ``kind``.  Yields the
    ``driver_hook`` that ``core.run_cell`` takes (None where the fault sits
    in the program's build)."""
    module = checks(traffic)
    if kind not in module.FAULTS:
        raise ValueError(f"no fault {kind!r} for {traffic}")
    with module.planted(kind) as hook:
        yield hook
