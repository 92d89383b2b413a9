"""What every traffic driver shares."""

from __future__ import annotations


class DriverBase:
    """A cell's timed loop.  ``tick()`` does one unit of the traffic (one
    ``plan()`` call, one scan call) and ends in a read of its result on the
    host; ``mark()``/``since()`` count units, so that a traced stretch knows
    how many it held.  ``attempted`` counts the problems' answers the window
    asked for; ``failed`` those it asked for and never got (a ``plan()`` or
    a scan that raises ends the run, so a run that prints its line reads
    0).  An answer that finds no trajectory is an answer, judged by the
    check like any other; ``no_trajectory`` counts those."""

    def __init__(self, cell_name: str, cell: dict, config: dict, seed: int,
                 device: str):
        self.cell_name = cell_name
        self.cell = cell
        self.config = config
        self.seed = int(seed)
        self.device = device
        self.params = cell["params"]
        self.units = 0
        self.attempted = 0
        self.failed = 0
        self.no_trajectory = 0
        self.traced = None

    def mark(self) -> int:
        return self.units

    def since(self, mark: int) -> int:
        return self.units - mark
