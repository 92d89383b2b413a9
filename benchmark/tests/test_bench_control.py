"""The comparison that decides ``correct`` fails what it should.

* the control: the plain reference in bfloat16 put in the program's place
  comes out not correct (at a tiny size here on the CPU; at the cells' own
  sizes on the card, ``gpu`` marker);
* a run with the timed path broken underneath comes out not correct, once
  for each fault a cell can have: a step that returns its state unchanged,
  half of the fleet left out, an answer altered where it is produced, a
  fleet scorer that weighs its cost terms wrongly.

A cell's faults, the params and window of each fault's run, and its tiny
CPU params live in its traffic kind's ``checks/<kind>.py``
(``benchlib/faults.py`` loads it); nothing here names a kind.

Run from the repository root: ``python -m pytest benchmark/tests -q``.
"""

import pathlib
import sys

import pytest

BENCH = pathlib.Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

import control  # noqa: E402
from benchlib import core, faults  # noqa: E402
from test_bench_harness import CELLS, SEED, cell_of, tiny  # noqa: E402


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    out = control.readings(cell, SEED, 0.5, True, "cpu", tiny(cell))
    assert out["correct"] is False, out["numbers"]


FAULTS = [(cell, kind) for cell in CELLS
          for kind in faults.kinds(cell_of(cell)["traffic"])]


@pytest.mark.parametrize("cell,kind", FAULTS)
def test_a_broken_timed_path_is_not_correct(cell, kind):
    traffic = cell_of(cell)["traffic"]
    extra, seconds = faults.checks(traffic).FAULTS[kind]
    params = dict(tiny(cell), **extra)
    with faults.planted(traffic, kind) as hook:
        result = core.run_cell(cell, SEED, seconds, False, device="cpu",
                               driver_hook=hook, params=params)
    assert result["attempted"] > 8
    assert result["correct"] is False, result["compared"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for seed in (11, 12, 13):
        out = control.readings(cell, seed, 3.0, True)
        assert out["correct"] is False, out["numbers"]
