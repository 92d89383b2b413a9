"""The port's getting-started walk-through runs on the CPU.

``commonroad_rp_tpu_torch/examples/getting_started.py`` with ``--device
cpu``: once to the goal (ZAM_Over: 27 steps, the JAX package's count) and
once cut by ``--max-steps``; each run writes a solution file that reads back
and the final-trajectory plot.
"""

import logging

import pytest
import torch

from commonroad_rp_tpu_torch.examples import getting_started

logging.getLogger("RP_LOGGER").setLevel(logging.CRITICAL)


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("max_steps,steps", [(200, 27), (7, 7)])
def test_getting_started_on_cpu(tmp_path, capsys, max_steps, steps):
    assert getting_started.main(["--device", "cpu", "--max-steps",
                                 str(max_steps), "--output",
                                 str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert f"goal reached: {steps == 27} after {steps} steps" in out
    assert f"feasible transitions: {steps}/{steps}" in out
    assert (tmp_path / "solution_ZAM_Over-1_1.xml").stat().st_size > 1000
    assert (tmp_path / "final_trajectory_ZAM_Over-1_1.png").stat() \
        .st_size > 10_000
    assert "plan_scan: goal=" in out
