"""The divergence-7 probe (``probes/divergence7.py``) against the JAX
package's ``scripts/divergence7_check.py``, on ``device="cpu"``.

The probe drives ZAM_Tjunction-1_42_T-1 to its goal through the host
``plan()`` loop (146 steps) and reconstructs the inputs: 27 transitions
fail, the JAX package's count (``doc/conformance.md`` divergence 7).  On
the first failing transition the probe's ``min_error_over_input_box``
equals the JAX script's function (loaded from the script by path) at the
script's grid n = 41 to rtol 1e-9; the probe's report of every failing
transition, at grid n = 9 to keep the test short, equals the JAX function's
floors at the same grid.
"""

import importlib.util
import logging

import numpy as np
import pytest
import torch

from commonroad_rp_tpu.utils import evaluation as jax_eval

from commonroad_rp_tpu_torch.probes import divergence7
from commonroad_rp_tpu_torch.utils import evaluation as port_eval

logging.getLogger("RP_LOGGER").setLevel(logging.CRITICAL)

SCENARIO = "ZAM_Tjunction-1_42_T-1"


@pytest.fixture(scope="module")
def jax_script(repo_root):
    spec = importlib.util.spec_from_file_location(
        "divergence7_check", repo_root / "scripts" / "divergence7_check.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def drive():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return divergence7.drive(SCENARIO, device="cpu")
    finally:
        torch.set_num_threads(threads)


def _pair(planner, pps, i):
    dynamics = port_eval.VehicleDynamicsKS.from_vehicle_type(
        planner.config.vehicle.id_type_vehicle)
    states = pps.trajectory.state_list
    return (dynamics.state_to_array(states[i])[0],
            dynamics.state_to_array(states[i + 1])[0])


def _jax_dynamics(planner):
    return jax_eval.VehicleDynamicsKS.from_vehicle_type(
        planner.config.vehicle.id_type_vehicle)


def test_tjunction_drive_fails_the_jax_count(drive):
    planner, result, _, feasible = drive
    assert result["goal_reached"] and result["steps"] == 146
    assert len(feasible) == 146 and feasible.count(False) == 27


def test_input_box_sweep_matches_the_jax_script(drive, jax_script):
    planner, _, pps, feasible = drive
    i = feasible.index(False)
    x0, x1 = _pair(planner, pps, i)
    dynamics = port_eval.VehicleDynamicsKS.from_vehicle_type(
        planner.config.vehicle.id_type_vehicle)
    got = divergence7.min_error_over_input_box(dynamics, x0, x1, 0.1, n=41)
    want = jax_script.min_error_over_input_box(_jax_dynamics(planner), x0,
                                               x1, 0.1, n=41)
    np.testing.assert_allclose(got[:2], want[:2], rtol=1e-9, atol=0)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-9, atol=0)
    # the transition fails for every bounded input
    assert got[0] > divergence7.POSITION_TOL or \
        got[1] > divergence7.ORIENTATION_TOL


def test_report_of_failing_transitions(drive, jax_script):
    planner, _, pps, feasible = drive
    rows = divergence7.failing_transitions(planner, pps, feasible, n=9)
    fails = [i for i, ok in enumerate(feasible) if not ok]
    assert [r["transition"] for r in rows] == fails
    freq = planner.config.planning.replanning_frequency
    jax_dynamics = _jax_dynamics(planner)
    for row in rows:
        i = row["transition"]
        assert row["at_replan_boundary"] == (i % freq == 0)
        pe, oe, _ = jax_script.min_error_over_input_box(
            jax_dynamics, *_pair(planner, pps, i), 0.1, n=9)
        assert row["min_pos_err_any_bounded_input"] == round(pe, 5)
        assert row["min_orient_err"] == round(oe, 6)
        accel = [s.acceleration for s in planner.record_state_list]
        assert row["accel_jump"] == round(abs(accel[i + 1] - accel[i]), 3)
    summary = divergence7.summary(SCENARIO, feasible, rows)
    assert summary["transitions"] == 146 and summary["failures"] == 27
    assert summary["failures_at_replan_boundary"] == sum(
        i % freq == 0 for i in fails)
