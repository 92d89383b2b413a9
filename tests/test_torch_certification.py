"""Physics certification of the port's device-loop outputs: the counterpart
of ``tests/test_production_certification.py`` on ``device="cpu"``.

The port's ``plan_scan`` drives the four bundled scenarios at the JAX
test's cycle counts (14/16/50/20), and ``run_planner.drive_mission`` drives
the stop-at-goal mission; each recorded state list goes through the port's
evaluation pipeline (``utils/evaluation.py``: KS input reconstruction,
forward simulation, ``valid_solution``), through the certificate the smoke
also runs on the card's drives (``evaluation.certify_drive``):

* initial-state consistency, goal, collision and road-boundary compliance;
* per-transition KS feasibility: every transition on ZAM_Over, DEU_Test,
  the ramp and the mission; on the T-junction the per-transition verdict
  vector equals the JAX package's on its own ``plan_scan(50)`` drive (the
  sharp low-speed yield turn fails the same 27 of 146 transitions in both
  packages, ``doc/conformance.md`` divergence 7, the transitions the smoke
  expects on the card: ``probes.divergence7.TJUNCTION_FAILING``);
* the open-loop drift of the reconstructed inputs' forward simulation stays
  below 2e-2 m per state (``evaluation.py:103-114``).
"""

import logging

import pytest
import torch

from commonroad_rp_tpu.utils import evaluation as jax_eval

from commonroad_rp_tpu_torch.probes.divergence7 import (TJUNCTION,
                                                        TJUNCTION_FAILING)
from commonroad_rp_tpu_torch.run_planner import (drive_mission, load_config,
                                                 make_planner)
from commonroad_rp_tpu_torch.utils.evaluation import certify_drive

from tests.test_production_certification import (_drive_plan_scan,
                                                 _scan_config)

logging.getLogger("RP_LOGGER").setLevel(logging.CRITICAL)

# scenario -> plan_scan cycles (tests/test_production_certification.py:43-48)
CYCLES = {"ZAM_Over-1_1": 14, "DEU_Test-1_1_T-1": 16,
          TJUNCTION: 50, "ZAM-Ramp-1_1-T-1": 20}


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _planner(repo_root, scenario):
    config = load_config(scenario, repo_root)
    config.debug.fast_scoring = True
    config.debug.kernel_dtype = "float32"
    return make_planner(config, device="cpu"), config


def _certify(planner, failing=()):
    """The certificate of the drive's recorded states, asserted whole."""
    cert = certify_drive(planner.config, planner.record_state_list)
    assert cert["certified"], cert
    assert cert["failing"] == list(failing), cert["failing"]
    return cert


@pytest.mark.parametrize("scenario", [s for s in CYCLES if s != TJUNCTION])
def test_plan_scan_output_is_dynamically_drivable(repo_root, scenario):
    planner, _ = _planner(repo_root, scenario)
    planner.set_desired_velocity(current_speed=planner.x_0.velocity)
    planner.record_state_and_input(planner.x_0)
    info = planner.plan_scan(CYCLES[scenario])
    assert info["goal_reached"], info
    assert _certify(planner)["valid"]


def test_tjunction_verdicts_equal_the_jax_package(repo_root):
    """The T-junction's per-transition verdicts, the port's plan_scan(50)
    drive through the port's evaluation against the JAX package's drive
    through the JAX evaluation: the same transitions fail."""
    planner, _ = _planner(repo_root, TJUNCTION)
    planner.set_desired_velocity(current_speed=planner.x_0.velocity)
    planner.record_state_and_input(planner.x_0)
    info = planner.plan_scan(CYCLES[TJUNCTION])
    assert info["goal_reached"], info
    verdicts = _certify(planner, TJUNCTION_FAILING)["transitions"]

    jax_config = _scan_config(repo_root, TJUNCTION)
    jax_planner, jax_info = _drive_plan_scan(jax_config, CYCLES[TJUNCTION])
    assert jax_info["goal_reached"]
    solution = jax_eval.create_planning_problem_solution(
        jax_config, jax_eval.create_full_solution_trajectory(
            jax_config, jax_planner.record_state_list),
        jax_config.scenario, jax_config.planning_problem)
    want, _ = jax_eval.reconstruct_inputs(
        jax_config, solution.planning_problem_solutions[0])
    assert len(verdicts) == len(want) == 146
    assert verdicts == want, [i for i, (a, b) in enumerate(
        zip(verdicts, want)) if a != b]
    assert 0 < verdicts.count(False) < len(verdicts)


def test_mission_output_is_dynamically_drivable(repo_root):
    """The stop-at-goal mission (velocity keeping, braking, stopping, all
    through plan_scan): certified, with the goal reached and the vehicle
    halted at the end."""
    planner, config = _planner(repo_root, "ZAM_Over-1_1")
    planner.record_state_and_input(planner.x_0)
    result = drive_mission(planner, config, max_steps=320)
    assert result["success"], result
    assert _certify(planner)["valid"]
    assert planner.record_state_list[-1].velocity <= 0.05
