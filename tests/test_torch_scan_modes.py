"""The JAX package's ``plan_scan`` behaviour tests on the port
(``device="cpu"``), each held against the JAX package's own scan.

* The single-problem standstill fallback (``tests/test_plan_scan_fallback.
  py:67``): a blocked scene at v = 0.04. The port's host ``plan()`` loop
  engages the fallback every cycle; the port's ``plan_scan(4)`` records the
  host loop's states and the JAX package's ``plan_scan(4)`` states, at the
  JAX test's tolerances, with cost 0 in every cycle.
* ``planning.factor`` 2 (``tests/test_plan_scan_modes.py:95``): DEU_Test
  through the port's ``plan_scan(8)`` against the JAX package's, the
  recorded steps advancing by 2.

Each JAX side compiles its scan once, about 25 s here.
"""

import logging

import numpy as np
import pytest
import torch

from tests import test_plan_scan_fallback as jax_fallback
from tests import test_plan_scan_modes as jax_modes

from commonroad_rp_tpu_torch.ops import collision as co
from commonroad_rp_tpu_torch.run_planner import load_config, make_planner

logging.getLogger("RP_LOGGER").setLevel(logging.CRITICAL)

FREQ = 3   # replanning_frequency of the bundled ZAM_Over configuration


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fast(config):
    config.debug.fast_scoring = True
    config.debug.kernel_dtype = "float32"
    return config


def _scan(planner, n_cycles, **kwargs):
    planner.set_desired_velocity(current_speed=planner.x_0.velocity)
    planner.record_state_and_input(planner.x_0)
    return planner.plan_scan(n_cycles, **kwargs)


def _assert_states_close(got, want, tolerances, n=None):
    """Per-field absolute tolerances, ``{field: atol}``, over the first
    ``n`` recorded states (all of them by default)."""
    n = min(len(got), len(want)) if n is None else n
    for a, b in zip(want[:n], got[:n]):
        assert a.time_step == b.time_step
        for field, atol in tolerances.items():
            np.testing.assert_allclose(getattr(b, field), getattr(a, field),
                                       atol=atol, rtol=0, err_msg=field)


# ---------------------------------------------------------------------------
# the standstill fallback on a blocked scene
# ---------------------------------------------------------------------------

# tests/test_plan_scan_fallback.py's tolerances
STANDSTILL_ATOL = dict(position=1e-4, velocity=1e-6, acceleration=1e-5,
                       orientation=1e-5, steering_angle=1e-6)


def _blocked_planner(repo_root):
    """ZAM_Over at v = 0.04 with the drivable band squeezed to a sliver:
    every candidate is blocked."""
    planner = make_planner(_fast(load_config("ZAM_Over-1_1", repo_root)),
                           device="cpu")
    x0 = planner.x_0.copy()
    x0.velocity = 0.04
    x0.yaw_rate = 0.0
    planner.reset(initial_state_cart=x0,
                  collision_checker=planner.collision_checker,
                  coordinate_system=planner.coordinate_system)
    checker = planner.collision_checker
    corridor = checker.corridor_for(planner.coordinate_system)
    checker._corridor_cache[planner.coordinate_system] = co.CorridorArrays(
        d_lo=torch.full_like(corridor.d_lo, 0.001),
        d_hi=torch.full_like(corridor.d_hi, 0.002))
    return planner


def _follow(planner, n_steps):
    """The reference's replanning loop for ``n_steps`` recorded steps:
    ``plan()`` every ``FREQ`` steps, the previous optimum in between."""
    planner.record_state_and_input(planner.x_0)
    optimal = None
    for _ in range(n_steps):
        count = len(planner.record_state_list) - 1
        if count % FREQ == 0:
            planner.set_desired_velocity(current_speed=planner.x_0.velocity)
            optimal = planner.plan()
            assert optimal is not None
            offset = 1
        else:
            offset = 1 + count % FREQ
        planner.record_state_and_input(optimal[0].state_list[offset])
        planner.reset(initial_state_cart=planner.record_state_list[-1],
                      initial_state_curv=(optimal[2][offset],
                                          optimal[3][offset]),
                      collision_checker=planner.collision_checker,
                      coordinate_system=planner.coordinate_system)


def test_plan_scan_standstill_fallback_blocked(repo_root):
    """The host loop plans the standstill fallback every cycle; plan_scan's
    device branch records the same states (position frozen, v = 0, the
    braking acceleration, steering constant) at cost 0, and the JAX
    package's plan_scan records the same."""
    n_cycles = 4

    host = _blocked_planner(repo_root)
    _follow(host, n_cycles * FREQ)
    assert all(s.velocity == 0.0 for s in host.record_state_list[1:])

    planner = _blocked_planner(repo_root)
    info = _scan(planner, n_cycles)
    assert info["cycles_run"] == n_cycles
    assert all(c == 0.0 for c in info["best_cost"])
    assert all(info["found"])
    got = planner.record_state_list
    assert len(got) == len(host.record_state_list) == n_cycles * FREQ + 1
    _assert_states_close(got, host.record_state_list, STANDSTILL_ATOL)
    assert got[1].acceleration == pytest.approx(-0.04 / 0.1, abs=1e-5)

    jax_planner = jax_fallback._make_planner(jax_fallback._cfg(repo_root),
                                             velocity=0.04)
    jax_fallback._squeeze_corridor(jax_planner)
    jax_info = _scan(jax_planner, n_cycles)
    assert jax_info["cycles_run"] == n_cycles
    assert list(jax_info["best_cost"]) == list(info["best_cost"])
    want = jax_planner.record_state_list
    assert len(got) == len(want)
    _assert_states_close(got, want, STANDSTILL_ATOL)


# ---------------------------------------------------------------------------
# planning.factor 2
# ---------------------------------------------------------------------------

def test_plan_scan_factor2_matches_jax(repo_root):
    """planning.factor = 2 on DEU_Test (dynamic obstacles, where the stride
    shows): obstacle tables sampled at stride 2 and the recorded scenario
    steps advancing by 2 per planned step, as in the JAX package's
    plan_scan(8). Both are float32 fused scans; measured apart by at most
    4.8e-7 m and 9.5e-7 m/s."""
    config = _fast(load_config("DEU_Test-1_1_T-1", repo_root))
    config.planning.factor = 2
    planner = make_planner(config, device="cpu")
    info = _scan(planner, 8, stop_on_goal=False)
    assert info["cycles_run"] == 8
    got = planner.record_state_list
    assert [s.time_step for s in got[:4]] == [0, 2, 4, 6]

    jax_planner = jax_modes._scan_planner(jax_modes._make_config(
        repo_root, scenario="DEU_Test-1_1_T-1", factor=2))
    jax_info = jax_planner.plan_scan(8, stop_on_goal=False)
    assert jax_info["cycles_run"] == info["cycles_run"]
    want = jax_planner.record_state_list
    assert len(got) == len(want) == 25
    _assert_states_close(got, want, dict(position=1e-4, velocity=1e-4,
                                         orientation=1e-4))
