"""The XLA fleet path at the end of a route.

``build_fleet_scene`` pads every route to the fleet's longest, past each
shorter route's true end.  The XLA fleet cycle (``parallel.fleet.
_single_problem_cycle``) ends every route at its true length
(``true_path_lengths``), as the fused fleet scan and the plain reference
do.  On the benchmark's 12 fleet bases (sampling level 2 here), every
member whose route is shorter than the fleet's longest starts a few metres
before its route's end:

* over a few cycles the XLA path's ``found`` and carry match the port's
  fused fleet scan at the bars of ``tests/test_torch_xla_fleet.py``, and
  with the padded table's last row as the route's end (the fault this
  pins) they do not;
* every cycle of the XLA path, judged from the state it carried into the
  cycle, lies inside the limits of the benchmark's ``fleet1024_T21.xla``
  cell against the plain reference (``benchmark/benchlib/fleet.py``,
  ``judge_episode``).
"""

import json
import logging
import sys

import numpy as np
import pytest
import torch

from commonroad_rp_tpu_torch.ops import grid
from commonroad_rp_tpu_torch.parallel import fleet, replanning_scan

logging.getLogger("RP_LOGGER").setLevel(logging.CRITICAL)

SEED = 2147483659
LEVEL = 2
CYCLES = 8
BEFORE_END_M = 12.0


@pytest.fixture(autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def bench(repo_root):
    sys.path.insert(0, str(repo_root / "benchmark"))
    from benchlib import core

    return core


@pytest.fixture(scope="module")
def setting(repo_root, bench):
    """The benchmark's fleet of the 12 bases at sampling level 2, each
    member on a route shorter than the longest moved to 12 m before its
    route's true end: (config, scene, carry, bases, members, route ends,
    short-route mask, static grid)."""
    from benchlib import fleet as fleet_lib

    config = json.loads((repo_root / "benchmark" / "configs"
                         / "fleet1024_T21_xla.json").read_text())
    config["fleet_level"] = LEVEL
    scene, carry, bases, members = fleet_lib.build(
        config, 12, CYCLES + 10, SEED, "cpu")
    ends = fleet.true_path_lengths(scene.ref.s)
    short = ends < ends.max() - 1.0
    x0_lon = carry.x0_lon.clone()
    x0_lon[short, 0] = ends[short] - BEFORE_END_M
    carry = carry._replace(x0_lon=x0_lon)
    p = config["planner"]["planning"]
    s = config["planner"]["sampling"]
    static_grid = grid.make_static_grid(
        LEVEL, s["t_min"], p["time_steps_computation"] * p["dt"], p["dt"],
        s["d_min"], s["d_max"], s["num_sampling_levels"])
    return config, scene, carry, bases, members, ends, short, static_grid


def _kw(config):
    p = config["planner"]["planning"]
    n = p["time_steps_computation"]
    return dict(dt=p["dt"], n_steps=n, replan_offset=1,
                low_vel_threshold=p["low_vel_mode_threshold"],
                horizon=n * p["dt"], n_cycles=CYCLES)


def _xla(setting, observe=None):
    config, scene, carry, *_, static_grid = setting
    run = fleet.make_fleet_rollout(None, None, static_grid, device="cpu",
                                   **_kw(config))
    return run(carry, scene, observe=observe)


def _fused(setting):
    config, scene, carry, *_, static_grid = setting
    return replanning_scan.make_fleet_scan(scene, static_grid,
                                           **_kw(config))(carry)


def _agree(xla, fused) -> bool:
    """The bars of tests/test_torch_xla_fleet.py: identical ``found`` every
    cycle, ``x0_lon`` within rtol 2e-4 / atol 2e-3, ``velocity`` within
    atol 2e-3, ``best_cost`` within rtol 2e-3."""
    (final_x, m_x), (final_f, m_f) = xla, fused
    try:
        assert torch.equal(m_x.found, m_f[0])
        torch.testing.assert_close(final_x.x0_lon, final_f.x0_lon, rtol=2e-4,
                                   atol=2e-3)
        torch.testing.assert_close(final_x.velocity, final_f.velocity,
                                   rtol=0, atol=2e-3)
        np.testing.assert_allclose(m_x.best_cost.numpy(), m_f[1].numpy(),
                                   rtol=2e-3)
    except AssertionError:
        return False
    return True


def test_xla_path_stops_at_the_route_end_as_the_fused_scan_does(setting):
    *_, ends, short, _ = setting
    xla, fused = _xla(setting), _fused(setting)
    assert _agree(xla, fused)
    final, metrics = xla
    # the case reaches the ends: short-route members stop finding
    # trajectories there, none carried past its route's end
    assert bool(metrics.found[0].all())
    assert not bool(metrics.found[-1][short].all())
    assert bool(torch.all(final.x0_lon[:, 0] <= ends))


def test_padded_route_end_parts_from_the_fused_scan(setting, monkeypatch):
    monkeypatch.setattr(fleet, "true_path_lengths", lambda s: s[:, -1])
    assert not _agree(_xla(setting), _fused(setting))


def test_xla_path_at_the_route_end_within_the_cells_limits(setting, bench,
                                                           repo_root):
    from benchlib import fleet as fleet_lib
    from benchlib.judge import Judge

    config, scene, carry, bases, members, *_ = setting
    cell = bench.load_json("cells", "fleet1024_T21.xla.json")
    sample = list(range(len(members)))
    ref = fleet_lib.Reference(config, bases, members, sample,
                              cell["params"]["obstacle_span"], "cpu")
    rows = [carry]
    final, metrics = _xla(setting, observe=lambda c: rows.append(
        type(c)(*(x.clone() for x in c))))
    assert len(rows) == CYCLES + 1
    states = torch.stack([torch.cat([
        c.x0_lon, c.x0_lat,
        torch.stack([c.orientation, c.velocity, c.time_step.to(c.px.dtype),
                     c.kappa, c.px, c.py], dim=1),
        ref.start[:, fleet_lib.DESIRED, None].to(c.px.dtype)], dim=1)
        for c in rows]).double()
    answers = bench.load_module("traffic", "fleet_rollout").Driver.answers(
        [m.numpy() for m in metrics], sample)
    judge = Judge()
    fleet_lib.judge_episode(judge, ref, states, answers)
    correct, compared = judge.result(
        {k: v for k, v in cell["limits"].items() if k != "start_gap"})
    assert correct, compared
    assert not bool(metrics.found[-1].all())
