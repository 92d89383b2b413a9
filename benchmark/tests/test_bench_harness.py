"""CPU tests of the benchmark harness (``benchmark/``).

Run from the repository root:

    python -m pytest benchmark/tests -q

The traffic drivers run tiny cases on the CPU; the tests that need the card
carry the ``gpu`` marker and skip without one.
"""

import json
import pathlib
import re
import sys

import pytest

BENCH = pathlib.Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

from benchlib import core, faults, judge, trace  # noqa: E402
from benchlib.core import load_module  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
SEED = 2 ** 31 + 987654321
CONTRACT_KEYS = ["correct", "attempted", "failed", "metrics", "device",
                 "no_trajectory", "compared"]


def cell_of(name):
    return core.load_json("cells", f"{name}.json")


def tiny(name):
    """The cell's tiny CPU params, from its kind's ``checks/<kind>.py``."""
    return faults.checks(cell_of(name)["traffic"]).TINY


def test_files_load_and_names_are_allowed():
    keys = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
    assert set(SPEC) == keys
    names = [c["name"] for c in SPEC["configs"]] + CELLS + \
        [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for c in SPEC["configs"]:
        config = json.loads((ROOT / c["file"]).read_text())
        assert config["reduced"] == c["reduced"]
        assert len(config["source"]) <= 200
        for key in c["reduced"]:
            assert NAME.match(key)
    for w in SPEC["workloads"]:
        cell = cell_of(w["name"])
        assert cell["config"] == w["config"]
        assert cell["traffic"] == w["traffic"]
        assert (BENCH / "traffic" / f"{w['traffic']}.py").exists()
        assert len(w["why"]) <= 200
    for m in SPEC["per_layer"]:
        module = load_module("metrics", m["name"])
        assert callable(module.read)
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
    for name in CELLS:
        limits = cell_of(name)["limits"]
        assert limits and set(limits) <= set(judge.NUMBERS)
        assert all(value >= 0 for value in limits.values())


@pytest.mark.parametrize("cell", CELLS)
def test_driver_runs_a_tiny_case_and_prints_the_contract_keys(cell, capsys):
    result = core.run_cell(cell, SEED, 0.5, False, device="cpu",
                           params=tiny(cell))
    line = json.dumps(result)
    print(line)
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(last) == CONTRACT_KEYS
    assert last["correct"] is True, last["compared"]
    expected = {m["name"] for m in core.metrics_of(cell, "end_to_end", SPEC)}
    assert set(last["metrics"]) == expected
    assert last["attempted"] > 0
    assert last["failed"] == 0


def test_work_counts_match_a_hand_count():
    work = load_module("work", "planning")
    # 2 candidates, 3 steps, a path of 4 vertices, 1 obstacle occupying 2
    # of the 3 steps
    ops, nbytes = work.scoring(2, 3, 4, 1, 2)
    assert ops == 2 * 3 * work.STEP_OPS + 2 * 2 * 45
    assert work.STEP_OPS == 73 + 24 + 42 + 20 + 16 + 22 + 6
    assert nbytes == 4 * (3 * 2 + 2 * 2 + 9 + 12 * 4 + 4 * 1 * 3 + 3 * 1)
    bound, by = work.bound_s(67e12, 1.0)
    assert by == "operations" and bound == pytest.approx(1.0)


def test_idle_share_of_overlapping_intervals():
    intervals = [(0.0, 1.0), (0.5, 2.0), (1.5, 1.8), (3.0, 4.0)]
    assert trace.union_seconds(intervals) == pytest.approx(3.0)
    reduced = trace.reduce(dict(
        device=[("k", a, b, "kernel") for a, b in intervals],
        host=[("host", 0.0, 5.0)]))
    idle = 1.0 - reduced["busy_s"] / reduced["span_s"]
    assert 0.0 <= idle <= 1.0
    assert idle == pytest.approx(0.4)
    assert trace.gaps(intervals, 0.0, 5.0) == [(2.0, 3.0), (4.0, 5.0)]


def test_import_check_compares_whole_top_level_names():
    assert core.forbidden_modules(["jax.numpy", "numpy"]) == ["jax.numpy"]
    assert core.forbidden_modules(["commonroad_rp_tpu.ops"]) == \
        ["commonroad_rp_tpu.ops"]
    assert core.forbidden_modules(["commonroad_rp_tpu_torch",
                                   "commonroad_rp_tpu_torch.ops",
                                   "jaxtyping"]) == []


def test_a_run_without_a_card_fails():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert core.main(["--workload", CELLS[0], "--seed", "1", "--seconds",
                      "1"]) != 0
