"""The port's tracer (``commonroad_rp_tpu_torch.utils.profiling``): spans
kept only while a ``torch.profiler`` records, one span tree per ``plan()``
call, the spans as ``user_annotation`` events of the Chrome trace, the
per-request sums, and the benchmark's readers of spans and counters
(``benchmark/metrics/``)."""

import collections
import importlib.util
import json
import logging

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from commonroad_rp_tpu_torch.run_planner import load_config, make_planner
from commonroad_rp_tpu_torch.utils import profiling
from commonroad_rp_tpu_torch.utils.profiling import Span

logging.getLogger("RP_LOGGER").setLevel(logging.CRITICAL)

PLAN_SPANS = {  # span: its parent's name
    "planner.plan": None,
    "planner.grid_generation": "planner.plan",
    "planner.device_cycle": "planner.plan",
    "planner.arguments": "planner.device_cycle",
    "level_program.stage": "planner.device_cycle",
    "level_program.readback": "planner.device_cycle",
    "planner.result": "planner.plan",
}


@pytest.fixture
def clean():
    profiling.reset()
    yield
    profiling.reset()


@pytest.fixture(scope="module")
def planner(repo_root):
    planner = make_planner(load_config("ZAM_Over-1_1", repo_root), "cpu")
    planner.set_desired_velocity(current_speed=planner.x_0.velocity)
    assert planner.plan() is not None  # builds the level program
    return planner


@pytest.fixture(scope="module")
def traced(planner, tmp_path_factory):
    """One fused ``plan()`` under the profiler: (its spans, its
    ``device_cycle`` history entry, the Chrome trace's events)."""
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert planner.plan() is not None
    rows = profiling.spans()
    profiling.reset()
    path = tmp_path_factory.mktemp("trace") / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return rows, planner.stage_timers.history["device_cycle"][-1], events


def test_no_span_is_kept_while_no_profiler_records(planner, clean):
    n = len(planner.stage_timers.history["device_cycle"])
    with profiling.span("outer"):
        with profiling.span("inner"):
            pass
    assert planner.plan() is not None
    assert profiling.spans() == []
    assert profiling.per_request("planner.plan") == []
    # the stage history is kept all the same
    assert len(planner.stage_timers.history["device_cycle"]) == n + 1


def test_plan_records_one_span_tree(traced):
    rows, device_cycle_s, _ = traced
    assert collections.Counter(s.name for s in rows) == \
        collections.Counter(PLAN_SPANS.keys())
    by_name = {s.name: s for s in rows}
    by_index = {s.index: s for s in rows}
    assert len({s.request for s in rows}) == 1
    for name, parent in PLAN_SPANS.items():
        s = by_name[name]
        assert s.start_ns <= s.end_ns
        if parent is None:
            assert s.parent == -1
            continue
        p = by_index[s.parent]
        assert p.name == parent
        assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    cycle = by_name["planner.device_cycle"]
    assert (cycle.end_ns - cycle.start_ns) * 1e-9 == device_cycle_s


def test_chrome_trace_holds_the_spans_as_user_annotations(traced):
    _, _, events = traced
    names = {e.get("name") for e in events
             if e.get("cat") == "user_annotation"}
    assert set(PLAN_SPANS) <= names


def test_per_request_sums_repeated_spans(clean):
    with profile(activities=[ProfilerActivity.CPU]):
        for repeats in (2, 0, 3):
            with profiling.span("root"):
                for _ in range(repeats):
                    with profiling.span("leaf"):
                        sum(range(1000))
    with profiling.span("root"):  # no profiler: not kept
        with profiling.span("leaf"):
            pass
    rows = profiling.spans()
    roots = [s for s in rows if s.name == "root"]
    assert [s.parent for s in roots] == [-1] * 3
    assert len({s.request for s in roots}) == 3
    want = []
    for root in roots:
        leaves = [s for s in rows
                  if s.name == "leaf" and s.request == root.request]
        assert all(s.parent == root.index for s in leaves)
        if leaves:
            want.append(sum(s.end_ns - s.start_ns for s in leaves) * 1e-9)
    assert len(want) == 2
    assert profiling.per_request("leaf") == want
    assert profiling.per_request("root") == \
        [(s.end_ns - s.start_ns) * 1e-9 for s in roots]


def test_counters_add(clean):
    profiling.count("a")
    profiling.count("a", 4)
    profiling.count("b", 7)
    assert profiling.counters() == {"a": 5, "b": 7}
    profiling.reset()
    assert profiling.counters() == {}


MS = 1_000_000


def _request(request, first, grid, arguments, stage, reads, result):
    """A hand-built ``plan()`` request: spans with times in ms."""
    names = ["planner.plan", "planner.grid_generation",
             "planner.device_cycle", "planner.arguments",
             "level_program.stage"] \
        + ["level_program.readback"] * len(reads) + ["planner.result"]
    times = [20, grid, 10, arguments, stage, *reads, result]
    parents = [-1, first, first, first + 2, first + 2] + \
        [first + 2] * len(reads) + [first]
    return [Span(first + i, name, request * 100 * MS,
                 request * 100 * MS + int(t * MS), parent, request)
            for i, (name, t, parent) in enumerate(zip(names, times,
                                                      parents))]


HAND_BUILT = (_request(0, 0, 1.0, 2.0, 0.5, [1.0, 0.5], 0.25)
              + _request(1, 8, 3.0, 4.0, 1.5, [2.0], 0.75)
              + _request(2, 15, 2.0, 3.0, 1.0, [4.0], 0.5))
COUNTERS = {"captured_step.captures": 3,
            "captured_step.capture_ns": 2_500_000_000}
EXPECTED = {
    "facade.grid_ms.p50": 2.0,
    "facade.arguments_ms.p50": 3.0,
    "facade.result_ms.p50": 0.5,
    "level_program.stage_ms.p50": 1.0,
    "level_program.readback_ms.p50": 2.0,
    "level_program.reads_per_call": 4 / 3,
    "captured_step.captures": 3,
    "captured_step.capture_s": 2.5,
}


def _reader(repo_root, name):
    path = repo_root / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_benchmark_reader_of_spans_and_counters(repo_root, monkeypatch,
                                                name):
    read = _reader(repo_root, name).read
    monkeypatch.setattr(profiling, "_spans", collections.deque(HAND_BUILT))
    monkeypatch.setattr(profiling, "_counters", dict(COUNTERS))
    assert read({}) == pytest.approx(EXPECTED[name], rel=1e-12)
    monkeypatch.setattr(profiling, "_spans", collections.deque())
    monkeypatch.setattr(profiling, "_counters", {})
    assert read({}) is None


def test_an_eager_step_counts_no_capture(clean):
    """On the CPU a captured step runs eagerly: it never captures, and the
    capture counters stay empty."""
    from commonroad_rp_tpu_torch.ops.program import CapturedStep

    x = torch.arange(4.0)
    step = CapturedStep(lambda: x * 2, "cpu")
    assert not step.capture()
    assert torch.equal(step(), x * 2)
    assert profiling.counters() == {}


def test_scan_program_spans_and_cycle_counter(repo_root, clean):
    """A scan program's call: the spans ``scan_program.stage`` (the carry's
    load and ``prepare``) and ``scan_program.replays`` (the cycles'
    launches), each the root of its call's request, while a profiler
    records; the counter ``scan_program.cycles`` adds ``n_cycles`` a call,
    profiler or not; the benchmark's reader of the stage span takes their
    median."""
    from commonroad_rp_tpu_torch.ops.program import ScanProgram

    Carry = collections.namedtuple("Carry", "x")
    staged = []
    run = ScanProgram(lambda c: (Carry(c.x + 1.0), (c.x.sum(),)), 3, "cpu",
                      prepare=staged.append)
    run(Carry(torch.zeros(4)), "scene")
    assert profiling.spans() == []
    assert profiling.counters() == {"scan_program.cycles": 3}
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            final, (sums,) = run(Carry(torch.zeros(4)), "scene")
    assert staged == ["scene"] * 3
    assert torch.equal(final.x, torch.full((4,), 3.0))
    assert sums.tolist() == [0.0, 4.0, 8.0]
    rows = profiling.spans()
    assert [s.name for s in rows] == ["scan_program.stage",
                                      "scan_program.replays"] * 2
    assert all(s.parent == -1 for s in rows)
    assert len({s.request for s in rows}) == 4
    assert profiling.counters() == {"scan_program.cycles": 9}
    stage = [(s.end_ns - s.start_ns) * 1e-9 for s in rows[::2]]
    read = _reader(repo_root, "fleet_rollout.stage_ms.p50").read
    assert read({}) == pytest.approx(1e3 * sum(stage) / 2, rel=1e-12)
