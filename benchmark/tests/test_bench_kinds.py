"""A traffic kind enters the benchmark as new files only.

Every ``traffic/<kind>.py`` has its ``checks/<kind>.py`` (``TINY``,
``FAULTS``, ``planted``), and a throwaway kind added to a copy of the
benchmark (its traffic and checks files, a cell file, its entries in
``BENCHMARK.json``) passes the copy's harness and control tests with no
file of the copy edited.

Run from the repository root: ``python -m pytest benchmark/tests -q``.
"""

import copy
import hashlib
import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

BENCH = pathlib.Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

from benchlib import faults  # noqa: E402
from test_bench_harness import SPEC, cell_of  # noqa: E402

TRAFFIC_KINDS = sorted(path.stem
                       for path in (BENCH / "traffic").glob("*.py"))

# the twin re-uses this cell's traffic and checks through the harness's
# own loader, under a kind name of its own
SOURCE = "fleet1024_T21.fused"
TWIN_TRAFFIC = '''from benchlib import core

Driver = core.load_module("traffic", {kind!r}).Driver
'''
TWIN_CHECKS = '''from benchlib import core

_checks = core.load_module("checks", {kind!r})
TINY, FAULTS, planted = _checks.TINY, _checks.FAULTS, _checks.planted
'''


@pytest.mark.parametrize("kind", TRAFFIC_KINDS)
def test_every_kind_declares_its_checks(kind):
    module = faults.checks(kind)
    assert isinstance(module.TINY, dict) and module.TINY
    assert module.FAULTS
    for extra, seconds in module.FAULTS.values():
        assert isinstance(extra, dict) and seconds > 0
    assert callable(module.planted)


def test_a_kind_without_checks_and_an_unknown_fault_are_refused():
    with pytest.raises(FileNotFoundError, match="no_such_kind.py"):
        faults.kinds("no_such_kind")
    with pytest.raises(ValueError, match="no fault"):
        with faults.planted(TRAFFIC_KINDS[0], "no_such_fault"):
            pass


def hashes(folder: pathlib.Path) -> dict:
    return {str(path.relative_to(folder)):
            hashlib.sha256(path.read_bytes()).hexdigest()
            for path in sorted(folder.rglob("*")) if path.is_file()}


def test_a_new_kind_enters_as_new_files_only(tmp_path):
    kind = cell_of(SOURCE)["traffic"]
    twin_kind = f"{kind}_twin"
    twin = SOURCE.rsplit(".", 1)[0] + ".twin"
    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    # the scenarios the harness reads beside its checkout
    (tmp_path / "example_scenarios").symlink_to(ROOT / "example_scenarios")
    before = hashes(bench)

    (bench / "traffic" / f"{twin_kind}.py").write_text(
        TWIN_TRAFFIC.format(kind=kind))
    (bench / "checks" / f"{twin_kind}.py").write_text(
        TWIN_CHECKS.format(kind=kind))
    cell = dict(cell_of(SOURCE), traffic=twin_kind)
    (bench / "cells" / f"{twin}.json").write_text(json.dumps(cell, indent=1))
    spec = copy.deepcopy(SPEC)
    source = next(w for w in spec["workloads"] if w["name"] == SOURCE)
    spec["workloads"].append(dict(source, name=twin, traffic=twin_kind))
    for metric in spec["end_to_end"]:
        if SOURCE in metric.get("workloads", ()):
            metric["workloads"].append(twin)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))

    # the copy's spec test, the twin's tiny run, its control, each of its
    # faults and its checks file
    expected = 1 + 1 + 1 + len(faults.kinds(kind)) + 1
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-c", str(ROOT / "pyproject.toml"), "--rootdir", str(tmp_path),
         "-m", "not gpu", "-k", "twin or files_load",
         str(bench / "tests" / "test_bench_harness.py"),
         str(bench / "tests" / "test_bench_control.py"),
         str(bench / "tests" / "test_bench_kinds.py")],
        cwd=tmp_path, env=dict(os.environ, PYTHONPATH=str(ROOT)),
        capture_output=True, text=True, timeout=1800)
    report = out.stdout[-4000:] + out.stderr[-4000:]
    assert out.returncode == 0, report
    assert f"{expected} passed" in out.stdout, report

    after = hashes(bench)
    assert {name: after.get(name) for name in before} == before
    added = json.loads((tmp_path / "BENCHMARK.json").read_text())
    assert added == spec
