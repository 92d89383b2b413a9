"""Test configuration: force a virtual 8-device CPU platform.

Tests exercise the multi-chip sharding path on a host-platform device mesh
(SURVEY.md section 4: the reference ships no tests; this pyramid is ours).
Environment variables must be set before jax is first imported.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# Force the CPU backend regardless of any site-injected platform plugin; must
# happen after import but before first backend use.
jax.config.update("jax_platforms", "cpu")

import pathlib  # noqa: E402

import pytest  # noqa: E402

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
SCENARIO_DIR = REPO_ROOT / "example_scenarios"

# ---- fast/slow split -------------------------------------------------------
# `pytest -m fast` is the <2-minute core subset (closed-form conformance,
# collision kernels, golden first-cycle selection on all 4 scenarios, one
# end-to-end drive); everything else is marked slow.  The full suite exceeds
# 10 minutes on a 2-core host, which a time-budgeted CI would misreport as a
# failure on a green tree.
_FAST_MODULES = {
    "test_polynomial.py",
    "test_geometry.py",
    "test_kinematics_conformance.py",
    "test_collision.py",
    "test_onehot_interval.py",
    "test_scenario_io.py",
    "test_native.py",
    "test_precision_and_golden.py",
    "test_fleet_comm_volume.py",
}
_FAST_TESTS = {
    ("test_planner_e2e.py", "test_over_reaches_goal"),      # one e2e drive
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        mod = pathlib.Path(str(item.fspath)).name
        name = item.name.split("[")[0]
        if mod in _FAST_MODULES or (mod, name) in _FAST_TESTS \
                or mod.startswith("test_torch_"):
            item.add_marker(pytest.mark.fast)
        else:
            item.add_marker(pytest.mark.slow)


# ---- memory-map guard (root cause of the round-4 full-suite SIGSEGV) -------
# Every XLA:CPU executable holds its LLVM-JITed code in many separate mmap
# regions, and jax's global jit cache keeps every compiled program alive.  A
# full-suite run compiles hundreds of distinct programs; by ~95 slow tests
# the process crosses the kernel's vm.max_map_count limit (65530 — measured
# 64660 maps one minute before the crash, 2026-08-21) and the NEXT large
# compile segfaults inside LLVM when mmap fails (reproducibly at the
# continuous-mode plan_scan, the biggest program compiled late in the
# alphabetical order; any file passes in isolation because a fresh process
# starts at ~2k maps).  The guard clears jax's caches — dropping executables
# unmaps their code — whenever the map count nears the limit.  Recompiles
# after a clear are served by each module's own warm paths; the persistent
# compile cache is not used by the suite, so a clear costs seconds, not the
# crash.  Consumers with long-lived CPU-backend processes that compile many
# DISTINCT planner programs should do the same (doc/user_guide.md platform
# notes); steady-state serving compiles a bounded set and never hits this.
_MAP_GUARD_THRESHOLD = 40_000


def _map_count() -> int:
    try:
        with open("/proc/self/maps", "rb") as fh:
            return sum(1 for _ in fh)
    except OSError:                                   # non-Linux: no guard
        return 0


@pytest.fixture(autouse=True)
def _xla_cpu_map_guard():
    yield
    if _map_count() > _MAP_GUARD_THRESHOLD:
        jax.clear_caches()


@pytest.fixture(scope="session")
def scenario_dir() -> pathlib.Path:
    return SCENARIO_DIR


@pytest.fixture(scope="session")
def repo_root() -> pathlib.Path:
    return REPO_ROOT
