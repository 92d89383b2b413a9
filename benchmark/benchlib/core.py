"""One run of one cell: set-up, warm-up, the measured window, the trace,
the check against the reference, and the result line.

A cell (``cells/<cell>.json``) names its configuration
(``configs/<config>.json``), its traffic kind (``traffic/<kind>.py``,
whose ``Driver`` is the timed loop) and the traffic's parameters.  The
end-to-end and per-layer metrics a cell reports are the entries of
``BENCHMARK.json`` that list it (or list no cells); each per-layer metric
is read by ``metrics/<metric>.py``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import pathlib
import sys
import time

BENCH_DIR = pathlib.Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "commonroad_rp_tpu")


def forbidden_modules(names=None) -> list:
    """Loaded modules whose top-level name is JAX's, jaxlib's, flax's or
    the JAX package's (compared whole: ``commonroad_rp_tpu_torch`` is not
    ``commonroad_rp_tpu``)."""
    names = sys.modules if names is None else names
    return sorted({n for n in names if n.split(".")[0] in FORBIDDEN})


def check_imports(when: str):
    found = forbidden_modules()
    if found:
        raise SystemExit(f"forbidden modules loaded {when}: {found}")


def load_json(*parts) -> dict:
    return json.loads(BENCH_DIR.joinpath(*parts).read_text())


def load_module(folder: str, name: str):
    """``<folder>/<name>.py`` of the benchmark as a module."""
    path = BENCH_DIR / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_{folder}_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def benchmark_spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def metrics_of(cell: str, section: str, spec: dict) -> list:
    return [m for m in spec[section]
            if "workloads" not in m or cell in m["workloads"]]


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation."""
    ordered = sorted(values)
    pos = (len(ordered) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(ordered) - 1)
    return ordered[lo] + (ordered[hi] - ordered[lo]) * (pos - lo)


def device_info(device, count: int = 1) -> dict:
    import subprocess

    import torch

    info = dict(platform="gpu", kind=torch.cuda.get_device_name(device),
                count=count,
                memory_peak_bytes=int(torch.cuda.max_memory_allocated(device)))
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i",
             str(torch.cuda.current_device())],
            capture_output=True, text=True, timeout=20)
        info["power_limit_w"] = float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        info["power_limit_w"] = None
    return info


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_process: float = None,
             driver_hook=None, params=None, control=None) -> dict:
    """One run; returns the result object (the last line's content).
    ``driver_hook(driver)`` may replace parts of the driver before the
    window, and ``params`` the cell's traffic parameters (the harness's
    own tests run tiny cases and break the timed path with them).  With
    ``control`` (a dtype) the check judges the control in place of the
    program's answers: the plain reference computed in that dtype."""
    import torch

    t_process = time.perf_counter() if t_process is None else t_process
    spec = benchmark_spec()
    cell = load_json("cells", f"{cell_name}.json")
    if params:
        cell["params"] = dict(cell["params"], **params)
    config = load_json("configs", f"{cell['config']}.json")
    traffic = load_module("traffic", cell["traffic"])
    driver = traffic.Driver(cell_name, cell, config, seed, device)
    driver.warm()
    if device != "cpu":
        torch.cuda.synchronize()
    check_imports("after set-up")
    setup_s = time.perf_counter() - t_process
    if driver_hook is not None:
        driver_hook(driver)

    trace_units = int(cell["trace_units"])
    traced = None
    t0 = time.perf_counter()
    while True:
        now = time.perf_counter() - t0
        if now >= seconds:
            break
        if trace and traced is None and now >= 0.25 * seconds:
            traced = trace_stretch(driver, trace_units, device)
            continue
        driver.tick()
    window_s = time.perf_counter() - t0
    if trace and traced is None:
        traced = trace_stretch(driver, trace_units, device)

    if device != "cpu":
        info = device_info(torch.device(device))
    else:
        info = dict(platform="cpu", kind="cpu", count=1, memory_peak_bytes=0,
                    power_limit_w=None)
    result_metrics = {}
    if trace:
        record = dict(driver.layer_record(), trace=traced, cell=cell,
                      config=config)
        for m in metrics_of(cell_name, "per_layer", spec):
            value = load_module("metrics", m["name"]).read(record)
            if value is None:
                continue
            if m["unit"] == "%" and value > 100.0:
                raise SystemExit(f"{m['name']} reads {value} %, over 100 %:"
                                 " its count of work is wrong")
            result_metrics[m["name"]] = dict(value=value, unit=m["unit"])
        info["busy_s"] = traced["busy_s"]
        info["window_s"] = traced["window_s"]
    else:
        e2e = driver.end_to_end(window_s)
        e2e["setup_s"] = setup_s
        for m in metrics_of(cell_name, "end_to_end", spec):
            result_metrics[m["name"]] = dict(value=e2e[m["name"]],
                                             unit=m["unit"])

    correct, rows = driver.check(
        None if control is None else driver.control(control))
    check_imports("after the window")
    result = dict(correct=bool(correct), attempted=driver.attempted,
                  failed=driver.failed, metrics=result_metrics, device=info,
                  no_trajectory=driver.no_trajectory)
    if trace:
        result["breakdown"] = dict(device_ops=traced["device_ops"],
                                   idle_gaps=traced["idle_gaps"])
    result["compared"] = {name: dict(value=finite(value), limit=limit)
                          for name, value, limit in rows}
    return result


def trace_stretch(driver, units: int, device: str) -> dict:
    """``units`` ticks of the driver under the profiler."""
    from benchlib import trace as trace_lib

    first = driver.mark()
    bounds = {}

    def stretch():
        bounds["t0"] = time.perf_counter()
        for _ in range(units):
            driver.tick()
        bounds["t1"] = time.perf_counter()

    out = trace_lib.profile(stretch)
    out["window_s"] = bounds["t1"] - bounds["t0"]
    out["units"] = driver.since(first)
    driver.traced = (first, driver.mark())
    return out


def main(argv=None, t_process=None) -> int:
    parser = argparse.ArgumentParser(description="One benchmark run of "
                                     "commonroad_rp_tpu_torch on a CUDA card")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    spec = benchmark_spec()
    cells = {w["name"]: w for w in spec["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    chips = int(cells[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", t_process)
    for name, row in result["compared"].items():
        print(f"compared {name} = {row['value']!r} (limit {row['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def finite(value: float) -> float:
    """A compared number as JSON can carry it: +inf and NaN as 1e308."""
    return value if math.isfinite(value) else 1e308
