"""Ablations of the OBB collision kernels on the card.

Run from the repository root on a machine with a CUDA card:

    python -m commonroad_rp_tpu_torch.probes.collision_variants \
        [--parent-source PATH] [--rounds 3] [--out FILE]

``csrc/collision.cu`` keeps no compile-time switches.  This probe writes
variants of it (one constant or one line changed, ``VARIANTS``) into
``build/collision_variants/``, builds each with ``ops.cuda_build``'s flags,
checks each against the kept kernel (identical masks) and times them in
turns, round after round, on two sets of operands:

  fleet1024   the fleet form on the first XLA cycle of the 1024-problem
              heterogeneous fleet (``run_fleet``: K=2754, T=21, M=5), float32;
  level1      the single-problem form on ZAM_Over-1_1's first sampling level
              on the float64 conformance path (K=120, T=21, M=1).

Each time is the median of CUDA-event times per launch (the C call alone,
the mask allocated once) and the profiler's device time per launch.  With
``--parent-source`` (a collision.cu of an earlier commit with the same C
entry points, unpacked into a gitignored directory) that source is timed as
"parent".  Prints one line per variant and writes them as JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import statistics

import torch

from commonroad_rp_tpu_torch.ops import collision_kernel as ck
from commonroad_rp_tpu_torch.ops import cuda_build

OUT_DIR = cuda_build.BUILD_DIR.parent / "collision_variants"
# name -> (regex, replacement) applied to csrc/collision.cu; None: as kept
VARIANTS = {
    "kept": None,
    "no skip": (r"const bool skip_ok = isfinite\(th\);",
                "const bool skip_ok = false;"),
    "cos, sin apart": (r"\{ dsincos\(th, &s, &c\); \}",
                       "{ c = cos(th); s = sin(th); }"),
    "fleet: 8 step groups": (r"kFleetStepGroups = 1;",
                             "kFleetStepGroups = 8;"),
    "fleet: 1 tile per block": (r"kFleetTilesPerBlock = 2;",
                                "kFleetTilesPerBlock = 1;"),
    "fleet: 4 tiles per block": (r"kFleetTilesPerBlock = 2;",
                                 "kFleetTilesPerBlock = 4;"),
    "fleet: 11 tiles per block": (r"kFleetTilesPerBlock = 2;",
                                  "kFleetTilesPerBlock = 11;"),
    "single: 1 step group": (r"kStepGroups = 8;", "kStepGroups = 1;"),
    "single: 2 step groups": (r"kStepGroups = 8;", "kStepGroups = 2;"),
    "single: 4 step groups": (r"kStepGroups = 8;", "kStepGroups = 4;"),
}


def build_variants(parent_source=None):
    """{name: (library, ptxas lines)} of every variant (and the parent)
    that builds; a variant that does not build is printed and left out."""
    from concurrent.futures import ThreadPoolExecutor

    text = ck.KERNEL_SOURCE.read_text()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    sources = {}
    for i, (name, change) in enumerate(VARIANTS.items()):
        body = text
        if change is not None:
            body, n = re.subn(change[0], change[1], text)
            if n != 1:
                raise RuntimeError(f"variant {name!r}: {n} matches")
        path = OUT_DIR / f"collision_v{i}.cu"
        path.write_text(body)
        sources[name] = path
    if parent_source:
        path = OUT_DIR / "collision_parent.cu"
        path.write_text(pathlib.Path(parent_source).read_text())
        sources["parent"] = path
    def build(path):
        try:
            return cuda_build.build(path)
        except RuntimeError as exc:          # a variant nvcc refuses
            return exc

    with ThreadPoolExecutor(len(sources)) as pool:
        libs = list(pool.map(build, sources.values()))
    built = {}
    for (name, path), lib_path in zip(sources.items(), libs):
        if isinstance(lib_path, RuntimeError):
            print(f"{name}: build failed\n{lib_path}", flush=True)
            continue
        lib = ctypes.CDLL(str(lib_path))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.crp_obb_collision_f64.argtypes = [p] * 7 + [
            ctypes.c_double, ctypes.c_double, i, i, i, p, p]
        lib.crp_obb_collision_fleet_f32.argtypes = [p] * 9 + [i] * 4 + [p, p]
        log = cuda_build.build_log(path) or ""
        built[name] = (lib, [line.strip() for line in log.splitlines()
                             if "registers" in line or "spill" in line])
    return built


def launcher(lib, ops, fleet):
    """A function that launches ``lib``'s kernel on ``ops`` into a mask
    allocated once; returns (launch, mask)."""
    cx, cy, theta, obstacles, ehl, ehw = ops
    *lead, T, K = cx.shape
    M = obstacles.pose.shape[len(lead)]
    out = torch.zeros((*lead, K), dtype=torch.bool, device=cx.device)
    head = (cx.data_ptr(), cy.data_ptr(), theta.data_ptr(),
            obstacles.pose.data_ptr(), obstacles.half_ext.data_ptr(),
            obstacles.valid.data_ptr(),
            None if obstacles.radius is None else obstacles.radius.data_ptr())
    stream = torch._C._cuda_getCurrentRawStream(cx.device.index)
    if fleet:
        args = head + (ehl.data_ptr(), ehw.data_ptr(), *lead, K, T, M,
                       out.data_ptr(), stream)
        fn = lib.crp_obb_collision_fleet_f32
    else:
        args = head + (float(ehl), float(ehw), K, T, M, out.data_ptr(),
                       stream)
        fn = lib.crp_obb_collision_f64

    def launch():
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
    return launch, out


def event_ms(launch, reps):
    """Median CUDA-event time (ms) of one launch over ``reps`` launches."""
    launch()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        launch()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(launch, reps=20):
    """Profiler device time (ms) per launch, or None."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    launch()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            launch()
        torch.cuda.synchronize()
    us = sum(float(evt.self_device_time_total) for evt in prof.key_averages()
             if evt.device_type == DeviceType.CUDA)
    return us / 1e3 / reps if us > 0 else None


def operands():
    """{"fleet1024": fleet-form float32 operands, "level1": single-problem
    float64 operands} captured from the port's own paths."""
    from commonroad_rp_tpu_torch.ops import collision as collision_ops
    from commonroad_rp_tpu_torch.run_fleet import (heterogeneous_fleet,
                                                   make_xla_rollout)
    from commonroad_rp_tpu_torch.run_planner import load_config, make_planner

    captured = {}

    def capture(name, reference):
        def fn(*ops):
            captured.setdefault(name, ops)
            return reference(*ops)
        return fn

    scene, carry, _, _ = heterogeneous_fleet(1024, 1, device="cuda")
    collision_ops.obb_collision_fleet = capture(
        "fleet1024", ck.obb_collision_fleet_reference)
    try:
        make_xla_rollout(1, 1, "cuda", graph=False)[0](carry, scene)
    finally:
        collision_ops.obb_collision_fleet = ck.obb_collision_fleet
    config = load_config("ZAM_Over-1_1")
    config.debug.fast_scoring = False
    config.debug.kernel_dtype = "float64"
    planner = make_planner(config, device="cuda")
    planner.set_desired_velocity(current_speed=planner.x_0.velocity)
    collision_ops.obb_collision = capture("level1", ck.obb_collision_reference)
    try:
        planner.plan(current_sampling_level=1)
    finally:
        collision_ops.obb_collision = ck.obb_collision
    return captured


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent-source", default=None)
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--out", default=None)
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("collision_variants: needs a CUDA card")
    built = build_variants(opts.parent_source)
    ops = operands()
    runs = {}
    for name, (lib, ptxas) in built.items():
        for shape, fleet in (("fleet1024", True), ("level1", False)):
            launch, out = launcher(lib, ops[shape], fleet)
            runs[name, shape] = launch
            launch()
            torch.cuda.synchronize()
            want = ck.obb_collision_fleet(*ops[shape]) if fleet \
                else ck.obb_collision(*ops[shape])
            if not torch.equal(out, want):
                raise AssertionError(f"{name} {shape}: mask differs from the "
                                     "kept kernel's")
    times = {key: [] for key in runs}
    for _ in range(opts.rounds):
        for key, launch in runs.items():
            reps = 50 if key[1] == "fleet1024" else 200
            times[key].append((event_ms(launch, reps), device_ms(launch)))
    rows = []
    for name, (_, ptxas) in built.items():
        row = {"variant": name, "ptxas": ptxas}
        for shape in ("fleet1024", "level1"):
            row[shape] = {"event_ms": [t[0] for t in times[name, shape]],
                          "device_ms": [t[1] for t in times[name, shape]]}
        rows.append(row)
        fmt = lambda xs: ", ".join("n/m" if x is None else f"{x:.5f}"
                                   for x in xs)
        print(f"{name}: fleet1024 events {fmt(row['fleet1024']['event_ms'])}"
              f" device {fmt(row['fleet1024']['device_ms'])} ms; level1 "
              f"events {fmt(row['level1']['event_ms'])} device "
              f"{fmt(row['level1']['device_ms'])} ms; {'; '.join(ptxas)}",
              flush=True)
    if opts.out:
        pathlib.Path(opts.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(opts.out).write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
