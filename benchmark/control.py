"""Readings of the compared numbers, for setting their limits.

For one cell, in one process on the card, a short run of the cell for
each seed, each judged as a benchmark run judges its window
(``core.run_cell``): ``--seeds`` judge the program (the lower readings),
``--control-seeds`` the plain reference in bfloat16 put in the program's
place (the control, the upper readings), and ``--fault-seeds`` the
program with ``--fault`` planted underneath (``benchlib/faults.py``).
One JSON line per seed, then the largest program reading and the smallest
reading of the others, each number apart:

    python3 benchmark/control.py --workload <cell> --seconds 5 \\
        --seeds 1,2,3 --control-seeds 4,5,6 --fault scorer --fault-seeds 7,8
"""

import argparse
import contextlib
import gc
import json
import os
import pathlib
import sys

BENCH_DIR = pathlib.Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(BENCH_DIR), str(ROOT)]

import torch  # noqa: E402

from benchlib import core, faults  # noqa: E402


def readings(cell_name: str, seed: int, seconds: float, control: bool,
             device: str = "cuda", params=None, fault=None) -> dict:
    """One short run of the cell, judged; ``control`` judges the control,
    ``fault`` plants that fault."""
    traffic = core.load_json("cells", f"{cell_name}.json")["traffic"]
    planted = faults.planted(traffic, fault) if fault else \
        contextlib.nullcontext()
    with planted as hook:
        result = core.run_cell(cell_name, seed, seconds, False, device,
                               driver_hook=hook, params=params,
                               control=torch.bfloat16 if control else None)
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    return dict(seed=seed, control=control, fault=fault,
                correct=result["correct"],
                numbers={k: v["value"] for k, v in result["compared"].items()})


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, default=5.0)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--fault", default=None)
    parser.add_argument("--fault-seeds", default="")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("control.py needs a CUDA card", file=sys.stderr)
        return 3
    split = lambda text: [int(s) for s in text.split(",") if s]
    runs = [(s, "program") for s in split(args.seeds)] + \
        [(s, "control") for s in split(args.control_seeds)] + \
        [(s, "fault") for s in split(args.fault_seeds)]
    sides = {}
    for seed, side in runs:
        out = readings(args.workload, seed, args.seconds, side == "control",
                       fault=args.fault if side == "fault" else None)
        print(json.dumps(out), flush=True)
        pick = max if side == "program" else min
        got = sides.setdefault(side, {})
        for name, value in out["numbers"].items():
            got[name] = pick(got.get(name, value), value)
    print(json.dumps(dict(workload=args.workload, **sides)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
