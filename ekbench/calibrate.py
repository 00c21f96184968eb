"""Read the compared numbers of a cell over many seeds in one process, and
the control's beside them: the readings the limits in `limits/<cell>.json`
are set from.  Not part of a benchmark run.

    python3 -m ekbench.calibrate --workload <cell> --seeds 1,2,3 --seconds 4 [--control]

Each seed is one run of the cell as `ekbench.run` makes it (set-up, a
window of --seconds, the check), printed as one JSON line `CAL {...}`;
with --control the line also holds, under "control", the numbers of the
reference computed with TF32-rounded matrix products put in the program's
place, and the reading of a chunk that returned its input unchanged.
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m ekbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--trace", type=int, default=0)
    args = ap.parse_args(argv)
    from .manifest import ROOT, load
    from .run import cache_dirs

    cache_dirs(ROOT)
    import torch

    from .cell import run_cell

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    cell = load(args.workload, ROOT)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        res = run_cell(cell, seed, args.seconds, bool(args.trace),
                       torch.device("cuda"), t0, control=args.control)
        res["seed"] = seed
        res["run_s"] = time.perf_counter() - t0
        print("CAL " + json.dumps(res), flush=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
