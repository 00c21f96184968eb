"""A worker process of a mesh cell (rank >= 1), started by process 0 of
`ekbench.run`; it prints nothing: process 0 reports the run.

    python3 -m ekbench.worker --root R --workload W --seed S --seconds T \\
        --trace 0|1 --rank r --port p --device cuda|cpu [--control]

--control: its shard's pieces of the control's numbers too, as process 0
asks of every process when it reads the control (`ekbench.calibrate`).
"""
from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(prog="python3 -m ekbench.worker")
    for flag in ("--root", "--workload", "--device"):
        ap.add_argument(flag, required=True)
    for flag in ("--seed", "--trace", "--rank", "--port"):
        ap.add_argument(flag, type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    from .manifest import load
    from .run import cache_dirs

    cache_dirs(args.root)
    import torch

    from .cell import run_cell

    run_cell(load(args.workload, args.root), args.seed, args.seconds,
             bool(args.trace), torch.device(args.device), t_start,
             rank=args.rank, port=args.port, control=args.control)
    return 0


if __name__ == "__main__":
    sys.exit(main())
