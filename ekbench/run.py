"""Run one cell of the benchmark once and print its result as the last
line of standard output:

    python3 -m ekbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

--trace 0 reports the cell's end-to-end metrics, --trace 1 its per-layer
metrics from a profiler trace of the window.  The numbers the check
compared come last in the line (`checks`, each with its limit) and as the
last lines of standard error.  Without the cards the cell asks for, or
without the program beside it, the run exits non-zero and prints no
result; so it does if JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "ekpnp")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared as whole names (`ekpnp_torch` is not `ekpnp`)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def cache_dirs(root: str) -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    base = os.path.join(root, ".ekbench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m ekbench.run",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=[0, 1], default=0)
    return ap.parse_args(argv)


def fail(msg: str, code: int = 2) -> int:
    print(f"ekbench: {msg}", file=sys.stderr, flush=True)
    return code


def emit(result: dict) -> int:
    """Print the checks on standard error and the result line last on
    standard output; refuse if JAX or the JAX package is loaded."""
    bad = forbidden_modules()
    if bad:
        return fail(f"forbidden modules loaded: {', '.join(bad)}", 4)
    for name, row in result["checks"].items():
        print(f"check {name} = {row['value']!r} (limit {row['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def main(argv=None) -> int:
    from .manifest import ROOT, load

    args = parse(argv)
    cache_dirs(ROOT)
    try:
        cell = load(args.workload, ROOT)
    except (OSError, KeyError, ValueError) as e:
        return fail(f"cannot load the cell {args.workload!r}: {e}")
    try:
        import ekpnp_torch  # noqa: F401
    except ImportError as e:
        return fail(f"the program (ekpnp_torch) is not beside the benchmark: {e}")
    import torch

    if not torch.cuda.is_available():
        return fail("no CUDA device: the benchmark measures the card", 3)
    if torch.cuda.device_count() < cell.chips:
        return fail(f"{cell.name} needs {cell.chips} cards, "
                    f"{torch.cuda.device_count()} visible", 3)
    from .cell import run_cell

    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda"), T_START)
    return emit(result)


if __name__ == "__main__":
    sys.exit(main())
