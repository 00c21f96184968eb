"""The CPU rehearsal of the harness, for the tests: a temporary root with a
manifest of test cells (never the repository's BENCHMARK.json), and a
command that runs one of them through the same code as `ekbench.run`,
skipping only its look for a card.

    python3 -m ekbench.tests.rehearse --root R --workload W --seed S \\
        --seconds T --trace 0|1 [--fault unchanged|half|altered|exchange]
        [--control] [--device cpu|cuda]

--fault breaks the timed path underneath the harness, in the program's
own functions: a chunk that returns its state unchanged; a chunk that
leaves half the grid (the upper z half) as it came in; the ion
populations of one node altered by 1e-3 where the chunk produces them (on
a mesh, in the last process's shard, never process 0's); the edge
exchange between processes left out (each shard gets its own edges back).  The mesh's
other processes run `ekbench.tests.rehearse_worker` with the same fault.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
DATA = os.path.join(HERE, "data")


def make_root(tmp: str, cells) -> str:
    """A root in `tmp` with a copy of ekbench/ and a BENCHMARK.json of the
    test cells: (cell, config name, traffic, limits file) each, the
    repository's metrics extended to them."""
    root = os.path.join(tmp, "root")
    shutil.copytree(BENCH, os.path.join(root, "ekbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(os.path.dirname(BENCH), "BENCHMARK.json")) as f:
        bench = json.load(f)
    names = [c[0] for c in cells]
    bench["configs"] = []
    bench["workloads"] = []
    for name, config, traffic, limits in cells:
        file = f"ekbench/tests/data/{config}.json"
        if config not in [c["name"] for c in bench["configs"]]:
            bench["configs"].append({"name": config, "source": "test",
                                     "file": file, "reduced": [],
                                     "why": "rehearsal"})
        bench["workloads"].append({"name": name, "config": config,
                                   "traffic": traffic, "chips": 1,
                                   "why": "rehearsal"})
        shutil.copy(os.path.join(DATA, limits),
                    os.path.join(root, "ekbench", "limits", name + ".json"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        m["workloads"] = names
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f, indent=1)
    return root


def plant(fault: str) -> None:
    """Break the program's timed path underneath the harness."""
    if not fault:
        return
    import ekpnp_torch.kernels.step as kstep
    import ekpnp_torch.parallel.halo as halo

    if fault == "unchanged":
        def same(cfg, state, n):
            return state._replace(t=state.t + n * cfg.physics.dt(cfg.grid.dx))
        kstep.multi_step = same
    elif fault == "half":
        whole = kstep.multi_step

        def half(cfg, state, n):
            z = cfg.grid.nz // 2
            keep = {k: getattr(state, k)[:, z:].clone() for k in
                    ("f", "h", "hn", "g")}
            out = whole(cfg, state, n)
            for k, v in keep.items():
                getattr(out, k)[:, z:] = v
            return out
        kstep.multi_step = half
    elif fault == "altered":
        import ekpnp_torch.parallel.mesh as pmesh

        whole, sharded = kstep.multi_step, pmesh.make_sharded_multi_step

        def alter(cfg, ions):
            for a in ions:
                a[:, cfg.grid.nz // 3, a.shape[-2] // 2, a.shape[-1] // 2] *= (
                    1.0 + 1e-3)

        def altered(cfg, state, n):
            out = whole(cfg, state, n)
            alter(cfg, (out.h, out.hn))
            return out

        def altered_mesh(cfg, mesh, n):
            chunk = sharded(cfg, mesh, n)

            def run(state):
                out = chunk(state)
                if mesh.rank == mesh.world - 1:
                    i = mesh.local[0]
                    alter(cfg, (out.h[i], out.hn[i]))
                return out
            return run
        kstep.multi_step = altered
        pmesh.make_sharded_multi_step = altered_mesh
    elif fault == "exchange":
        def own(mesh, shards, axis, shift):
            return [None if s is None else s.clone() for s in shards]
        halo.ring_shift = own
    else:
        raise ValueError(f"unknown fault {fault!r}")


def main(argv=None) -> int:
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(prog="python3 -m ekbench.tests.rehearse")
    ap.add_argument("--root", required=True)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--fault", default="")
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)
    from ekbench.manifest import load
    from ekbench.run import cache_dirs, emit

    cache_dirs(args.root)
    import torch

    torch.set_num_threads(2)
    plant(args.fault)
    from ekbench.cell import run_cell

    worker = ["ekbench.tests.rehearse_worker"] + (
        [f"--fault={args.fault}"] if args.fault else [])
    res = run_cell(load(args.workload, args.root), args.seed, args.seconds,
                   bool(args.trace), torch.device(args.device), t_start,
                   control=args.control, worker=worker)
    if args.control:
        print("CONTROL " + json.dumps(res.pop("control")), file=sys.stderr)
    return emit(res)


if __name__ == "__main__":
    sys.exit(main())
