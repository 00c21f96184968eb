"""The per-shard check on the CPU.  The reference stepping its own block of
a slab mesh (`reference.shards.Blocks`) equals the whole-grid reference at
the rehearsal's size, 32x16x17, bit for bit in float64 and float32, over
2 and 4 blocks: in threads of one process and over Gloo.  One process is
one block: its check prints the numbers that the whole-grid check, which
gathered every shard onto process 0, printed before it
(`data/rehearsal.check.json`: that check's numbers on the same seed and
chunk, on an x86-64 CPU with 2 threads)."""
import json
import os
import socket
import subprocess
import sys

import pytest
import torch

from ekbench.reference import lbm, shards
from ekbench.tests import blocks, rehearse

torch.set_num_threads(2)
CODE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
STEPS = 3


@pytest.fixture(scope="module", params=["float64", "float32"])
def case(request):
    P, st = blocks.start(getattr(torch, request.param))
    return P, st, lbm.run(P, st, STEPS)


def _same_series(P, pieces, want):
    got = lbm.series_values(P, shards.combine(pieces))
    assert got["umax"] == want["umax"] and got["umag"] == want["umag"]
    for k in ("current", "mean_T"):    # partial sums, added in another order
        assert got[k] == pytest.approx(want[k], rel=1e-12, abs=0), k


@pytest.mark.parametrize("world", [2, 4])
def test_blocks_in_one_process_equal_the_whole_grid(case, world):
    P, st, whole = case
    got = blocks.run_threads(P, st, STEPS, world)
    for r, (mine, _) in enumerate(got):
        assert set(mine) == set(whole)
        for k, v in mine.items():
            assert torch.equal(v, shards.cut(whole[k], world, r)), (r, k)
    _same_series(P, [p for _, p in got], lbm.series(P, whole))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("world", [2, 4])
def test_blocks_over_gloo_equal_the_whole_grid(world, dtype):
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "ekbench.tests.blocks", "--world", str(world),
         "--rank", str(r), "--port", str(port), "--dtype", dtype,
         "--steps", str(STEPS)], cwd=CODE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
        outs.append(json.loads(out.strip().splitlines()[-1]))
    for r, o in enumerate(outs):
        assert all(o["equal"].values()) and len(o["equal"]) == 5, (r, o)
    P, _ = blocks.start(getattr(torch, dtype))
    _same_series(P, [o["series"] for o in outs], outs[0]["whole"])


def test_one_process_check_prints_the_numbers_of_the_gathered_check(tmp_path):
    from ekbench import harness
    from ekbench.cell import Group, check, program_config
    from ekbench.manifest import load

    with open(os.path.join(rehearse.DATA, "rehearsal.check.json")) as f:
        want = json.load(f)
    root = rehearse.make_root(str(tmp_path), [
        (want["workload"], "rehearsal", "series10", "rehearsal.limits.json")])
    cell = load(want["workload"], root)
    dev = torch.device("cpu")
    prog = harness.Program(program_config(cell), dev)
    state, keep = harness.setup(prog, cell, want["seed"], False, {})
    win = {"landed": [(0, [float(v) for v in prog.series(state)], 0.0)],
           "check": 0, "chunks": 1}
    numbers, extra = check(cell, keep, win, want["seed"],
                           Group(1, 0, 0, dev, [], []), dev, want["control"])
    assert numbers == want["numbers"]
    assert extra == want["extra"]
