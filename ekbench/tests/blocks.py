"""The per-shard reference (`reference.shards.Blocks`) at the rehearsal's
size, 32x16x17, for the tests: a start state made by the reference alone,
blocks stepped side by side in threads of one process (`ThreadRing`), and
one process of a Gloo group stepping its block beside the whole grid:

    python3 -m ekbench.tests.blocks --world W --rank r --port p \\
        --dtype float32|float64 --steps n

prints one JSON line: whether its block's rows equal the whole grid's
bit for bit, and its pieces of the series values.
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import sys
import threading

import torch

from ekbench.perturb import apply, perturbation
from ekbench.reference import lbm, params, shards, solve

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 2147483693


def _read(*path):
    with open(os.path.join(*path)) as f:
        return json.load(f)


def start(dtype):
    """(Params, a state) of the rehearsal configuration: the reference's
    cold start, perturbed by the seed's waves, in equilibrium."""
    P = params.from_config(_read(HERE, "data", "rehearsal.json"))
    traffic = _read(HERE, "..", "traffic", "series10.json")
    phi, c, cn = solve.pb_cold_start(P, "cpu", dtype)
    rho = torch.full(P.shape, P.rho0, dtype=dtype)
    u = torch.zeros((3,) + P.shape, dtype=dtype)
    temp = solve.temperature_profile(P, "cpu", dtype)
    d = perturbation(P.shape, traffic, SEED, "cpu")
    rho, u, c, cn, temp = apply(rho, u, c, cn, temp, d, P.TH)
    return P, lbm.initial_state(P, rho, u, c, cn, temp, phi,
                                solve.efield(P, phi))


class Board:
    """Where the threads of `run_threads` trade their messages."""

    def __init__(self, world: int):
        self.slots = [None] * world
        self.barrier = threading.Barrier(world, timeout=120)

    def trade(self, rank: int, item) -> list:
        self.slots[rank] = item
        self.barrier.wait()
        got = list(self.slots)
        self.barrier.wait()
        return got


class ThreadRing:
    """`shards.Ring`'s two messages between threads of one process."""

    def __init__(self, board: Board, rank: int):
        self.board, self.rank = board, rank

    def swap(self, lo, hi):
        got = self.board.trade(self.rank, (lo.clone(), hi.clone()))
        w = len(got)
        return got[(self.rank - 1) % w][1], got[(self.rank + 1) % w][0]

    def gather(self, a) -> list:
        return self.board.trade(self.rank, a.clone())


def run_threads(P, st: dict, n: int, world: int, tf32: bool = False):
    """Each block's (own rows, series pieces) after n steps, the blocks
    stepped side by side in `world` threads."""
    board = Board(world)
    out, errors = [None] * world, []

    def block(r):
        try:
            blocks = shards.Blocks(world, r, ThreadRing(board, r))
            mine = {k: shards.cut(v, world, r) for k, v in st.items()}
            ref = lbm.run(P, mine, n, tf32, blocks)
            out[r] = (lbm.own(ref, blocks), lbm.series_pieces(P, ref, blocks))
        except BaseException as e:  # noqa: BLE001 - raised below
            errors.append(e)
            board.barrier.abort()

    threads = [threading.Thread(target=block, args=(r,)) for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    if errors or any(t.is_alive() for t in threads):
        raise RuntimeError(f"a block failed: {errors}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m ekbench.tests.blocks")
    for flag in ("--world", "--rank", "--port", "--steps"):
        ap.add_argument(flag, type=int, required=True)
    ap.add_argument("--dtype", choices=["float32", "float64"], required=True)
    args = ap.parse_args(argv)
    import torch.distributed as dist

    torch.set_num_threads(1)
    store = dist.TCPStore("localhost", args.port, args.world, args.rank == 0,
                          timeout=datetime.timedelta(minutes=2))
    dist.init_process_group("gloo", store=store, rank=args.rank,
                            world_size=args.world,
                            timeout=datetime.timedelta(minutes=2))
    P, st = start(getattr(torch, args.dtype))
    whole = lbm.run(P, st, args.steps)
    blocks = shards.Blocks(args.world, args.rank)
    ref = lbm.run(P, {k: shards.cut(v, args.world, args.rank)
                      for k, v in st.items()}, args.steps, blocks=blocks)
    mine = lbm.own(ref, blocks)
    equal = {k: torch.equal(v, shards.cut(whole[k], args.world, args.rank))
             for k, v in mine.items()}
    print(json.dumps({"equal": equal,
                      "series": lbm.series_pieces(P, ref, blocks),
                      "whole": lbm.series(P, whole)}), flush=True)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
