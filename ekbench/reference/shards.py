"""How a slab mesh of n shards cuts the grid, and how the reference runs
one shard of it.

Shard i of n holds the y rows [i NY/n, (i+1) NY/n) of every z and x, and
process i of n holds shard i: the program's shards by this rule alone.
The reference steps the same block on the same process (`Blocks`): the
block's rows and, around them, a halo of its two neighbours' edge rows,
sent between the processes by plain `torch.distributed` messages (`Ring`),
never by the program's collectives.  One process is one block covering
the whole grid, with no halo: periodic y is then its own wrap.
"""
from __future__ import annotations

import math

import torch


def rows(ny: int, n: int, i: int):
    """(y0, y1) of shard i of n."""
    if ny % n:
        raise ValueError(f"NY {ny} does not split into {n} slabs")
    step = ny // n
    return i * step, (i + 1) * step


def cut(a, n: int, i: int):
    """Shard i of n of a field (..., NY, NX)."""
    y0, y1 = rows(a.shape[-2], n, i)
    return a[..., y0:y1, :]


class Ring:
    """Messages between the processes of the default process group (NCCL
    on cards, Gloo on the CPU), the blocks in rank order round the
    periodic y axis."""

    def __init__(self, world: int, rank: int):
        self.world, self.rank = world, rank
        self.prev, self.next = (rank - 1) % world, (rank + 1) % world

    def swap(self, lo, hi):
        """Send `hi` (this block's last rows) to the next process and `lo`
        (its first rows) to the previous one; returns (the previous
        block's last rows, the next block's first rows).  Sends and
        receives pair in the order posted, tags aside, so two processes,
        each the other's both neighbours, pair them right."""
        import torch.distributed as dist

        lo, hi = lo.contiguous(), hi.contiguous()
        below, above = torch.empty_like(hi), torch.empty_like(lo)
        ops = [dist.P2POp(dist.isend, hi, self.next, tag=0),
               dist.P2POp(dist.isend, lo, self.prev, tag=1),
               dist.P2POp(dist.irecv, below, self.prev, tag=0),
               dist.P2POp(dist.irecv, above, self.next, tag=1)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return below, above

    def gather(self, a) -> list:
        """Every process's `a` (equal shapes), in rank order."""
        import torch.distributed as dist

        parts = [torch.empty_like(a, memory_format=torch.contiguous_format)
                 for _ in range(self.world)]
        dist.all_gather(parts, a.contiguous())
        return parts


class Blocks:
    """This process's block of a slab decomposition over `world`
    processes, and the messages that keep its halo: `halo` rows of each
    neighbour's populations (phi twice that, for E's centred difference
    at the halo rows).  `ring` carries the messages (default: `Ring`)."""

    def __init__(self, world: int = 1, rank: int = 0, ring=None):
        self.world, self.rank = world, rank
        self.halo = 0 if world == 1 else 1
        if ring is None and world > 1:
            ring = Ring(world, rank)
        self.ring = ring

    @staticmethod
    def inner(a, k: int):
        """The block's own rows of a field with k halo rows a side."""
        return a if k == 0 else a[..., k:a.shape[-2] - k, :]

    def extend(self, a, k: int):
        """The block's field (..., rows, NX) with k rows of each
        neighbour's around it (a new tensor; `a` itself where k is 0)."""
        if k == 0:
            return a
        below, above = self.ring.swap(a[..., :k, :], a[..., -k:, :])
        return torch.cat([below, a, above], -2)

    def refresh(self, a, k: int):
        """Fill a field's k halo rows a side, in place, from the
        neighbours' own edge rows."""
        if k == 0:
            return
        below, above = self.ring.swap(a[..., k:2 * k, :],
                                      a[..., -2 * k:-k, :])
        a[..., :k, :] = below
        a[..., -k:, :] = above

    def whole(self, a):
        """The whole field (..., NY, NX) from every block's own rows."""
        if self.world == 1:
            return a
        return torch.cat(self.ring.gather(a), -2)

    def own(self, a, k: int):
        """The block's rows of a whole field with k rows a side, wrapped."""
        if self.world == 1 and k == 0:
            return a
        ny = a.shape[-2]
        y0, y1 = rows(ny, self.world, self.rank)
        idx = torch.arange(y0 - k, y1 + k, device=a.device) % ny
        return torch.index_select(a, -2, idx)


WHOLE = Blocks()


def _top(values):
    """The largest value, NaN where any is NaN."""
    return math.nan if any(v != v for v in values) else max(values)


def combine(pieces: list) -> dict:
    """One dict of numbers from every block's: a key ending in `.sum` is
    a partial sum (added, float64), any other a largest value."""
    return {k: math.fsum(p[k] for p in pieces) if k.endswith(".sum")
            else _top([p[k] for p in pieces]) for k in pieces[0]}
