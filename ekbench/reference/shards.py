"""How a slab mesh of n shards cuts the grid: shard i holds the y rows
[i NY/n, (i+1) NY/n) of every z and x, and process i of n holds shard i.
The pod's harness reassembles the program's shards by this rule alone."""
from __future__ import annotations


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
