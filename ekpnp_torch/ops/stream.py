"""Pull streaming (port of ekpnp/ops/stream.py).

f1[x, d] = f2[x - e_d] with periodic wrap in all three directions; the wall
BCs overwrite the unphysical z-wrap rows afterwards (boundary.py).  One
`torch.roll` per direction, shifts (e_z, e_y, e_x) on axes (z, y, x).
"""
from __future__ import annotations

import torch

from ..lattice import Lattice


def stream(lat: Lattice, pops):
    """pops: (Q, Z, Y, X) post-collision -> streamed (Q, Z, Y, X)."""
    out = [pops[0]]  # the rest population does not move
    for d in range(1, lat.Q):
        ex, ey, ez = (int(v) for v in lat.E[d])
        out.append(torch.roll(pops[d], shifts=(ez, ey, ex), dims=(0, 1, 2)))
    return torch.stack(out)
