"""The two collectives of a sharded run, over the shards of one process.

A sharded field is a list of per-shard tensors in mesh order (row-major
over the mesh axes, parallel/mesh.py), each on its mesh device.  Shards
talk only through these two operations, the counterparts of what the JAX
package's sharded step uses:

  ring_shift(mesh, shards, axis, shift)  every shard receives the tensor of
      its neighbour `shift` places back along `axis` (periodic):
      `jax.lax.ppermute` with perm_fwd (shift=+1, "my rows -> right") or
      perm_bwd (shift=-1), ekpnp/parallel/halo.py;
  all_to_all(mesh, shards, axis, split_axis, cat_axis)  within each group
      of shards along `axis`, shard j cuts its tensor into n pieces along
      `split_axis` and shard i receives piece i of every j, joined along
      `cat_axis` in j order: the repartition XLA inserts for a
      `with_sharding_constraint` that moves the sharded axis
      (ekpnp/parallel/fft.py).  An extent that n does not divide is cut as
      `torch.tensor_split` cuts it (the first pieces one longer), as XLA
      pads an uneven sharding: the reference's 50-wide x axis over 4
      slabs.

`axis` is a mesh axis name, "y" or "x", or ("y", "x") for the whole mesh
taken as one ring in mesh order.  Both are slicing, `torch.cat` and
`tensor.to(device, non_blocking=True)`: a peer copy between cards, nothing
on one device (a ring_shift passes a shard that stays on its device on as
it is, so callers never write into a received tensor).  Nothing here is a kernel of
the port.  A process-group backend (torch.distributed) can take their
place later without touching the callers.
"""
from __future__ import annotations

import torch


def _groups(mesh, axis):
    """Flat shard indices of each group along `axis`, in ring order."""
    ny, nx = mesh.grid
    if axis == "y":
        return [[yi * nx + xi for yi in range(ny)] for xi in range(nx)]
    if axis == "x":
        if not mesh.pencil:
            raise ValueError("a slab mesh has no 'x' axis")
        return [[yi * nx + xi for xi in range(nx)] for yi in range(ny)]
    if tuple(axis) == ("y", "x"):
        return [list(range(ny * nx))]
    raise ValueError(f"unknown mesh axis {axis!r}")


def ring_shift(mesh, shards, axis, shift: int):
    """shards[i] of the result is the shard `shift` places before i along
    `axis` (periodic), on shard i's device."""
    out = [None] * len(shards)
    for group in _groups(mesh, axis):
        n = len(group)
        for k, i in enumerate(group):
            src = shards[group[(k - shift) % n]]
            out[i] = src.to(mesh.device(i), non_blocking=True)
    return out


def all_to_all(mesh, shards, axis, split_axis: int, cat_axis: int):
    """Within each group along `axis`: shard j cuts its tensor into n
    pieces along `split_axis` (equal up to one, `torch.tensor_split`);
    shard i gets piece i of every j, joined along `cat_axis`."""
    out = [None] * len(shards)
    for group in _groups(mesh, axis):
        n = len(group)
        pieces = [shards[j].tensor_split(n, dim=split_axis) for j in group]
        for k, i in enumerate(group):
            dev = mesh.device(i)
            out[i] = torch.cat([p[k].to(dev, non_blocking=True)
                                for p in pieces], cat_axis)
    return out
