"""The collectives of a sharded run, within one process or across the
processes of a distributed one.

A sharded field is a list of per-shard tensors in mesh order (row-major
over the mesh axes, parallel/mesh.py), each on its mesh device, None where
another process owns the shard.  Shards talk only through these
operations, the counterparts of what the JAX package's sharded step uses:

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
      `torch.tensor_split` cuts it (the first pieces one longer,
      `even_cut`), as XLA pads an uneven sharding: the reference's 50-wide
      x axis over 4 slabs.  A caller that joined pieces of unequal extents
      names them (`split_sizes`, `cat_sizes`), so that the way back cuts
      exactly what the way out joined: the pencil's y rows, cut over x
      and joined over the whole mesh (parallel/fft.py);
  gather_rows, to_rank0  the per-shard partials of the diagnostics on
      every process, a whole field on rank 0 (the tests' and the smoke's
      gathers).

`axis` is a mesh axis name, "y" or "x", or ("y", "x") for the whole mesh
taken as one ring in mesh order.  A pair of shards of one process moves by
slicing, `torch.cat` and `tensor.to(device, non_blocking=True)`: a peer
copy between cards, nothing on one device (a ring_shift passes a shard that
stays on its device on as it is, so callers never write into a received
tensor).  A pair that crosses processes moves by `torch.distributed`
point-to-point messages over the default process group (NCCL between
cards, Gloo on the CPU): every process walks the same global list of pairs
(group, then ring position), so both ends issue a message in the same
order (NCCL matches by order) and give it the same tag, dst * size + src
(Gloo matches by tag), and one call's messages go out as one
`batch_isend_irecv`.  Receive buffers are shaped from the mesh, without a
round trip: every piece has the receiving shard's shape except along
the two axes of an all_to_all, where the caller's extents (or
`even_cut`'s) give it.  Received tensors are ready on the current
stream when a call returns (`Work.wait`).  Nothing here is a kernel of
the port.

Telemetry: all_to_all and gather_rows are spans of their own (the
ring_shift calls sit in parallel/halo.py's exchange spans); every call
that sends or receives across processes adds one to
`ekpnp_torch.collective.calls.<op>` and the bytes this process sends to
`ekpnp_torch.collective.bytes.<op>`.
"""
from __future__ import annotations

import torch

from ..telemetry import PREFIX, count, span

COLLECTIVE = PREFIX + "collective."


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


def even_cut(extent: int, n: int):
    """The piece extents of `torch.tensor_split(n)` of `extent`: equal up
    to one, the first pieces the longer."""
    q, r = divmod(extent, n)
    return [q + 1] * r + [q] * (n - r)


def _wire(t):
    """A tensor as it travels: complex as its real pairs (NCCL has no
    complex type)."""
    return torch.view_as_real(t) if t.is_complex() else t


def _counted(op: str, sent: int) -> None:
    count(COLLECTIVE + "calls." + op)
    count(COLLECTIVE + "bytes." + op, sent)


class _Messages:
    """The cross-process messages of one call of `op`, in the global pair
    order; `run` sends them all and waits."""

    def __init__(self, mesh, op: str):
        self.mesh, self.op = mesh, op
        self.ops = []
        self.sent = 0

    def pair(self, src: int, dst: int, send=None, recv=None):
        """The move of shard src's `send` (when src is here) into shard
        dst's buffer `recv` (when dst is here) across processes."""
        import torch.distributed as dist

        tag = dst * self.mesh.size + src
        if send is not None:
            wire = _wire(send.contiguous())
            self.sent += wire.numel() * wire.element_size()
            self.ops.append(dist.P2POp(dist.isend, wire,
                                       self.mesh.owner(dst), tag=tag))
        if recv is not None:
            self.ops.append(dist.P2POp(dist.irecv, _wire(recv),
                                       self.mesh.owner(src), tag=tag))
        return recv

    def run(self):
        import torch.distributed as dist

        if self.ops:
            _counted(self.op, self.sent)
            for work in dist.batch_isend_irecv(self.ops):
                work.wait()
        self.ops = []
        self.sent = 0


def ring_shift(mesh, shards, axis, shift: int):
    """shards[i] of the result is the shard `shift` places before i along
    `axis` (periodic), on shard i's device."""
    out = [None] * len(shards)
    msgs = _Messages(mesh, "ring_shift")
    for group in _groups(mesh, axis):
        n = len(group)
        for k, i in enumerate(group):
            j = group[(k - shift) % n]
            here_i, here_j = mesh.is_local(i), mesh.is_local(j)
            if here_i and here_j:
                out[i] = shards[j].to(mesh.device(i), non_blocking=True)
            elif here_i:
                out[i] = msgs.pair(j, i, recv=torch.empty_like(shards[i]))
            elif here_j:
                msgs.pair(j, i, send=shards[j])
    msgs.run()
    return out


def all_to_all(mesh, shards, axis, split_axis: int, cat_axis: int,
               split_sizes=None, cat_sizes=None):
    """Within each group along `axis`: shard j cuts its tensor into n
    pieces along `split_axis`; shard i gets piece i of every j, joined
    along `cat_axis` in j order.

    split_sizes: the extents of the n pieces each shard cuts, in group
    order (the same for every shard of every group); by default
    `even_cut` of its extent.  cat_sizes: the extents along `cat_axis` of
    the pieces a shard joins, per sender in group order; by default the
    receiving shard's own extent for every piece.  Both follow from the
    mesh and the layout, so no process asks another for a shape."""
    with span(PREFIX + "all_to_all"):
        return _all_to_all(mesh, shards, axis, split_axis, cat_axis,
                           split_sizes, cat_sizes)


def _all_to_all(mesh, shards, axis, split_axis, cat_axis, split_sizes,
                cat_sizes):
    out = [None] * len(shards)
    msgs = _Messages(mesh, "all_to_all")
    parts = {}
    for group in _groups(mesh, axis):
        n = len(group)
        cut = lambda extent: (even_cut(extent, n) if split_sizes is None
                              else list(split_sizes))
        pieces = {j: shards[j].split(cut(shards[j].shape[split_axis]),
                                     dim=split_axis)
                  for j in group if mesh.is_local(j)}
        for k, i in enumerate(group):
            here_i = mesh.is_local(i)
            if here_i:
                like = shards[i]
                shape = list(like.shape)
                shape[split_axis] = cut(shape[split_axis])[k]
                cat = (cat_sizes if cat_sizes is not None
                       else [shape[cat_axis]] * n)
                parts[i] = []
            for m, j in enumerate(group):
                here_j = j in pieces
                if here_i and here_j:
                    parts[i].append(pieces[j][k].to(mesh.device(i),
                                                    non_blocking=True))
                elif here_i:
                    shape[cat_axis] = cat[m]
                    parts[i].append(msgs.pair(j, i,
                                              recv=like.new_empty(shape)))
                elif here_j:
                    msgs.pair(j, i, send=pieces[j][k])
    msgs.run()
    for i, p in parts.items():
        out[i] = torch.cat(p, cat_axis)
    return out


def gather_rows(mesh, rows):
    """rows: (L, ...) with one row per shard of this process, in mesh order.
    Returns (size, ...): every shard's row on every process, in mesh order
    (an all-gather; one process: `rows` itself)."""
    if mesh.world == 1:
        return rows
    import torch.distributed as dist

    with span(PREFIX + "gather_rows"):
        rows = rows.contiguous()
        _counted("gather_rows",
                 rows.numel() * rows.element_size() * (mesh.world - 1))
        out = [torch.empty_like(rows) for _ in range(mesh.world)]
        dist.all_gather(out, rows)
        return torch.cat(out)


def to_rank0(mesh, shards):
    """Every shard's tensor (equal shapes) in mesh order on rank 0, on the
    device of its first shard; None on the other ranks.  One process:
    `shards` itself."""
    if mesh.world == 1:
        return shards
    out = list(shards)
    msgs = _Messages(mesh, "to_rank0")
    like = shards[mesh.local[0]]
    for i in range(mesh.size):
        if mesh.owner(i) == 0:
            continue
        if mesh.rank == 0:
            out[i] = msgs.pair(i, 0, recv=torch.empty_like(like))
        elif mesh.is_local(i):
            msgs.pair(i, 0, send=shards[i])
    msgs.run()
    return out if mesh.rank == 0 else None
