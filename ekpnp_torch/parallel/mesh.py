"""Device mesh and sharded state (port of ekpnp/parallel/mesh.py).

A sharded run cuts the (Q, Z, Y, X) state over a grid of devices, as the
JAX package does:
  - slab:   mesh axes ("y",), y cut into equal slabs;
  - pencil: mesh axes ("y", "x"), y and x cut, the near-square
    factorisation of the shard count.
z is never cut: it carries the wall physics and the DST, so every wall
update stays on its shard.

One process drives every shard, as `ekpnp run --mesh` drives every local
device, or (`run --distributed`) each of `world` processes drives its own
contiguous block of shards in mesh order: shard i belongs to process
i // (size // world), as the JAX package's global mesh orders its devices
by process.  A `Mesh` holds one torch device per shard, and a device may
appear more than once: several shards on one device (the CPU tests put 4
shards in one process, as the JAX tests use 8 virtual CPU devices; the
smoke puts 4 on its one card).  A sharded field is a list of per-shard
tensors in mesh order (row-major over ("y", "x")), with None where
another process owns the shard (`Mesh.each`); a sharded `State` holds
such lists in its field slots and `t` as one 0-d tensor on the first
local shard's device (every process holds the same t).

The TPU's shard rules (y-slabs of 8 rows, pencil x-shards of whole
128-lane tiles, parallel/halo.py supports_halo_step) are tiling rules of
its kernel and are not carried over: the CUDA kernels index any shard
width, so only divisibility is checked (and the solve's repartitions,
parallel/fft.py).  There is no GSPMD fallback: the sharded time loop is
parallel/halo.py's, on the card its kernels.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch

from ..config import Config
from ..state import Macro, State

_POPS = ("f", "h", "hn", "g")


def _indexed(d: torch.device) -> torch.device:
    """A card's device with its index ("cuda" -> "cuda:<current>")."""
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """A grid of torch devices with axes ("y",) (a slab: grid (n, 1)) or
    ("y", "x") (a pencil): one shard per entry, in row-major order.

    rank, world: this process and the process count of a distributed run
    (the default process group's, which must be initialised: NCCL for a
    mesh on cards, Gloo on the CPU).  The devices of another process's
    shards are never used here."""

    def __init__(self, devices: Sequence, grid, pencil: bool, rank: int = 0,
                 world: int = 1):
        devices = [_indexed(torch.device(d)) for d in devices]
        ny, nx = grid
        if ny * nx != len(devices) or (nx != 1 and not pencil):
            raise ValueError(f"mesh {grid} does not hold {len(devices)} "
                             f"devices")
        if len(devices) % world or not 0 <= rank < world:
            raise ValueError(f"{len(devices)} shards cannot be dealt to "
                             f"{world} processes (rank {rank})")
        if world > 1:
            _check_process_group(devices[0], rank, world)
        self.devices = devices
        self.grid = (ny, nx)
        self.pencil = pencil
        self.rank, self.world = rank, world
        per = len(devices) // world
        self.local = list(range(rank * per, (rank + 1) * per))

    def owner(self, i: int) -> int:
        """The process that holds shard i."""
        return i // (self.size // self.world)

    def is_local(self, i: int) -> bool:
        return self.owner(i) == self.rank

    def each(self, fn):
        """[fn(i) for this process's shards, None for the others], in mesh
        order: a sharded field."""
        return [fn(i) if self.is_local(i) else None for i in range(self.size)]

    @property
    def axis_names(self):
        return ("y", "x") if self.pencil else ("y",)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.grid))

    @property
    def size(self) -> int:
        return len(self.devices)

    def device(self, i: int) -> torch.device:
        return self.devices[i]

    def coords(self, i: int):
        """(y, x) position of shard i on the mesh."""
        return divmod(i, self.grid[1])

    def block(self, cfg: Config, i: int):
        """(y0, ny, x0, nx): the global offsets and extents of shard i."""
        yi, xi = self.coords(i)
        nyl, nxl = cfg.grid.ny // self.grid[0], cfg.grid.nx // self.grid[1]
        return yi * nyl, nyl, xi * nxl, nxl

    def __repr__(self):
        where = f", rank {self.rank} of {self.world}" if self.world > 1 else ""
        return f"Mesh({self.shape}, {[str(d) for d in self.devices]}{where})"


def _check_process_group(device: torch.device, rank: int, world: int):
    """A distributed mesh needs the default process group of its rank and
    world, on the backend of its devices: NCCL for cards, Gloo for the
    CPU (no other, and no switch between them)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("a mesh over several processes needs "
                           "torch.distributed.init_process_group first")
    if (dist.get_rank(), dist.get_world_size()) != (rank, world):
        raise ValueError(f"mesh rank {rank} of {world}, process group rank "
                         f"{dist.get_rank()} of {dist.get_world_size()}")
    want = "nccl" if device.type == "cuda" else "gloo"
    if dist.get_backend() != want:
        raise ValueError(f"a mesh on {device.type} runs over {want}, the "
                         f"process group is {dist.get_backend()}")


def make_mesh(devices: Sequence, pencil: bool = False, rank: int = 0,
              world: int = 1) -> Mesh:
    """A slab mesh over `devices`, or a pencil with the near-square
    factorisation (y extent the largest divisor <= sqrt(n)); rank and world
    of a distributed run (`Mesh`)."""
    n = len(devices)
    if not pencil:
        return Mesh(devices, (n, 1), False, rank, world)
    yf = math.isqrt(n)
    while n % yf:
        yf -= 1
    return Mesh(devices, (yf, n // yf), True, rank, world)


def mesh_devices(device: torch.device, n: Optional[int] = None,
                 world: Optional[int] = None):
    """n shard devices.  One process (world None): placed round-robin over
    the devices of `device`'s kind (every card for "cuda"; the one CPU for
    "cpu"), n defaulting to the number of such devices.  One of `world`
    processes of a distributed run: every shard on this process's device
    (its current card, stacked when it holds several), n a multiple of
    `world` defaulting to one shard per process."""
    device = torch.device(device)
    if world is not None:
        n = n or world
        if n % world:
            raise ValueError(f"{n} shards are not a multiple of the "
                             f"{world} processes")
        return [_indexed(device)] * n
    count = torch.cuda.device_count() if device.type == "cuda" else 1
    n = n or count
    if device.type == "cuda":
        return [torch.device("cuda", i % count) for i in range(n)]
    return [torch.device("cpu")] * n


def check_divisibility(cfg: Config, mesh: Mesh) -> None:
    ny, nx = mesh.grid
    if cfg.grid.ny % ny:
        raise ValueError(
            f"ny={cfg.grid.ny} not divisible by mesh y-extent {ny}")
    if mesh.pencil and cfg.grid.nx % nx:
        raise ValueError(
            f"nx={cfg.grid.nx} not divisible by mesh x-extent {nx}")


def local_cfg(cfg: Config, mesh: Mesh) -> Config:
    """The config of one shard: its local (ny, nx)."""
    check_divisibility(cfg, mesh)
    ny, nx = mesh.grid
    return dataclasses.replace(cfg, grid=dataclasses.replace(
        cfg.grid, ny=cfg.grid.ny // ny, nx=cfg.grid.nx // nx))


def shard_field(cfg: Config, mesh: Mesh, a):
    """Per-shard copies of a global field (..., NY, NX), each on its
    device (this process's shards; None for the others)."""
    def cut(i):
        y0, nyl, x0, nxl = mesh.block(cfg, i)
        return a[..., y0:y0 + nyl, x0:x0 + nxl].to(
            mesh.device(i), copy=True, memory_format=torch.contiguous_format)
    return mesh.each(cut)


def gather_field(mesh: Mesh, shards, device=None):
    """The global field from its shards (exact: concatenation), on
    `device` (default: the first local shard's); over several processes on
    rank 0 alone (None on the others)."""
    from .collectives import to_rank0

    shards = to_rank0(mesh, shards)
    if shards is None:
        return None
    device = device or shards[0].device
    ny, nx = mesh.grid
    rows = [torch.cat([shards[yi * nx + xi].to(device) for xi in range(nx)],
                      dim=-1) for yi in range(ny)]
    return torch.cat(rows, dim=-2)


def shard_state(cfg: Config, mesh: Mesh, state: State) -> State:
    """Place a state onto the mesh (copies; drop the original to free it);
    this process's shards only."""
    check_divisibility(cfg, mesh)
    cut = lambda a: None if a is None else shard_field(cfg, mesh, a)
    return State(*(cut(getattr(state, k)) for k in _POPS + ("phi",)),
                 t=state.t.to(mesh.device(mesh.local[0]), copy=True))


def gather_state(mesh: Mesh, state: State, device=None):
    """The unsharded state (exact); over several processes on rank 0 alone
    (None on the others, which must call it too)."""
    join = lambda a: None if a is None else gather_field(mesh, a, device)
    whole = [join(getattr(state, k)) for k in _POPS + ("phi",)]
    if mesh.rank != 0:
        return None
    return State(*whole, t=state.t.to(device or state.t.device))


def fields(mesh: Mesh, per_shard, k: int):
    """Field k of per-shard tuples (None for another process's shard) as a
    sharded field, or None where the field is absent."""
    if per_shard[mesh.local[0]][k] is None:
        return None
    return [None if s is None else s[k] for s in per_shard]


def shard(state: State, i: int) -> State:
    """Shard i of a sharded state, as a plain `State`."""
    at = lambda a: None if a is None else a[i]
    return State(*(at(getattr(state, k)) for k in _POPS + ("phi",)),
                 t=state.t)


def make_sharded_step(cfg: Config, mesh: Mesh, perturb: bool = False):
    """One plain step of a sharded state per shard (the plain version of
    every kernel, on each shard's device): the JAX package runs its first
    step under a mesh through its GSPMD oracle (mesh.py make_sharded_step,
    run.py:356-361), here with the perturbation seeded at each shard's
    global coordinates.  Returns fn(state) -> (state', macro) with the
    Macro's fields lists of shards; the solve is the plain step's
    (ops.poisson.poisson_phi), distributed."""
    from ..kernels.fused_step import stream_bc_reference
    from ..ops.poisson import efield, poisson_phi
    from ..step import collide_and_reflect
    from .halo import fix_x_columns, phi_halos, post_rows

    cfg_l = local_cfg(cfg, mesh)
    ek = cfg.physics.enable_ek

    def run(state: State):
        halos = phi_halos(mesh, state.phi) if ek else [None] * mesh.size

        def one(i):
            st = shard(state, i)
            y0, _, x0, _ = mesh.block(cfg, i)
            E = efield(cfg_l, st.phi, halos[i]) if ek else None
            post, macro = collide_and_reflect(cfg_l, st, perturb=perturb,
                                              E=E, origin=(y0, x0))
            return tuple(post), macro

        pm = mesh.each(one)
        posts, macros = fields(mesh, pm, 0), fields(mesh, pm, 1)
        rows = post_rows(cfg_l, mesh, posts)
        outs = mesh.each(lambda i: stream_bc_reference(cfg_l, *posts[i],
                                                       rows=rows[i]))
        if mesh.pencil:
            fix_x_columns(cfg_l, mesh, outs)
        phi = state.phi
        if ek:
            phi = poisson_phi(cfg, fields(mesh, macros, 2),
                              fields(mesh, macros, 3), mesh)
        new = State(*(fields(mesh, outs, k) for k in range(4)), phi=phi,
                    t=state.t + cfg.physics.dt(cfg.grid.dx))
        macro = Macro(*(fields(mesh, macros, k) for k in range(5)))
        return new, macro

    return run


def make_sharded_multi_step(cfg: Config, mesh: Mesh, n: int,
                            overlap: bool = True):
    """n steps of a sharded state: fn(state) -> state, the sharded time
    loop of parallel/halo.py (the kernels on the card, their plain versions
    on the CPU).  The input state's population tensors are donated."""
    from .halo import make_halo_multi_step

    return make_halo_multi_step(cfg, mesh, n, overlap=overlap)
