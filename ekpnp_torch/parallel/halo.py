"""The sharded time loop: the fused step per shard, with halo exchange
(port of ekpnp/parallel/halo.py).

A sharded state (parallel/mesh.py) runs, per shard, the fused step's
kernels on the shard's local block (kernels/fused_step.py: CUDA on the
card, the plain versions on the CPU), and the spectral solve distributed
over the mesh (ops/poisson.py with `mesh`).  Shards exchange only edge
data, through parallel/collectives.py.  `make_halo_multi_step`, the time
loop, cuts a chunk of n steps at the stream as the one-device loop does
(kernels/step.py `_chunk`):

  1. phi halo: each shard's first and last row of phi (psi_hx on the phi_hx
     route) go to its y-neighbours, and on a pencil its first and last
     column to its x-neighbours: the E stencil's off-shard reads
     (`phi_halos`; the .halo / .shard_x forms take them).  The stencil is a
     cross, so no corner is needed.
  2. collide per shard, once a chunk: post-collision populations into the
     second population set, and the RHS.
  3. post edges: each shard's post-collision edge data go to its
     neighbours, only the directions that pull across that edge (9 of 27
     on D3Q27, 5 of 19, 1 of 7): on a slab its edge rows (`post_rows`); on
     a pencil first its edge columns to the x-neighbours (`post_cols`),
     then its edge rows cut from its block widened by the two columns it
     received, so that the rows carry the diagonal shards' corner values
     (`post_edges`).  With overlap=True they travel on a side stream of
     each card while the solve runs, the counterpart of the JAX package's
     one-step-lookahead exchange (halo.py:48-61): the next launch waits for
     them, nothing else does.
  4. the solve of the RHS shards, distributed; then the phi halo of the new
     phi (1), on the main stream.
  5. the fused pass per shard (`fs.fused_pass` with rows, columns and phi
     halo): the stream of this step pulling across the shard's edges, and
     the collide of the next; back to 3, n - 1 times.  Nothing repairs a
     column after a pass: the pass collides what it pulls at once.
  6. the chunk's last stream per shard (stream_bc .halo form) from the
     rows, x wrapping locally; on a pencil `fix_x_columns` then repairs the
     two wrap columns by sending each shard's own wrap columns around the x
     ring, as the JAX package does (halo.py fix_x_columns): the locally
     wrapped column is what the x-neighbour needs, corners included, since
     the sender's stream already read its y-halo rows.

`step_halo` is one two-launch step (a collide and a stream per shard), to
which the chunk is held bit for bit.  This is not the TPU kernel's data
flow: there the halo travels as pre-collision 8-row blocks (DMA
alignment) and the halo rows are collided again.  Here post-collision
rows and columns travel instead, and only the pulling directions.  The
JAX package's EKPNP_OVERLAP switch is a plain argument here (`overlap`).

One deliberate difference: the JAX package's pencil path leaves the
scalar fields' wall planes out of the column repair (all_z=False), but
under charge_bc "zerograd-top" the ions' top plane IS x-streamed (from
plane NZ-2), so its wrap columns need the repair (and the pass's
columns carry every plane); here they get it, and the pencil result
equals the unsharded step there as everywhere.
"""
from __future__ import annotations

import contextlib
from functools import lru_cache
from typing import Optional

import torch

from ..config import Config
from ..kernels import fused_step as fs
from ..kernels.step import (COLLIDE, DECODE, ENCODE, PASS, SOLVE, STREAM,
                            phi_hx_capable)
from ..ops.poisson import (PhiHalo, efield, phi_from_psi_hx,
                           poisson_phi_from_rhs, poisson_psi_hx_from_rhs,
                           psi_hx_from_phi)
from ..state import State
from ..telemetry import CHUNK, PREFIX, span
from .collectives import ring_shift

# the edge exchanges' span (telemetry): the phi halo, a set of post edges,
# the pencil's wrap-column repair, each around its ring_shift calls
EXCHANGE = PREFIX + "exchange"
from .mesh import Mesh, fields, local_cfg, shard


def _lattices(cfg: Config):
    return (cfg.lattice,) + (cfg.scalar_lat,) * 3


@lru_cache(maxsize=None)
def _dirs(lat, axis: int, sign: int, device: torch.device):
    """fs.edge_dirs(lat, sign, axis) as an index tensor on `device`."""
    return torch.tensor(fs.edge_dirs(lat, sign, axis), device=device)


@lru_cache(maxsize=None)
def _corners(lat, ey: int, device: torch.device):
    """For the rows of the directions with this ey (`_dirs(lat, 1, ey)`):
    the places of those with ex = +1 and their slots among the ex = +1
    columns, then the same for ex = -1, as index tensors on `device`: where
    a widened row takes its end values from the received columns."""
    dirs = fs.edge_dirs(lat, ey, 1)
    out = []
    for ex in (1, -1):
        xd = fs.edge_dirs(lat, ex, 0)
        at = [i for i, d in enumerate(dirs) if d in xd]
        out += [at, [xd.index(dirs[i]) for i in at]]
    return tuple(torch.tensor(v, dtype=torch.long, device=device)
                 for v in out)


def phi_halos(mesh: Mesh, phi):
    """The phi (or psi_hx) halo of every shard: rows y = -1 and y = NYl
    from the y-neighbours, and on a pencil columns x = -1 and x = NXl from
    the x-neighbours."""
    with span(EXCHANGE):
        return _phi_halos(mesh, phi)


def _phi_halos(mesh: Mesh, phi):
    edge = lambda sel: mesh.each(lambda i: sel(phi[i]).contiguous())
    ylo = ring_shift(mesh, edge(lambda p: p[:, -1]), "y", 1)
    yhi = ring_shift(mesh, edge(lambda p: p[:, 0]), "y", -1)
    if not mesh.pencil:
        return mesh.each(lambda i: PhiHalo(ylo[i], yhi[i]))
    xlo = ring_shift(mesh, edge(lambda p: p[:, :, -1]), "x", 1)
    xhi = ring_shift(mesh, edge(lambda p: p[:, :, 0]), "x", -1)
    return mesh.each(lambda i: PhiHalo(ylo[i], yhi[i], xlo[i], xhi[i]))


def _exchange(cfg_l: Config, mesh: Mesh, posts, axis: str, pick):
    """Per shard, per field, (lo, hi) = what `pick(i, k, lat, edge, sign)`
    cuts from shard i's field k at its last (edge -1, sign +1) or first
    (edge 0, sign -1) row or column, received from the neighbour before /
    after along mesh axis `axis`; None for an inactive field."""
    with span(EXCHANGE):
        return _exchange_fields(cfg_l, mesh, posts, axis, pick)


def _exchange_fields(cfg_l: Config, mesh: Mesh, posts, axis: str, pick):
    per_field = []
    for k, lat in enumerate(_lattices(cfg_l)):
        if posts[mesh.local[0]][k] is None:
            per_field.append([None] * mesh.size)
            continue
        cut = lambda edge, sign: mesh.each(
            lambda i: pick(i, k, lat, edge, sign))
        lo = ring_shift(mesh, cut(-1, 1), axis, 1)
        hi = ring_shift(mesh, cut(0, -1), axis, -1)
        per_field.append(list(zip(lo, hi)))
    return mesh.each(lambda i: tuple(f[i] for f in per_field))


def post_cols(cfg_l: Config, mesh: Mesh, posts):
    """posts: per shard (pf, ph, phn, pg) on a pencil (None for another
    process's shard, here and below).  Returns per shard
    the `cols` argument of its pass: per field (xlo, xhi) = the
    x-neighbours' post-collision columns x = -1 / x = NXl, the directions
    with ex = +1 / -1 only, every z plane (the ions' top plane under
    zerograd-top pulls along x from plane NZ-2), (n, NZ, NYl) each, or None
    for an inactive field."""
    def pick(i, k, lat, x, ex):
        a = posts[i][k]
        return a[..., x].index_select(0, _dirs(lat, 0, ex, a.device))
    return _exchange(cfg_l, mesh, posts, "x", pick)


def post_rows(cfg_l: Config, mesh: Mesh, posts, cols=None):
    """posts: per shard (pf, ph, phn, pg).  Returns per shard the `rows`
    argument of its stream: per field (lo, hi) = the y-neighbours'
    post-collision rows y = -1 / y = NYl, the directions with ey = +1 / -1
    only (kernels/fused_step.edge_dirs), or None for an inactive field.
    cols: on a pencil, per shard the columns it has received (`post_cols`):
    each row is then cut from the sender's block widened by those columns,
    columns -1 .. NXl, so that a row carries the diagonal shard's corner
    values (the rows of a pencil's pass)."""
    def pick(i, k, lat, y, ey):
        a = posts[i][k]
        row = a[:, :, y].index_select(0, _dirs(lat, 1, ey, a.device))
        if cols is None:
            return row
        lo, hi = cols[i][k]  # columns -1 .. NXl
        pp, sp, pm, sm = _corners(lat, ey, a.device)
        wide = row.new_zeros(row.shape[:2] + (row.shape[2] + 2,))
        wide[:, :, 1:-1] = row
        wide[pp, :, 0] = lo[sp, :, y]
        wide[pm, :, -1] = hi[sm, :, y]
        return wide
    return _exchange(cfg_l, mesh, posts, "y", pick)


def post_edges(cfg_l: Config, mesh: Mesh, posts):
    """Per shard the (rows, cols) of its pass: on a slab the rows of
    `post_rows` and no columns; on a pencil the columns first, then the
    rows widened by them (the diagonal shards' corners ride the rows)."""
    if not mesh.pencil:
        return [(r, None) for r in post_rows(cfg_l, mesh, posts)]
    cols = post_cols(cfg_l, mesh, posts)
    return list(zip(post_rows(cfg_l, mesh, posts, cols), cols))


def fix_x_columns(cfg_l: Config, mesh: Mesh, outs) -> None:
    """Repair, in place, the two x-wrap columns of every shard's streamed
    populations (outs: per shard (f1, h1, hn1, g1)) on a pencil: the stream
    wrapped x locally, so column 0 of an ex = +1 direction holds this
    shard's post[.., x = NXl-1], which is what the right x-neighbour needs
    in its column 0 (and the mirror for ex = -1).  The fluid's every plane
    streams; a scalar's wall planes are reflections at the node and keep
    their values, except the ions' top plane under zerograd-top, which
    streams from plane NZ-2."""
    with span(EXCHANGE):
        _fix_x_columns(cfg_l, mesh, outs)


def _fix_x_columns(cfg_l: Config, mesh: Mesh, outs) -> None:
    nz = cfg_l.grid.nz
    zg = cfg_l.physics.charge_bc == "zerograd-top"
    for k, lat in enumerate(_lattices(cfg_l)):
        if outs[mesh.local[0]][k] is None:
            continue
        zs = (slice(None) if k == 0 else
              slice(1, nz) if zg and k in (1, 2) else slice(1, nz - 1))
        for sign, lane, shift in ((1, 0, 1), (-1, -1, -1)):
            idx = mesh.each(lambda i: _dirs(lat, 0, sign, outs[i][k].device))
            cols = mesh.each(lambda i: outs[i][k][idx[i], zs, :, lane])
            got = ring_shift(mesh, cols, "x", shift)
            for i in mesh.local:
                outs[i][k][idx[i], zs, :, lane] = got[i]


@lru_cache(maxsize=None)
def _side_stream(device: torch.device):
    return torch.cuda.Stream(device=device)


def _on_side_streams(mesh: Mesh, fn):
    """Run fn() on a side stream of each card of the mesh, after the work
    queued so far; returns (result, join), join() making the cards' current
    streams wait for it.  Without cards, fn() runs as it is."""
    cards = sorted({d for d in mesh.devices if d.type == "cuda"}, key=str)
    if not cards:
        return fn(), lambda: None
    mains = {d: torch.cuda.current_stream(d) for d in cards}
    for d in cards:
        _side_stream(d).wait_stream(mains[d])
    with contextlib.ExitStack() as stack:
        for d in cards:
            stack.enter_context(torch.cuda.stream(_side_stream(d)))
        result = fn()

    def join():
        for d in cards:
            mains[d].wait_stream(_side_stream(d))
        for t in _tensors(result):
            t.record_stream(mains[t.device])
    return result, join


def _tensors(x):
    """The tensors of a nest of tuples and lists."""
    if torch.is_tensor(x):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)


def step_halo(cfg: Config, mesh: Mesh, state: State, phi_hx: bool = False,
              overlap: bool = True) -> State:
    """One two-launch step of a sharded state: per shard a collide and a
    stream with the halo exchange, and the distributed solve.  phi_hx:
    state.phi holds psi_hx (slab meshes; the halo rows travel as psi and
    the collide decodes them)."""
    p = cfg.physics
    cfg_l = local_cfg(cfg, mesh)
    ek = p.enable_ek
    # pencil shards take the plain RHS: the x-Hartley forms need x whole
    hx = fs.resolve_hartley_x(cfg_l, False if mesh.pencil else None, phi_hx)
    halos = phi_halos(mesh, state.phi) if ek else [None] * mesh.size
    posts, rhs = [None] * mesh.size, [None] * mesh.size
    for i in mesh.local:
        st = shard(state, i)
        *pc, rhs[i] = fs.collide(cfg_l, st.f, st.h, st.hn, st.g, st.phi,
                                 hartley_x=hx, phi_hx=phi_hx,
                                 phi_halo=halos[i])
        posts[i] = tuple(pc)
    if overlap:
        rows, join = _on_side_streams(mesh, lambda: post_rows(cfg_l, mesh,
                                                              posts))
    else:
        rows, join = post_rows(cfg_l, mesh, posts), (lambda: None)
    phi = state.phi
    if ek:
        phi = (poisson_psi_hx_from_rhs(cfg, rhs, mesh) if phi_hx else
               poisson_phi_from_rhs(cfg, rhs, mesh, rhs_hx=hx))
    join()
    outs = mesh.each(lambda i: fs.stream_bc(cfg_l, *posts[i], rows=rows[i]))
    if mesh.pencil:
        fix_x_columns(cfg_l, mesh, outs)
    return State(*(fields(mesh, outs, k) for k in range(4)), phi=phi,
                 t=state.t + p.dt(cfg.grid.dx))


def make_halo_multi_step(cfg: Config, mesh: Mesh, n: int,
                         overlap: bool = True,
                         phi_hx: Optional[bool] = None):
    """fn(state) -> state: n steps of a sharded state, cut at the stream as
    kernels/step.py `_chunk` cuts one device's: per shard one collide of
    the route's shard form, then n - 1 fused passes (the stream of step
    k - 1 and the collide of step k; `fs.fused_pass` with the shard's edge
    rows and, on a pencil, columns), then one stream (and on a pencil
    `fix_x_columns`).  Equal to n `step_halo` steps bit for bit.

    After the collide or pass of step k, the edge exchange of step k's
    post-collision set goes on a side stream of each card (overlap=True;
    serial with overlap=False) while the distributed solve runs, the phi
    halo of the new phi on the main stream; the next pass waits for both.
    On a pencil the exchange sends the x columns first and then the rows
    cut from the block widened by them (`post_edges`); the chunk's last
    exchange is the stream's rows (`post_rows`).  Two population sets
    ping-pong per shard: the input state's, DONATED, and one more.

    Where the shard can carry phi as psi_hx (`phi_hx_capable` of the local
    config, slab meshes only: the codec needs x whole) the chunk encodes
    once, decodes once and runs the phi_hx route, as the JAX package's
    chunk does; phi_hx=False forces real phi between steps (the hartley_x
    form on slabs).  Raises for a mesh the step cannot take
    (divisibility)."""
    cfg_l = local_cfg(cfg, mesh)
    capable = not mesh.pencil and phi_hx_capable(cfg_l)
    hx = capable if phi_hx is None else phi_hx
    if hx and not capable:
        raise ValueError("phi_hx needs a slab mesh and phi_hx_capable")
    ek = cfg.physics.enable_ek
    dt = cfg.physics.dt(cfg.grid.dx)
    # pencil shards take the plain RHS: the x-Hartley forms need x whole
    rhs_hx = fs.resolve_hartley_x(cfg_l, False if mesh.pencil else None, hx)
    form = dict(hartley_x=rhs_hx, phi_hx=hx)
    each = mesh.each

    def exchange(posts, last: bool):
        """The edges of the post sets (per shard (rows, cols)) and the join
        the next launch waits for."""
        def edges():
            if last:
                return [(r, None) for r in post_rows(cfg_l, mesh, posts)]
            return post_edges(cfg_l, mesh, posts)
        if overlap:
            return _on_side_streams(mesh, edges)
        return edges(), (lambda: None)

    def run(state: State) -> State:
        if n <= 0:
            return state
        with span(CHUNK):
            return chunk(state)

    def chunk(state: State) -> State:
        if hx:
            with span(ENCODE):
                state = state._replace(phi=psi_hx_from_phi(cfg, state.phi,
                                                           mesh))
        phi, t = state.phi, state.t
        spare = each(lambda i: tuple(shard(state, i)[:4]))
        halos = phi_halos(mesh, phi) if ek else [None] * mesh.size
        with span(COLLIDE):
            outs = each(lambda i: fs.collide(
                cfg_l, *spare[i], None if phi is None else phi[i],
                post=fs._empty_like_fields(cfg_l, spare[i][0]),
                phi_halo=halos[i], **form))
        posts, rhs = each(lambda i: tuple(outs[i][:4])), fields(mesh, outs, 4)
        del state, outs
        for k in range(n):
            last = k == n - 1
            edges, join = exchange(posts, last)
            if ek:
                with span(SOLVE):
                    phi = (poisson_psi_hx_from_rhs(cfg, rhs, mesh) if hx else
                           poisson_phi_from_rhs(cfg, rhs, mesh,
                                                rhs_hx=rhs_hx))
                if not last:
                    halos = phi_halos(mesh, phi)
            t = t + dt
            join()
            if last:
                break
            with span(PASS):
                nxt = each(lambda i: fs.fused_pass(
                    cfg_l, *posts[i], None if phi is None else phi[i],
                    out=spare[i], rows=edges[i][0], cols=edges[i][1],
                    phi_halo=halos[i], **form))
            spare, posts = posts, each(lambda i: tuple(nxt[i][:4]))
            rhs = fields(mesh, nxt, 4)
        with span(STREAM):
            outs = each(lambda i: fs.stream_bc(cfg_l, *posts[i],
                                               out=spare[i],
                                               rows=edges[i][0]))
        if mesh.pencil:
            fix_x_columns(cfg_l, mesh, outs)
        state = State(*(fields(mesh, outs, k) for k in range(4)), phi=phi,
                      t=t)
        if hx:
            with span(DECODE):
                state = state._replace(phi=phi_from_psi_hx(cfg, state.phi,
                                                           mesh))
        return state

    return run


def shard_macros(cfg: Config, mesh: Mesh, state: State):
    """(Macro, E) of every shard of a sharded state (None for another
    process's), E from the phi halo (the diagnostics' and the dumps'
    fields)."""
    from ..ops.collide import compute_macro

    cfg_l = local_cfg(cfg, mesh)
    ek = cfg.physics.enable_ek
    halos = phi_halos(mesh, state.phi) if ek else [None] * mesh.size

    def one(i):
        st = shard(state, i)
        E = efield(cfg_l, st.phi, halos[i]) if ek else None
        return compute_macro(cfg_l, st, E=E)[0], E
    return mesh.each(one)
