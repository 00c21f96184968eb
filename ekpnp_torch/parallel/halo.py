"""The sharded time loop: the fused step per shard, with halo exchange
(port of ekpnp/parallel/halo.py).

Each step of a sharded state (parallel/mesh.py) runs, per shard, the fused
step's kernels on the shard's local block (kernels/fused_step.py: CUDA on
the card, the plain versions on the CPU), and the spectral solve
distributed over the mesh (ops/poisson.py with `mesh`).  Shards exchange
only edge data, through parallel/collectives.py:

  1. phi halo: each shard's first and last row of phi (psi_hx on the phi_hx
     route) go to its y-neighbours, and on a pencil its first and last
     column to its x-neighbours: the E stencil's off-shard reads
     (`phi_halos`; the collide's .halo / .shard_x forms take them).  The
     stencil is a cross, so no corner is needed.
  2. collide per shard: post-collision populations into a scratch set, and
     the RHS.
  3. post rows: each shard's post-collision edge rows go to its
     y-neighbours, only the directions that pull across that edge (9 of 27
     on D3Q27, 5 of 19, 1 of 7; `post_rows`).  With overlap=True they
     travel on a side stream of each card while the solve runs, the
     counterpart of the JAX package's one-step-lookahead exchange
     (halo.py:48-61): the stream launch waits for them, nothing else does.
  4. the solve of the RHS shards, distributed.
  5. stream per shard (stream_bc .halo form), x wrapping locally; on a
     pencil `fix_x_columns` then repairs the two wrap columns by sending
     each shard's own wrap columns around the x ring, as the JAX package
     does (halo.py fix_x_columns): the locally wrapped column is what the
     x-neighbour needs, corners included, since the sender's stream already
     read its y-halo rows.

This is not the TPU kernel's data flow: there the halo travels as
pre-collision 8-row blocks (DMA alignment) and the halo rows are collided
again.  The two-launch split lets post-collision rows travel instead, and
only the pulling directions.  The JAX package's EKPNP_OVERLAP switch is a
plain argument here (`overlap`).

One deliberate difference: the JAX package's pencil path leaves the
scalar fields' wall planes out of the column repair (all_z=False), but
under charge_bc "zerograd-top" the ions' top plane IS x-streamed (from
plane NZ-2), so its wrap columns need the repair too; here they get it,
and the pencil result equals the unsharded step there as everywhere.
"""
from __future__ import annotations

import contextlib
from functools import lru_cache
from typing import Optional

import torch

from ..config import Config
from ..kernels import fused_step as fs
from ..kernels.step import phi_hx_capable
from ..ops.poisson import (PhiHalo, efield, phi_from_psi_hx,
                           poisson_phi_from_rhs, poisson_psi_hx_from_rhs,
                           psi_hx_from_phi)
from ..state import State
from .collectives import ring_shift
from .mesh import Mesh, local_cfg, shard


def _lattices(cfg: Config):
    return (cfg.lattice,) + (cfg.scalar_lat,) * 3


@lru_cache(maxsize=None)
def _dirs(lat, axis: int, sign: int, device: torch.device):
    """fs.edge_dirs(lat, sign, axis) as an index tensor on `device`."""
    return torch.tensor(fs.edge_dirs(lat, sign, axis), device=device)


def phi_halos(mesh: Mesh, phi):
    """The phi (or psi_hx) halo of every shard: rows y = -1 and y = NYl
    from the y-neighbours, and on a pencil columns x = -1 and x = NXl from
    the x-neighbours."""
    edge = lambda sel: [sel(p).contiguous() for p in phi]
    ylo = ring_shift(mesh, edge(lambda p: p[:, -1]), "y", 1)
    yhi = ring_shift(mesh, edge(lambda p: p[:, 0]), "y", -1)
    if not mesh.pencil:
        return [PhiHalo(lo, hi) for lo, hi in zip(ylo, yhi)]
    xlo = ring_shift(mesh, edge(lambda p: p[:, :, -1]), "x", 1)
    xhi = ring_shift(mesh, edge(lambda p: p[:, :, 0]), "x", -1)
    return [PhiHalo(*h) for h in zip(ylo, yhi, xlo, xhi)]


def post_rows(cfg_l: Config, mesh: Mesh, posts):
    """posts: per shard (pf, ph, phn, pg).  Returns per shard the `rows`
    argument of its stream: per field (lo, hi) = the y-neighbours'
    post-collision rows y = -1 / y = NYl, the directions with ey = +1 / -1
    only (kernels/fused_step.edge_dirs), or None for an inactive field."""
    per_field = []
    for k, lat in enumerate(_lattices(cfg_l)):
        if posts[0][k] is None:
            per_field.append([None] * mesh.size)
            continue
        pick = lambda y, ey: [p[k][:, :, y].index_select(
            0, _dirs(lat, 1, ey, p[k].device)) for p in posts]
        lo = ring_shift(mesh, pick(-1, 1), "y", 1)
        hi = ring_shift(mesh, pick(0, -1), "y", -1)
        per_field.append(list(zip(lo, hi)))
    return [tuple(f[i] for f in per_field) for i in range(mesh.size)]


def fix_x_columns(cfg_l: Config, mesh: Mesh, outs) -> None:
    """Repair, in place, the two x-wrap columns of every shard's streamed
    populations (outs: per shard (f1, h1, hn1, g1)) on a pencil: the stream
    wrapped x locally, so column 0 of an ex = +1 direction holds this
    shard's post[.., x = NXl-1], which is what the right x-neighbour needs
    in its column 0 (and the mirror for ex = -1).  The fluid's every plane
    streams; a scalar's wall planes are reflections at the node and keep
    their values, except the ions' top plane under zerograd-top, which
    streams from plane NZ-2."""
    nz = cfg_l.grid.nz
    zg = cfg_l.physics.charge_bc == "zerograd-top"
    for k, lat in enumerate(_lattices(cfg_l)):
        if outs[0][k] is None:
            continue
        zs = (slice(None) if k == 0 else
              slice(1, nz) if zg and k in (1, 2) else slice(1, nz - 1))
        for sign, lane, shift in ((1, 0, 1), (-1, -1, -1)):
            idx = [_dirs(lat, 0, sign, o[k].device) for o in outs]
            cols = [o[k][i, zs, :, lane] for o, i in zip(outs, idx)]
            for o, i, c in zip(outs, idx, ring_shift(mesh, cols, "x", shift)):
                o[k][i, zs, :, lane] = c


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
        for shard_rows in result:
            for pair in shard_rows:
                for t in pair or ():
                    t.record_stream(mains[t.device])
    return result, join


def step_halo(cfg: Config, mesh: Mesh, state: State, phi_hx: bool = False,
              out=None, post=None, overlap: bool = True) -> State:
    """One step of a sharded state: per-shard fused step with the halo
    exchange, then the distributed solve.  phi_hx: state.phi holds psi_hx
    (slab meshes; the halo rows travel as psi and the collide decodes them).
    out / post: per shard, preallocated population sets for the streamed
    state and the post-collision scratch (make_halo_multi_step)."""
    p = cfg.physics
    cfg_l = local_cfg(cfg, mesh)
    ek = p.enable_ek
    # pencil shards take the plain RHS: the x-Hartley forms need x whole
    hx = fs.resolve_hartley_x(cfg_l, False if mesh.pencil else None, phi_hx)
    halos = phi_halos(mesh, state.phi) if ek else [None] * mesh.size
    posts, rhs = [], []
    for i in range(mesh.size):
        st = shard(state, i)
        *pc, r = fs.collide(cfg_l, st.f, st.h, st.hn, st.g, st.phi,
                            post=post[i] if post else None, hartley_x=hx,
                            phi_hx=phi_hx, phi_halo=halos[i])
        posts.append(tuple(pc))
        rhs.append(r)
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
    outs = [fs.stream_bc(cfg_l, *posts[i], out=out[i] if out else None,
                         rows=rows[i]) for i in range(mesh.size)]
    if mesh.pencil:
        fix_x_columns(cfg_l, mesh, outs)
    lists = [None if outs[0][k] is None else [o[k] for o in outs]
             for k in range(4)]
    return State(*lists, phi=phi, t=state.t + p.dt(cfg.grid.dx))


def make_halo_multi_step(cfg: Config, mesh: Mesh, n: int,
                         overlap: bool = True,
                         phi_hx: Optional[bool] = None):
    """fn(state) -> state: n `step_halo` steps of a sharded state.  Where
    the shard can carry phi as psi_hx (`phi_hx_capable` of the local
    config, slab meshes only: the codec needs x whole) the chunk encodes
    once, decodes once and runs the phi_hx route, as the JAX package's
    chunk does; phi_hx=False forces real phi between steps (the hartley_x
    form on slabs).  Population sets ping-pong per shard; the input state's
    population tensors are DONATED.  Raises for a mesh the step cannot
    take (divisibility)."""
    cfg_l = local_cfg(cfg, mesh)
    capable = not mesh.pencil and phi_hx_capable(cfg_l)
    hx = capable if phi_hx is None else phi_hx
    if hx and not capable:
        raise ValueError("phi_hx needs a slab mesh and phi_hx_capable")

    def run(state: State) -> State:
        if n <= 0:
            return state
        if hx:
            state = state._replace(phi=psi_hx_from_phi(cfg, state.phi, mesh))
        post = [fs._empty_like_fields(cfg_l, f) for f in state.f]
        spare = [fs._empty_like_fields(cfg_l, f) for f in state.f]
        for _ in range(n):
            prev = [tuple(shard(state, i)[:4]) for i in range(mesh.size)]
            state = step_halo(cfg, mesh, state, phi_hx=hx, out=spare,
                              post=post, overlap=overlap)
            spare = prev
        if hx:
            state = state._replace(phi=phi_from_psi_hx(cfg, state.phi, mesh))
        return state

    return run


def shard_macros(cfg: Config, mesh: Mesh, state: State):
    """(Macro, E) of every shard of a sharded state, E from the phi halo
    (the diagnostics' and the dumps' fields)."""
    from ..ops.collide import compute_macro

    cfg_l = local_cfg(cfg, mesh)
    ek = cfg.physics.enable_ek
    halos = phi_halos(mesh, state.phi) if ek else [None] * mesh.size
    out = []
    for i in range(mesh.size):
        st = shard(state, i)
        E = efield(cfg_l, st.phi, halos[i]) if ek else None
        out.append((compute_macro(cfg_l, st, E=E)[0], E))
    return out
