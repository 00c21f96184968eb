"""The plain timestep (port of ekpnp/step.py): the CPU path of the port and
the plain version of its CUDA kernels (kernels/fused_step.py).

Order, the reference's:
  collide (TRT, all fields) -> fluid bounce-back at the walls -> pull
  stream (periodic) -> ion and temperature wall BCs -> spectral Poisson
  solve for phi (consumed by the next step's collide).
`collide_and_reflect` and `stream_and_bcs` are the two halves the kernel
path splits into its two launches.
"""
from __future__ import annotations

from .config import Config
from .ops.boundary import bounce_back_walls, scalar_wall_bcs
from .ops.collide import PostCollision, collide
from .ops.poisson import poisson_phi
from .ops.stream import stream
from .state import State


def collide_and_reflect(cfg: Config, state: State, perturb: bool = False,
                        E=None, origin=(0, 0)):
    """Collide every field, then bounce the fluid back at both plates from
    its pre-collision populations.  Returns (PostCollision, Macro).  E and
    `origin`: a shard's field and position (ops.collide.compute_macro)."""
    post, macro = collide(cfg, state, perturb=perturb, E=E, origin=origin)
    return post._replace(f=bounce_back_walls(cfg, post.f, state.f)), macro


def stream_and_bcs(cfg: Config, post: PostCollision):
    """Stream every field and apply the scalar wall BCs; returns
    (f1, h1, hn1, g1)."""
    p = cfg.physics
    lat, lat_s = cfg.lattice, cfg.scalar_lat
    f1 = stream(lat, post.f)
    h1 = hn1 = g1 = None
    if p.enable_ek:
        cbc = p.charge_bc
        if cbc not in ("noflux", "injection", "zerograd-top"):
            raise ValueError(f"unknown charge_bc {cbc!r}")

        def ion(post_k, wall):
            if cbc == "zerograd-top":
                # zero charge gradient at the upper plate: the post-collision
                # wall plane is replaced by its interior neighbour BEFORE
                # streaming; the wall fix then completes the top plane
                post_k = post_k.clone()
                post_k[:, -1] = post_k[:, -2]
            return scalar_wall_bcs(cfg, stream(lat_s, post_k), post_k, cbc,
                                   wall=wall)

        h1 = ion(post.h, (p.charge0, p.charge1))
        if post.hn is not None:
            hn1 = ion(post.hn, (p.charge0n, p.charge1n))
    if p.enable_thermal:
        g1 = scalar_wall_bcs(cfg, stream(lat_s, post.g), post.g, "temperature")
    return f1, h1, hn1, g1


def step(cfg: Config, state: State, perturb: bool = False):
    """One plain step; returns (State, Macro)."""
    post, macro = collide_and_reflect(cfg, state, perturb=perturb)
    f1, h1, hn1, g1 = stream_and_bcs(cfg, post)
    phi = state.phi
    if cfg.physics.enable_ek:
        phi = poisson_phi(cfg, macro.charge, macro.chargen)
    t = state.t + cfg.physics.dt(cfg.grid.dx)
    return State(f=f1, h=h1, hn=hn1, g=g1, phi=phi, t=t), macro


def multi_step(cfg: Config, state: State, n: int) -> State:
    """n plain steps."""
    for _ in range(n):
        state, _ = step(cfg, state)
    return state
