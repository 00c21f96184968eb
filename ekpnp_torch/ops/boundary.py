"""Wall boundary conditions at the z = 0 and z = NZ-1 plates (port of
ekpnp/ops/boundary.py).

Ordering contract, the same as the JAX package's:
  1. collide writes post-collision arrays;
  2. `bounce_back_walls` overwrites the wall rows of post-collision f with
     reflected *pre-collision* f;
  3. streaming pulls (periodic in z);
  4. `scalar_wall_bcs` overwrites the wall rows of the streamed ion and
     temperature arrays from the post-collision values at the same node.
"""
from __future__ import annotations

import torch

from ..config import Config
from .equilibrium import lattice_consts, opp_index


def bounce_back_walls(cfg: Config, f_post, f_pre):
    """Full-way bounce-back of the fluid at both plates.

    z=0: opposite-direction swap of the pre-collision populations (rest
    restored to its pre-collision value).  z=NZ-1, moving at uw along x:
    the same plus 2 rho0 uw w_i e_ix / (cs^2 CFL).  With
    `compat_ref_multis` direction 3 (+y) also receives the +multis term,
    the reference's quirk."""
    lat = cfg.lattice
    p = cfg.physics
    refl = torch.index_select(f_pre, 0, opp_index(lat, f_pre.device))

    exq = lat.E[:, 0].astype(float)
    if p.compat_ref_multis and lat.Q > 3:
        exq = exq.copy()
        exq[3] += 1.0
    ex = torch.as_tensor(exq).to(device=f_post.device, dtype=f_post.dtype)
    w = lattice_consts(lat, f_post.dtype, f_post.device)[3].reshape(-1)
    mw = (2.0 * p.rho0 * p.uw / cfg.cs2 / p.cfl) * w * ex

    out = f_post.clone()
    out[:, 0] = refl[:, 0]
    out[:, -1] = refl[:, -1] + mw[:, None, None]
    return out


def scalar_wall_bcs(cfg: Config, streamed, post, which: str, wall=None):
    """Post-stream wall BCs for the scalar-transport populations.

    "noflux": streamed wall populations replaced by the opposite
    post-collision populations at the same node; the rest keeps its
    streamed value.
    "temperature": z=0: -post_opp + 2 TH w_i (rest included); z=NZ-1:
    -post_opp.
    "injection": -post_opp + 2 c_wall w_i at both plates, rest included,
    with `wall = (c_lo, c_hi)` the species' plate levels.
    "zerograd-top": noflux at z=0; at z=NZ-1 every direction d takes
    post[d, NZ-2, y-ey, x-ex] (the caller copied plane NZ-2 over NZ-1
    before streaming; the down-going directions, whose pull wrapped to
    z=0, are re-sourced here)."""
    lat = cfg.scalar_lat
    refl = torch.index_select(post, 0, opp_index(lat, post.device))
    out = streamed.clone()

    if which in ("noflux", "zerograd-top"):
        out[1:, 0] = refl[1:, 0]
        if which == "noflux":
            out[1:, -1] = refl[1:, -1]
        else:
            for d in range(lat.Q):
                ex, ey, ez = (int(v) for v in lat.E[d])
                if ez == -1:
                    out[d, -1] = torch.roll(post[d, -2], (ey, ex), (0, 1))
        return out

    w = lattice_consts(lat, streamed.dtype, streamed.device)[3][:, :, :, 0]
    if which == "temperature":
        out[:, 0] = -refl[:, 0] + (2.0 * cfg.physics.TH) * w
        out[:, -1] = -refl[:, -1]
        return out

    if which == "injection":
        c_lo, c_hi = wall
        out[:, 0] = -refl[:, 0] + (2.0 * c_lo) * w
        out[:, -1] = -refl[:, -1] + (2.0 * c_hi) * w
        return out

    raise ValueError(f"unknown wall BC {which!r}")
