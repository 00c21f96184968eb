"""TRT collision for all four populations, Guo forcing and macroscopic
fields (port of ekpnp/ops/collide.py).

  - moments of the pre-collision populations;
  - body force: Coulomb + external + Boussinesq;
  - velocity with the half-force correction;
  - z=0 wall extrapolation u(z=0) = -numer(z=1)/rho(z=0), with the local
    wall density (the reference's quirk, kept);
  - equilibria (ion drift u + K E), Guo forcing populations;
  - TRT even/odd update with source s+- = 1 - dt omega+-/2.
Only the fluid receives the force source term.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..config import Config
from ..state import Macro, State
from .equilibrium import dir_sum, feq, lattice_consts, moments, trt_split
from .poisson import efield


class PostCollision(NamedTuple):
    f: torch.Tensor
    h: Optional[torch.Tensor]
    hn: Optional[torch.Tensor]
    g: Optional[torch.Tensor]


def body_force(cfg: Config, charge, chargen, temp, E, like):
    """(Fx, Fy, Fz) as (3, Z, Y, X)."""
    p = cfg.physics
    zeros = torch.zeros_like(like)
    if p.enable_ek:
        q = p.convert_c_to_charge * (charge - chargen)
        fx = q * (E[0] + p.ext_field) + p.exf
        fy = q * E[1]
        fz = q * E[2]
    else:
        fx = zeros + p.exf
        fy = zeros
        fz = zeros
    if p.enable_thermal:
        fz = fz + (p.rho0 * p.Ra * p.nu * p.D) * temp
    return torch.stack([fx, fy, fz])


def perturbation_velocity(cfg: Config, dtype, device, origin=(0, 0)):
    """Convection-roll seeding pattern ("square" as in the reference,
    dimensional coordinates inside the trigonometric arguments; "hexagon"
    with the corrected, divergence-free algebra).  On a shard, `origin` is
    the global (y, x) of its first node."""
    g = cfg.grid
    LL = cfg.run.LL
    two_pi = 2.0 * math.pi
    ar = lambda n, o=0: torch.arange(o, o + n, dtype=dtype, device=device)
    xx = ar(g.nx, origin[1])[None, None, :] * g.dx
    yy = ar(g.ny, origin[0])[None, :, None] * g.dy
    zz = (ar(g.nz)[:, None, None] - 0.5) * g.dz
    pattern = cfg.run.perturb_pattern
    if pattern == "square":
        uz = ((torch.cos(two_pi * zz) - 1.0) * torch.cos(two_pi / LL * xx)
              * torch.cos(two_pi / LL * yy))
        ux = (0.5 * LL * torch.sin(two_pi * zz) * torch.sin(two_pi / LL * xx)
              * torch.cos(two_pi / LL * yy))
        uy = (0.5 * LL * torch.sin(two_pi * zz) * torch.sin(two_pi / LL * yy)
              * torch.cos(two_pi / LL * xx))
    elif pattern == "hexagon":
        a = two_pi / (math.sqrt(3.0) * LL)
        b = two_pi / (3.0 * LL)
        k2 = a * a + b * b
        F = (2.0 * torch.cos(a * xx) * torch.cos(b * yy)
             + torch.cos(2.0 * b * yy)) / 3.0
        dFdx = -(2.0 * a / 3.0) * torch.sin(a * xx) * torch.cos(b * yy)
        dFdy = (-(2.0 * b / 3.0) * torch.cos(a * xx) * torch.sin(b * yy)
                - (2.0 * b / 3.0) * torch.sin(2.0 * b * yy))
        uz = (torch.cos(two_pi * zz) - 1.0) * F
        ux = -(two_pi / k2) * torch.sin(two_pi * zz) * dFdx
        uy = -(two_pi / k2) * torch.sin(two_pi * zz) * dFdy
    else:
        raise ValueError(f"unknown perturb_pattern {pattern!r}")
    shape = g.shape
    return torch.stack([ux.expand(shape), uy.expand(shape), uz.expand(shape)])


def guo_force_pops(cfg: Config, u, F):
    """S_i = (w_i/cs^2) [ (e_i/CFL - u) . F + (e_i.u)(e_i.F)/(CFL^2 cs^2) ]."""
    cs2 = cfg.cs2
    inv_cfl = 1.0 / cfg.physics.cfl
    ex, ey, ez, w = lattice_consts(cfg.lattice, u.dtype, u.device)
    # in place, in the order of the formula (equilibrium.feq)
    eu = ex * u[0]
    eu += ey * u[1]
    eu += ez * u[2]
    eu *= inv_cfl
    eF = ex * F[0]
    eF += ey * F[1]
    eF += ez * F[2]
    eF *= inv_cfl
    core = ex * inv_cfl - u[0][None]
    core *= F[0][None]
    for e, uk, Fk in ((ey, u[1], F[1]), (ez, u[2], F[2])):
        c = e * inv_cfl - uk[None]
        c *= Fk[None]
        core += c
    eu *= eF
    eu *= 1.0 / cs2
    core += eu
    return core.mul_(w * (1.0 / cs2))


def _trt_update(lat, pops, eq, om_plus_dt, om_minus_dt, source=None, dt=None):
    fp, fm = trt_split(lat, pops)
    ep, em = trt_split(lat, eq)
    fp -= ep
    fp *= om_plus_dt
    fm -= em
    fm *= om_minus_dt
    fp += fm
    out = pops - fp
    if source is not None:
        out += dt * source
    return out


def compute_macro(cfg: Config, state: State, perturb: bool = False, E=None,
                  origin=(0, 0)):
    """Macroscopic fields and body force from the pre-collision
    populations.  Returns (Macro, F).  E: the field where the caller has
    it (a shard's, from its halo); `origin`: see perturbation_velocity."""
    lat = cfg.lattice
    p = cfg.physics
    dt = p.dt(cfg.grid.dx)

    rho, mom = moments(lat, state.f, p.cfl)
    if p.enable_ek:
        charge = dir_sum(state.h)
        # single species: chargen is identically 0
        chargen = (dir_sum(state.hn) if state.hn is not None
                   else torch.zeros_like(charge))
    else:
        charge = chargen = None
    temp = dir_sum(state.g) if p.enable_thermal else None

    if p.enable_ek and E is None:
        E = efield(cfg, state.phi)
    F = body_force(cfg, charge, chargen, temp, E, rho)

    numer = mom + (0.5 * dt) * F
    u = numer / rho[None]
    if perturb:
        u = perturbation_velocity(cfg, rho.dtype, rho.device, origin)
    else:
        u[:, 0] = -numer[:, 1] / rho[0][None]
    return Macro(rho=rho, u=u, charge=charge, chargen=chargen, temp=temp), F


def collide(cfg: Config, state: State, perturb: bool = False, E=None,
            origin=(0, 0)):
    """One TRT collision of all active populations; returns
    (PostCollision, Macro).  The wall handling lives in boundary.py.  E
    and `origin` as for compute_macro."""
    lat = cfg.lattice
    lat_s = cfg.scalar_lat
    p = cfg.physics
    dt = p.dt(cfg.grid.dx)
    cs2, cs2_s, cfl = cfg.cs2, cfg.cs2_s, p.cfl
    om = cfg.omegas()

    if p.enable_ek and E is None:
        E = efield(cfg, state.phi)
    macro, F = compute_macro(cfg, state, perturb, E=E, origin=origin)
    rho, u = macro.rho, macro.u
    charge, chargen, temp = macro.charge, macro.chargen, macro.temp

    fpop = guo_force_pops(cfg, u, F)
    sp_, sm_ = trt_split(lat, fpop)
    s_plus = 1.0 - 0.5 * dt * om["omega_plus"]
    s_minus = 1.0 - 0.5 * dt * om["omega_minus"]
    source = sp_.mul_(s_plus).add_(sm_.mul_(s_minus))
    f2 = _trt_update(lat, state.f, feq(lat, rho, u, cfl, cs2),
                     dt * om["omega_plus"], dt * om["omega_minus"], source, dt)

    h2 = hn2 = g2 = None
    if p.enable_ek:
        feq_h = feq(lat_s, charge, u + p.K * E, cfl, cs2_s)
        h2 = _trt_update(lat_s, state.h, feq_h, dt * om["omega_c_plus"],
                         dt * om["omega_c_minus"])
        if state.hn is not None:
            feq_hn = feq(lat_s, chargen, u + p.Kn * E, cfl, cs2_s)
            hn2 = _trt_update(lat_s, state.hn, feq_hn, dt * om["omega_cn_plus"],
                              dt * om["omega_cn_minus"])
    if p.enable_thermal:
        feq_g = feq(lat_s, temp, u, cfl, cs2_s)
        g2 = _trt_update(lat_s, state.g, feq_g, dt * om["omega_T_plus"],
                         dt * om["omega_T_minus"])
        if p.joule != 0.0 and p.enable_ek:
            # Joule heating: volumetric source joule (c+ + c-) |E|^2 added
            # as dt w_i S
            S = p.joule * (charge + chargen) * torch.sum(E * E, dim=0)
            w = lattice_consts(lat_s, S.dtype, S.device)[3]
            g2 += (dt * w) * S[None]

    return PostCollision(f=f2, h=h2, hn=hn2, g=g2), macro
