"""The lattice-Boltzmann half of the reference: moments, equilibria, the
TRT collision with Guo forcing, full-way bounce-back, pull streaming, the
scalar wall rules, one coupled step and the series values.

A state is a dict of tensors: populations `f` (fluid), `h`, `hn` (the two
ion species), `g` (temperature), each (Q, NZ, NY, NX) with the direction
first, and `phi` (NZ, NY, NX).  Every field is worked one direction pair
(d, opp d) at a time, so a step holds the old and the new populations and
a few (NZ, NY, NX) temporaries at most: that is how the 256^3 and the pod
grids fit beside the program's snapshots on one card.

Physics (upstream LBM.cu:162-463, 488-495, 1148-1202, 1862-1958,
2102-2218), in SI units with lattice speed 1/CFL:
  feq_i = w_i m [1 - |v|^2/(2 cs^2) + t_i (1 + t_i/2)], t_i = e_i.v/(cs^2 CFL)
  (fluid: m = rho, v = u; ions: m = c+-, v = u + K+- E; temperature:
  m = T, v = u), split into even and odd parts over (i, opp i), relaxed
  at rates (dt w+, dt w-); the fluid adds dt (s+ S+ + s- S-) of the Guo
  source S_i = (w_i/cs^2)[(e_i/CFL - u).F + (e_i.u)(e_i.F)/(CFL^2 cs^2)],
  s+- = 1 - dt w+- / 2, F = q (E + Ext x^) + exf x^ + rho0 Ra nu D T z^.
  u = (mom + dt F / 2) / rho, with the upstream's wall row u(z=0) =
  -(mom + dt F / 2)(z=1) / rho(z=0).
"""
from __future__ import annotations

import torch

from .params import Params
from .solve import efield, potential

POPS = ("f", "h", "hn", "g")


def _dot(e, v):
    """e . v for an integer direction e and a (3, ...) field v; None for
    the rest direction."""
    out = None
    for a in range(3):
        if e[a]:
            term = v[a] if e[a] > 0 else -v[a]
            out = term if out is None else out + term
    return out


def macro(P: Params, st: dict, E=None):
    """(rho, u, charge, chargen, temp, E, F) of a state's populations."""
    f = st["f"]
    if E is None:
        E = efield(P, st["phi"])
    rho = f.sum(0)
    mom = []
    for a in range(3):
        pos = [d for d, e in enumerate(P.lat.e) if e[a] > 0]
        neg = [d for d, e in enumerate(P.lat.e) if e[a] < 0]
        mom.append((f[pos].sum(0) - f[neg].sum(0)) * (1.0 / P.cfl))
    charge, chargen, temp = st["h"].sum(0), st["hn"].sum(0), st["g"].sum(0)
    q = (charge - chargen) * P.convert_c_to_charge
    force = torch.stack([q * (E[0] + P.ext_field) + P.exf, q * E[1],
                         q * E[2] + (P.rho0 * P.Ra * P.nu * P.D) * temp])
    numer = torch.stack(mom) + (0.5 * P.dt) * force
    u = numer / rho
    u[:, 0] = -numer[:, 1] / rho[0]
    return dict(rho=rho, u=u, charge=charge, chargen=chargen, temp=temp,
                E=E, F=force)


def equilibrium(lat, m, v, cs2: float, cfl: float):
    """feq (Q, NZ, NY, NX) of moment m and drift v, direction by direction."""
    c = 1.0 / (cs2 * cfl)
    base = 1.0 - (v * v).sum(0) * (0.5 / cs2)
    out = torch.empty((lat.q,) + tuple(m.shape), dtype=m.dtype, device=m.device)
    for d, e in enumerate(lat.e):
        ev = _dot(e, v)
        if ev is None:
            out[d] = lat.w[d] * m * base
        else:
            t = ev * c
            out[d] = (lat.w[d] * m) * (base + t * (1.0 + 0.5 * t))
    return out


def initial_state(P: Params, rho, u, charge, chargen, temp, phi, E):
    """Equilibrium populations of the macroscopic fields (the ions drift
    at u + K E)."""
    cfl = P.cfl
    return dict(
        f=equilibrium(P.lat, rho, u, P.cs2, cfl),
        h=equilibrium(P.lat_s, charge, u + P.K * E, P.cs2_s, cfl),
        hn=equilibrium(P.lat_s, chargen, u + P.Kn * E, P.cs2_s, cfl),
        g=equilibrium(P.lat_s, temp, u, P.cs2_s, cfl),
        phi=phi)


def _roll(a, e, sign):
    return torch.roll(a, shifts=(sign * e[2], sign * e[1], sign * e[0]),
                      dims=(0, 1, 2))


def collide_stream(P: Params, name: str, pre, m, v, mc=None):
    """The new populations of field `name` ("f", "h", "hn" or "g"): TRT
    collision (with the Guo source for the fluid: mc = the macro dict),
    the fluid's bounce-back at both plates, pull streaming with periodic
    wrap, then the scalar wall rules (ions: no flux; temperature: TH at
    z = 0, 0 at z = NZ-1)."""
    fluid = name == "f"
    lat = P.lat if fluid else P.lat_s
    cs2 = P.cs2 if fluid else P.cs2_s
    r_even, r_odd = P.rates()[name]
    c = 1.0 / (cs2 * P.cfl)
    base = 1.0 - (v * v).sum(0) * (0.5 / cs2)
    out = torch.empty_like(pre)
    if fluid:
        u, F = mc["u"], mc["F"]
        s_even = 1.0 - 0.5 * r_even
        s_odd = 1.0 - 0.5 * r_odd
        uF = (u * F).sum(0)
        mw_scale = 2.0 * P.rho0 * P.uw / cs2 / P.cfl
    for d, o in lat.pairs():
        e, w = lat.e[d], lat.w[d]
        wm = w * m
        ev = _dot(e, v)
        xd, xo = pre[d], pre[o]
        if ev is None:      # the rest direction: no odd part
            a = (xd - wm * base) * r_even
            post_d = xd - a
            if fluid:
                post_d = post_d + (P.dt * s_even * w / cs2) * (-uF)
            post_o = post_d
        else:
            t = ev * c
            a = ((xd + xo) * 0.5 - wm * (base + 0.5 * t * t)) * r_even
            b = ((xd - xo) * 0.5 - wm * t) * r_odd
            post_d = xd - a - b
            post_o = xo - a + b
            if fluid:
                eu = _dot(e, u) * (1.0 / P.cfl)
                eF = _dot(e, F) * (1.0 / P.cfl)
                s_plus = (eu * eF * (1.0 / cs2) - uF) * (P.dt * s_even * w / cs2)
                s_minus = eF * (P.dt * s_odd * w / cs2)
                post_d = post_d + s_plus + s_minus
                post_o = post_o + s_plus - s_minus
        if fluid:           # bounce-back from the pre-collision values
            post_d[0] = xo[0]
            post_d[-1] = xo[-1] + mw_scale * w * e[0]
            if o != d:
                post_o[0] = xd[0]
                post_o[-1] = xd[-1] - mw_scale * w * e[0]
        out[d] = _roll(post_d, e, 1)
        if o != d:
            out[o] = _roll(post_o, e, -1)
        if name in ("h", "hn") and o != d:
            out[d, 0], out[d, -1] = post_o[0], post_o[-1]
            out[o, 0], out[o, -1] = post_d[0], post_d[-1]
        elif name == "g":
            out[d, 0] = 2.0 * P.TH * w - post_o[0]
            out[d, -1] = -post_o[-1]
            if o != d:
                out[o, 0] = 2.0 * P.TH * w - post_d[0]
                out[o, -1] = -post_d[-1]
    return out


def step(P: Params, st: dict, tf32: bool = False) -> dict:
    """One coupled step: collide and stream every population with phi's E,
    then solve for the next phi from this step's pre-collision charges.
    `st` is replaced field by field (its old tensors are dropped as soon
    as the new ones exist); returns it."""
    mc = macro(P, st)
    u, E = mc["u"], mc["E"]
    drift = {"f": (mc["rho"], u), "h": (mc["charge"], u + P.K * E),
             "hn": (mc["chargen"], u + P.Kn * E), "g": (mc["temp"], u)}
    for name in POPS:
        m, v = drift[name]
        st[name] = collide_stream(P, name, st[name], m, v, mc)
    st["phi"] = potential(P, mc["charge"], mc["chargen"], tf32)
    return st


def run(P: Params, st: dict, n: int, tf32: bool = False) -> dict:
    """n steps from a copy of the dict `st` (its tensors are not written)."""
    st = dict(st)
    for _ in range(n):
        st = step(P, st, tf32)
    return st


def series(P: Params, st: dict):
    """The series values of a state, as float64 numbers: max uz, max |u|,
    the ionic current through the upper plate K dz^2 sum_xy (c+ - c-) Ez
    with the charges extrapolated linearly to the plate, and the mean
    temperature."""
    mc = macro(P, st)
    u = mc["u"]
    top = lambda c: 2.0 * c[-2] - c[-3]
    cur = ((top(mc["charge"]) - top(mc["chargen"])) * mc["E"][2][-1]).double()
    return dict(umax=float(u[2].max()),
                umag=float(torch.sqrt((u * u).sum(0).max().double())),
                current=float(cur.sum()) * P.K * P.dz * P.dz,
                mean_T=float(mc["temp"].double().mean()))
