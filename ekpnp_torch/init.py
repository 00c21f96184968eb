"""Cold-start initialization and equilibrium population seeding (port of
ekpnp/init.py).

  cold_fields()       rho = rho0, u = 0, charges 0, phi = voltage, E = 0,
                      linear temperature profile;
  initialize()        cold fields + the PB double-layer loop (if EK) +
                      equilibrium populations;
  state_from_macro()  populations = feq per field (ions drift u + K E).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .config import Config
from .device import resolve_device, torch_dtype
from .ops.equilibrium import feq
from .ops.pbe import pb_init
from .state import Macro, State
from .telemetry import PREFIX, span

INIT = PREFIX + "init"


class InitFields(NamedTuple):
    rho: torch.Tensor
    u: torch.Tensor
    charge: Optional[torch.Tensor]
    chargen: Optional[torch.Tensor]
    phi: Optional[torch.Tensor]
    E: Optional[torch.Tensor]
    temp: Optional[torch.Tensor]


def cold_fields(cfg: Config, dtype, device) -> InitFields:
    g = cfg.grid
    p = cfg.physics
    shape = g.shape
    kw = dict(dtype=dtype, device=device)
    rho = torch.full(shape, p.rho0, **kw)
    u = torch.zeros((3,) + shape, **kw)
    charge = chargen = phi = E = temp = None
    if p.enable_ek:
        charge = torch.zeros(shape, **kw)
        chargen = torch.zeros(shape, **kw)
        phi = torch.full(shape, p.voltage, **kw)
        E = torch.zeros((3,) + shape, **kw)
    if p.enable_thermal:
        z = torch.arange(g.nz, **kw)[:, None, None]
        prof = p.TH * (g.lz - g.dz * z) / g.lz
        temp = prof.expand(shape).contiguous()
    return InitFields(rho, u, charge, chargen, phi, E, temp)


def initialize(cfg: Config, device="cuda", dtype=None,
               with_residual: bool = False):
    """Full cold start.  Returns (State, Macro), or (State, Macro,
    pb_residual) with with_residual=True (None when EK is off).  The
    ekpnp_torch.init span, its children .cold_fields, .pb and .equilibria
    (host time: the card may still run the last of their launches)."""
    with span(INIT):
        dev = resolve_device(device)
        dtype = torch_dtype(dtype or cfg.run.dtype)
        with span(INIT + ".cold_fields"):
            fields = cold_fields(cfg, dtype, dev)
        residual = None
        if cfg.physics.enable_ek:
            with span(INIT + ".pb"):
                out = pb_init(cfg, fields.phi, with_residual=with_residual)
            phi, charge, chargen, E = out[:4]
            if with_residual:
                residual = out[4]
            fields = fields._replace(phi=phi, charge=charge, chargen=chargen,
                                     E=E)
        macro = Macro(rho=fields.rho, u=fields.u, charge=fields.charge,
                      chargen=fields.chargen, temp=fields.temp)
        with span(INIT + ".equilibria"):
            state = state_from_macro(cfg, macro, fields.phi, fields.E, t=0.0)
    if with_residual:
        return state, macro, residual
    return state, macro


def state_from_macro(cfg: Config, macro: Macro, phi, E, t) -> State:
    """Equilibrium populations from macroscopic fields.  E enters the ion
    equilibria only; the State carries phi."""
    lat = cfg.lattice
    lat_s = cfg.scalar_lat
    p = cfg.physics
    cfl, cs2, cs2_s = p.cfl, cfg.cs2, cfg.cs2_s
    rho = macro.rho

    f = feq(lat, rho, macro.u, cfl, cs2)
    h = hn = g = None
    if p.enable_ek:
        h = feq(lat_s, macro.charge, macro.u + p.K * E, cfl, cs2_s)
        if p.two_species:
            hn = feq(lat_s, macro.chargen, macro.u + p.Kn * E, cfl, cs2_s)
    if p.enable_thermal:
        g = feq(lat_s, macro.temp, macro.u, cfl, cs2_s)
    return State(f=f, h=h, hn=hn, g=g, phi=phi,
                 t=torch.tensor(float(t), dtype=rho.dtype, device=rho.device))
