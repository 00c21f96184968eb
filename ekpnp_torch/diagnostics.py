"""Diagnostics: ionic current, umax series, dimensionless groups, finite
guard (port of ekpnp/diagnostics.py).  Reductions run on the state's
device; `series_point` returns 0-d tensors so a caller fetches them with
one host transfer."""
from __future__ import annotations

import torch

from .config import Config
from .state import State


def wall_extrapolate(field):
    """Linear extrapolation of the wall planes from the interior along axis
    -3: row 0 <- 2 [1] - [2], row NZ-1 <- 2 [NZ-2] - [NZ-3]."""
    out = field.clone()
    out[..., 0, :, :] = 2.0 * field[..., 1, :, :] - field[..., 2, :, :]
    out[..., -1, :, :] = 2.0 * field[..., -2, :, :] - field[..., -3, :, :]
    return out


def ionic_current(cfg: Config, charge, chargen, Ez):
    """I = K dz^2 sum_xy (c+ - c-) Ez at the upper plate, charges wall-
    extrapolated first."""
    c = wall_extrapolate(charge)
    cn = wall_extrapolate(chargen)
    upper = (c[-1] - cn[-1]) * Ez[-1]
    return torch.sum(upper) * (cfg.physics.K * cfg.grid.dz * cfg.grid.dz)


def umax(u):
    """max of raw uz (the reference's record_umax semantics, not |u|)."""
    return torch.max(u[2])


def velocity_magnitude_max(u):
    """max |u|."""
    return torch.sqrt(torch.max(torch.sum(u * u, dim=0)))


def _finite(state: State):
    ok = torch.ones((), dtype=torch.bool, device=state.f.device)
    for t in state:
        if t is not None:
            ok = ok & torch.all(torch.isfinite(t))
    return ok


def check_finite(state: State) -> bool:
    """NaN/Inf guard over every tensor of the state."""
    return bool(_finite(state))


def series_point(cfg: Config, state: State):
    """(umax_uz, umax_mag, current, mean_T, finite) as 0-d tensors."""
    from .ops.collide import compute_macro
    from .ops.poisson import efield

    macro, _ = compute_macro(cfg, state)
    zero = torch.zeros((), dtype=macro.rho.dtype, device=macro.rho.device)
    um = umax(macro.u)
    umag = velocity_magnitude_max(macro.u)
    cur = zero
    if cfg.physics.enable_ek:
        E = efield(cfg, state.phi)
        cur = ionic_current(cfg, macro.charge, macro.chargen, E[2])
    mean_t = torch.mean(macro.temp) if macro.temp is not None else zero
    return um, umag, cur, mean_t, _finite(state)


def dimensionless_banner(cfg: Config) -> str:
    """Printable dimensionless-group report."""
    d = cfg.physics.dimensionless(cfg.grid.lz)
    lines = [
        "EK-PNP-3D (PyTorch/CUDA) — 3D electrokinetic flow with heat transfer",
        f"  domain (NX x NY x NZ): {cfg.grid.nx}x{cfg.grid.ny}x{cfg.grid.nz}",
        f"  M  = {d['M']:.6g}",
        f"  T  = {d['T']:.6g}",
        f"  C  = {d['C']:.6g}",
        f"  Fe = {d['Fe']:.6g}",
        f"  Ra = {cfg.physics.Ra:g}",
        f"  Pr = {d['Pr']:.6g}",
        f"  uwall = {cfg.physics.uw:g}",
        f"  external force = {cfg.physics.exf:g}",
        f"  dt = {cfg.dt:g} s",
    ]
    return "\n".join(lines)
