"""Diagnostics: ionic current, umax series, dimensionless groups, finite
guard (port of ekpnp/diagnostics.py).  Reductions run on the state's
device; `series_point` returns 0-d tensors so a caller fetches them with
one host transfer.  A sharded state (parallel/mesh.py) is reduced shard by
shard and then over the shards: maxima exactly as on the gathered state,
sums up to their order of summation."""
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
    """All entries finite, as a 0-d tensor on the state's (first) device;
    fields may be lists of shards."""
    first = state.f[0] if isinstance(state.f, list) else state.f
    ok = torch.ones((), dtype=torch.bool, device=first.device)
    for field in state:
        for t in field if isinstance(field, list) else [field]:
            if t is not None:
                ok = ok & torch.all(torch.isfinite(t)).to(first.device)
    return ok


def check_finite(state: State) -> bool:
    """NaN/Inf guard over every tensor of the state (sharded or not)."""
    return bool(_finite(state))


def series_point(cfg: Config, state: State, mesh=None):
    """(umax_uz, umax_mag, current, mean_T, finite) as 0-d tensors; with
    `mesh`, of a sharded state, on its first shard's device."""
    from .ops.collide import compute_macro
    from .ops.poisson import efield

    ek = cfg.physics.enable_ek
    if mesh is None:
        macro, _ = compute_macro(cfg, state)
        parts = [(macro, efield(cfg, state.phi) if ek else None)]
    else:
        from .parallel.halo import shard_macros

        parts = shard_macros(cfg, mesh, state)
    dev = parts[0][0].rho.device
    red = lambda fn: torch.stack([fn(m, E).to(dev) for m, E in parts])
    zero = torch.zeros((), dtype=parts[0][0].rho.dtype, device=dev)
    um = red(lambda m, E: umax(m.u)).max()
    umag = torch.sqrt(red(lambda m, E: torch.max(torch.sum(m.u * m.u,
                                                           dim=0))).max())
    cur = zero
    if ek:
        cur = red(lambda m, E: ionic_current(cfg, m.charge, m.chargen,
                                             E[2])).sum()
    mean_t = zero
    if cfg.physics.enable_thermal:
        mean_t = (torch.mean(parts[0][0].temp) if mesh is None else
                  red(lambda m, E: torch.sum(m.temp)).sum()
                  / cfg.grid.num_nodes)
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
