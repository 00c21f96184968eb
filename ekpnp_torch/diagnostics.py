"""Diagnostics: ionic current, umax series, dimensionless groups, finite
guard (port of ekpnp/diagnostics.py).  Reductions run on the state's
device; `series_point` returns 0-d tensors so a caller fetches them with
one host transfer.  A sharded state (parallel/mesh.py) is reduced shard by
shard and then over the shards: maxima exactly as on the gathered state,
sums up to their order of summation.  Over several processes the
per-shard partials are all-gathered in mesh order and reduced as one
process reduces them (not by `all_reduce`, whose order NCCL chooses), so
every process gets the one-process mesh run's values bit for bit."""
from __future__ import annotations

import torch

from .config import Config
from .state import State
from .telemetry import PREFIX, span

# series_point's span and its children (telemetry); on a mesh the gather
# is the ekpnp_torch.gather_rows span of parallel/collectives.py
SERIES = PREFIX + "series"
MACRO, REDUCE, FINITE = SERIES + ".macro", SERIES + ".reduce", SERIES + ".finite"


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
    fields may be lists of shards (this process's: None for the others)."""
    first = (next(t for t in state.f if t is not None)
             if isinstance(state.f, list) else state.f)
    ok = torch.ones((), dtype=torch.bool, device=first.device)
    for field in state:
        for t in field if isinstance(field, list) else [field]:
            if t is not None:
                ok = ok & torch.all(torch.isfinite(t)).to(first.device)
    return ok


def check_finite(state: State) -> bool:
    """NaN/Inf guard over every tensor of the state (sharded or not; this
    process's shards)."""
    return bool(_finite(state))


def series_point(cfg: Config, state: State, mesh=None):
    """(umax_uz, umax_mag, current, mean_T, finite) as 0-d tensors; with
    `mesh`, of a sharded state, on its first local shard's device (the
    same values on every process).  The ekpnp_torch.series span: .macro
    the full-grid moments and E, .reduce the reductions, .finite the
    guard."""
    with span(SERIES):
        return _series_point(cfg, state, mesh)


def _series_point(cfg: Config, state: State, mesh):
    from .ops.collide import compute_macro
    from .ops.poisson import efield

    ek = cfg.physics.enable_ek
    thermal = cfg.physics.enable_thermal
    if mesh is None:
        with span(MACRO):
            m, _ = compute_macro(cfg, state)
            E = efield(cfg, state.phi) if ek else None
        with span(REDUCE):
            zero = torch.zeros((), dtype=m.rho.dtype, device=m.rho.device)
            vals = (umax(m.u),
                    torch.sqrt(torch.max(torch.sum(m.u * m.u, dim=0))),
                    ionic_current(cfg, m.charge, m.chargen, E[2]) if ek
                    else zero, torch.mean(m.temp) if thermal else zero)
        with span(FINITE):
            return (*vals, _finite(state))
    from .parallel.collectives import gather_rows
    from .parallel.halo import shard_macros
    from .parallel.mesh import shard

    with span(MACRO):
        parts = shard_macros(cfg, mesh, state)
    first = parts[mesh.local[0]][0].rho
    dev = first.device
    zero = torch.zeros((), dtype=first.dtype, device=dev)
    with span(FINITE):
        finite = {i: _finite(shard(state, i)) for i in mesh.local}

    def row(i):
        """Shard i's partials: max uz, max |u|^2, its current, sum T and
        whether its tensors are finite."""
        m, E = parts[i]
        return torch.stack([t.to(dev, first.dtype) for t in (
            umax(m.u), torch.max(torch.sum(m.u * m.u, dim=0)),
            ionic_current(cfg, m.charge, m.chargen, E[2]) if ek else zero,
            torch.sum(m.temp) if thermal else zero, finite[i])])

    with span(REDUCE):
        local = torch.stack([row(i) for i in mesh.local])
    rows = gather_rows(mesh, local)
    mean_t = rows[:, 3].sum() / cfg.grid.num_nodes if thermal else zero
    return (rows[:, 0].max(), torch.sqrt(rows[:, 1].max()),
            rows[:, 2].sum() if ek else zero, mean_t, torch.all(rows[:, 4] > 0))


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
