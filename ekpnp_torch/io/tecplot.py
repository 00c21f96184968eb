"""ASCII Tecplot writer (port of ekpnp/io/tecplot.py).

The same 14 variables, ZONE layout and wall-node linear extrapolation of
(rho, c+, c-, u) before writing as the JAX package's writer.  The body is
formatted in C++ (io/native.py); `native.format_tecplot_plain` is its
plain version.
"""
from __future__ import annotations

from typing import TextIO

import numpy as np

from ..config import Config
from ..state import Macro
from . import native

HEADER = (
    'VARIABLES="x","y","z","u","v","w","p","charge","neg charge",'
    '"phi","Ex","Ey","Ez","Temperature"'
)


def to_numpy(a, shape):
    """float64 numpy copy of a tensor (or array), zeros of `shape` for None."""
    if a is None:
        return np.zeros(shape)
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=np.float64)


def wall_extrapolate_np(field: np.ndarray) -> np.ndarray:
    """Row 0 <- 2 [1] - [2], row NZ-1 <- 2 [NZ-2] - [NZ-3] along axis -3."""
    out = field.copy()
    out[..., 0, :, :] = 2.0 * field[..., 1, :, :] - field[..., 2, :, :]
    out[..., -1, :, :] = 2.0 * field[..., -2, :, :] - field[..., -3, :, :]
    return out


def _gather_columns(cfg: Config, macro: Macro, phi, E):
    """The 14 reference columns as (N,) float64 arrays, z-outer, x-inner."""
    g = cfg.grid
    shape = g.shape
    rho = wall_extrapolate_np(to_numpy(macro.rho, shape))
    u = wall_extrapolate_np(to_numpy(macro.u, (3,) + shape))
    charge = wall_extrapolate_np(to_numpy(macro.charge, shape))
    chargen = wall_extrapolate_np(to_numpy(macro.chargen, shape))
    temp = to_numpy(macro.temp, shape)
    phi_a = to_numpy(phi, shape)
    E_a = to_numpy(E, (3,) + shape)
    z, y, x = np.meshgrid(np.arange(g.nz) * g.dz, np.arange(g.ny) * g.dy,
                          np.arange(g.nx) * g.dx, indexing="ij")
    cols = [x, y, z, u[0], u[1], u[2], rho, charge, chargen, phi_a,
            E_a[0], E_a[1], E_a[2], temp]
    return [c.reshape(-1) for c in cols]


def write_zone(fout: TextIO, cfg: Config, macro: Macro, phi, E, time: float,
               first: bool = False) -> None:
    g = cfg.grid
    if first:
        fout.write(HEADER + "\n")
    fout.write("\n")
    fout.write(f'ZONE T="t={time:g}", F=POINT, I = {g.nx}, J = {g.ny}, '
               f'K = {g.nz}\n')
    native.write_tecplot(fout, _gather_columns(cfg, macro, phi, E))
