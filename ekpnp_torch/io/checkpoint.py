"""Checkpoint savers (port of the savers of ekpnp/io/checkpoint.py).

Only macroscopic fields are checkpointed (the reference's lossy restart).
`save_npz` writes the JAX package's keys, so `ekpnp.io.checkpoint.load_npz`
restores it; `save_reference_ascii` writes the reference's 12-column
data_end.dat.  Loaders are not ported yet.
"""
from __future__ import annotations

import numpy as np

from ..config import Config
from ..state import Macro
from .tecplot import to_numpy, wall_extrapolate_np


def save_npz(path: str, cfg: Config, macro: Macro, phi, E, t: float) -> None:
    g = cfg.grid
    shape = g.shape
    u = to_numpy(macro.u, (3,) + shape)
    E_a = to_numpy(E, (3,) + shape)
    np.savez_compressed(
        path,
        t=np.float64(t),
        rho=to_numpy(macro.rho, shape),
        ux=u[0], uy=u[1], uz=u[2],
        charge=to_numpy(macro.charge, shape),
        chargen=to_numpy(macro.chargen, shape),
        phi=to_numpy(phi, shape),
        Ex=E_a[0], Ey=E_a[1], Ez=E_a[2],
        temp=to_numpy(macro.temp, shape),
        grid=np.array([g.nx, g.ny, g.nz]),
    )


def save_reference_ascii(path: str, cfg: Config, macro: Macro, phi, E,
                         t: float) -> None:
    """data_end.dat in the reference's 12-column ASCII layout, with its
    wall extrapolation applied first."""
    g = cfg.grid
    shape = g.shape
    rho = wall_extrapolate_np(to_numpy(macro.rho, shape))
    u = wall_extrapolate_np(to_numpy(macro.u, (3,) + shape))
    charge = wall_extrapolate_np(to_numpy(macro.charge, shape))
    chargen = wall_extrapolate_np(to_numpy(macro.chargen, shape))
    phi_a, temp = to_numpy(phi, shape), to_numpy(macro.temp, shape)
    E_a = to_numpy(E, (3,) + shape)
    cols = np.stack([
        np.full(g.num_nodes, t),
        u[0].ravel(), u[1].ravel(), u[2].ravel(), rho.ravel(),
        charge.ravel(), chargen.ravel(), phi_a.ravel(),
        E_a[0].ravel(), E_a[1].ravel(), E_a[2].ravel(), temp.ravel(),
    ], axis=1)
    with open(path, "w") as f:
        for row in cols:
            f.write(" ".join(f"{v:10.6f}" for v in row) + "\n")
