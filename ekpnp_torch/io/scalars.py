"""Per-scalar binary snapshots (port of ekpnp/io/scalars.py), the
reference's save_scalar (LBM.cu:2454-2490): each field dumped as raw
doubles to `nameNNNN.bin` (x-fastest order, the reference's scalar_index
layout LBM.h:182-185).

The reference declares this writer but never calls it from the loop; the
port wires it to `run --save-scalars` at every save step, as the JAX
package does.  Fields may be tensors or numpy arrays.
"""
from __future__ import annotations

import os

import numpy as np

from .tecplot import to_numpy


def save_scalar(outdir: str, name: str, step: int, arr) -> str:
    """Raw little-endian f64 dump, reference-compatible (fwrite of a
    NX*NY*NZ double buffer, LBM.cu:2472)."""
    path = os.path.join(outdir, f"{name}{step:04d}.bin")
    np.asarray(to_numpy(arr, None), dtype="<f8").tofile(path)
    return path


def load_scalar(path: str, shape) -> np.ndarray:
    data = np.fromfile(path, dtype="<f8")
    return data.reshape(shape)


def save_scalars(outdir: str, step: int, cfg, macro, phi, E) -> None:
    """Dump the 11 macroscopic fields the reference tracks (its host-mirror
    buffers, main.cu:78-96)."""
    fields = {
        "rho": macro.rho,
        "ux": macro.u[0],
        "uy": macro.u[1],
        "uz": macro.u[2],
    }
    if macro.charge is not None:
        fields.update(charge=macro.charge, chargen=macro.chargen, phi=phi,
                      Ex=E[0], Ey=E[1], Ez=E[2])
    if macro.temp is not None:
        fields["T"] = macro.temp
    for name, arr in fields.items():
        save_scalar(outdir, name, step, arr)
