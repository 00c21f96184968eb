"""Legacy binary VTK exporter, STRUCTURED_POINTS (port of ekpnp/io/vtk.py).

Companion to the Tecplot writer: the same fields the reference dumps in
save_data_tecplot (LBM.cu:2492-2565), including its wall-node linear
extrapolation of (rho, c+, c-, u), in a format ParaView and VisIt open
directly.  The files equal the JAX package's byte for byte.

Legacy VTK binary payloads are big-endian by specification; doubles
throughout (the reference is double precision).
"""
from __future__ import annotations

import numpy as np

from ..config import Config
from ..state import Macro
from .tecplot import _gather_columns


def write_vtk(path: str, cfg: Config, macro: Macro, phi, E, time: float) -> None:
    g = cfg.grid
    cols = _gather_columns(cfg, macro, phi, E)  # 14 reference columns, (N,)
    n = g.num_nodes

    def be(a):
        """Big-endian float64 bytes (legacy VTK binary requirement)."""
        return np.ascontiguousarray(a, dtype=">f8").tobytes()

    with open(path, "wb") as f:
        w = lambda s: f.write(s.encode("ascii"))
        w("# vtk DataFile Version 3.0\n")
        w(f"ekpnp t={time:g}\n")
        w("BINARY\n")
        w("DATASET STRUCTURED_POINTS\n")
        # VTK point order is x-fastest — the C-order ravel of (Z, Y, X)
        w(f"DIMENSIONS {g.nx} {g.ny} {g.nz}\n")
        w("ORIGIN 0 0 0\n")
        w(f"SPACING {g.dx:.9e} {g.dy:.9e} {g.dz:.9e}\n")
        w(f"POINT_DATA {n}\n")

        w("VECTORS velocity double\n")
        f.write(be(np.stack(cols[3:6], axis=1)))
        for name, col in [
            ("p", cols[6]),
            ("charge", cols[7]),
            ("neg_charge", cols[8]),
            ("phi", cols[9]),
            ("Temperature", cols[13]),
        ]:
            w(f"\nSCALARS {name} double\nLOOKUP_TABLE default\n")
            f.write(be(col))
        w("\nVECTORS E double\n")
        f.write(be(np.stack(cols[10:13], axis=1)))
        w("\n")


def read_vtk(path: str):
    """Minimal reader for the files write_vtk produces (round-trip tests;
    not a general VTK parser).  Returns {name: (N,) or (N,3) float64}."""
    out = {}
    with open(path, "rb") as f:
        data = f.read()
    # header scan: find DIMENSIONS and each attribute block
    lines = data.split(b"\n")
    pos = 0
    n = None
    i = 0
    while i < len(lines):
        line = lines[i]
        tok = line.split()
        if tok[:1] == [b"POINT_DATA"]:
            n = int(tok[1])
        if tok[:1] in ([b"SCALARS"], [b"VECTORS"]) and n is not None:
            name = tok[1].decode()
            ncomp = 3 if tok[0] == b"VECTORS" else 1
            # binary payload starts after this line (+ LOOKUP_TABLE line
            # for scalars)
            skip = 2 if tok[0] == b"SCALARS" else 1
            start = pos + sum(len(lines[j]) + 1 for j in range(i, i + skip))
            nbytes = n * ncomp * 8
            arr = np.frombuffer(data[start : start + nbytes], dtype=">f8")
            out[name] = (
                arr.astype(np.float64).reshape(n, ncomp) if ncomp == 3
                else arr.astype(np.float64)
            )
            # re-sync line iteration past the binary blob
            rest = data[start + nbytes :]
            lines = rest.split(b"\n")
            pos = start + nbytes
            i = 0
            continue
        pos += len(line) + 1
        i += 1
    return out
