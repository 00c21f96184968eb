"""The numbers of one configuration file (`ekbench/configs/<name>.json`),
as the reference uses them: grid, physics constants, lattices and the
TRT rates, from the upstream EK-PNP-3D definitions (LBM.h:28-125,
LBM.cu:488-495)."""
from __future__ import annotations

import dataclasses
import math

import numpy as np

# D3Q27 in the upstream's pull-stencil order (LBM.cu:1983-2008): rest, the
# six axis directions, twelve face diagonals, eight corners; opposites are
# the pairs (1, 2), (3, 4), ..., (25, 26).  D3Q19 and D3Q7 are its prefixes.
_D3Q27 = ((0, 0, 0),
          (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1),
          (1, 1, 0), (-1, -1, 0), (1, 0, 1), (-1, 0, -1), (0, 1, 1),
          (0, -1, -1), (1, -1, 0), (-1, 1, 0), (1, 0, -1), (-1, 0, 1),
          (0, 1, -1), (0, -1, 1),
          (1, 1, 1), (-1, -1, -1), (1, 1, -1), (-1, -1, 1), (1, -1, 1),
          (-1, 1, -1), (-1, 1, 1), (1, -1, -1))
_WEIGHTS = {"D3Q27": [8 / 27] + [2 / 27] * 6 + [1 / 54] * 12 + [1 / 216] * 8,
            "D3Q19": [1 / 3] + [1 / 18] * 6 + [1 / 36] * 12,
            "D3Q7": [1 / 4] + [1 / 8] * 6}


@dataclasses.dataclass(frozen=True)
class Lattice:
    name: str
    e: tuple          # ((ex, ey, ez), ...)
    w: tuple          # weights
    cs2_lat: float    # sum_i w_i ex_i^2

    @property
    def q(self) -> int:
        return len(self.e)

    def opp(self, d: int) -> int:
        return d if d == 0 else (d + 1 if d % 2 else d - 1)

    def pairs(self):
        """(d, opp(d)) with d the odd member; the rest as (0, 0)."""
        return [(0, 0)] + [(d, d + 1) for d in range(1, self.q, 2)]


def lattice(name: str) -> Lattice:
    name = name.upper()
    w = _WEIGHTS[name]
    e = _D3Q27[:len(w)]
    return Lattice(name, e, tuple(w), sum(wi * ei[0] ** 2
                                          for wi, ei in zip(w, e)))


@dataclasses.dataclass(frozen=True, eq=False)
class Params:
    """Everything the reference reads from a configuration file."""

    nx: int
    ny: int
    nz: int
    dx: float
    dy: float
    dz: float
    phys: dict
    lat: Lattice        # the fluid's
    lat_s: Lattice      # the ions' and the temperature's
    dtype: str

    @property
    def shape(self):
        return (self.nz, self.ny, self.nx)

    @property
    def nodes(self) -> int:
        return self.nx * self.ny * self.nz

    @property
    def dt(self) -> float:
        return self.phys["cfl"] * self.dx

    @property
    def cs2(self) -> float:
        return 1.0 / 3.0 / self.phys["cfl"] ** 2

    @property
    def cs2_s(self) -> float:
        return self.lat_s.cs2_lat / self.phys["cfl"] ** 2

    def __getattr__(self, key):
        phys = self.__dict__.get("phys", {})
        if key in phys:
            return phys[key]
        raise AttributeError(key)

    def rates(self) -> dict:
        """dt * omega for each population's even and odd parts (the TRT
        pair of LBM.cu:488-495): the fluid relaxes its even part by the
        viscosity, a scalar its odd part by the diffusivity; the other
        rate comes from the magic parameter."""
        dt, p = self.dt, self.phys

        def pair(diff, magic, c2):
            tau = diff / c2 / dt
            return 1.0 / (tau + 0.5), 1.0 / (magic / tau + 0.5)

        f_even, f_odd = pair(p["nu"], p["V"], self.cs2)
        h_odd, h_even = pair(p["diffu"], p["VC"], self.cs2_s)
        hn_odd, hn_even = pair(p["diffun"], p["VCn"], self.cs2_s)
        g_odd, g_even = pair(p["D"], p["VT"], self.cs2_s)
        return {"f": (f_even, f_odd), "h": (h_even, h_odd),
                "hn": (hn_even, hn_odd), "g": (g_even, g_odd)}

    def wavenumbers(self):
        """kx, ky (2 pi fftfreq / d), numpy float64."""
        two_pi = 2.0 * math.pi
        return (two_pi * np.fft.fftfreq(self.nx, d=self.dx),
                two_pi * np.fft.fftfreq(self.ny, d=self.dy))


def from_config(data: dict) -> Params:
    """Params of a configuration file's `grid`, `physics` and `run`."""
    g, p, r = data["grid"], dict(data["physics"]), data["run"]
    for key, want in (("charge_bc", "noflux"), ("joule", 0.0),
                      ("compat_ref_multis", False), ("enable_ek", True),
                      ("enable_thermal", True), ("two_species", True)):
        if p.get(key, want) != want:
            raise ValueError(f"the reference implements {key}={want!r} only")
    if r.get("perturb_first_step"):
        raise ValueError("the reference implements perturb_first_step=False")
    lat = lattice(r["lattice"])
    scal = r.get("scalar_lattice", "same")
    lat_s = lat if scal == "same" else lattice(scal)
    return Params(nx=g["nx"], ny=g["ny"], nz=g["nz"], dx=g["dx"], dy=g["dy"],
                  dz=g["dz"], phys=p, lat=lat, lat_s=lat_s, dtype=r["dtype"])
