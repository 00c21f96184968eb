"""The seeded inputs of a run: a smooth perturbation of the cold start's
macroscopic fields, and where in the window the check samples a chunk.

A traffic file's `perturbation` gives, per field, a size: the velocity
components in m/s (`u`), the ion concentrations as a share of their own
value (`charge`, `chargen`), the temperature in units of TH (`temp`).
Each field gets `modes` standing waves cos(2 pi kx x/NX + ax) cos(2 pi ky
y/NY + ay) sin(pi kz z/(NZ-1)), wavenumbers up to `k_max` = (kx, ky, kz)
(kz >= 1, so the plates are never touched), amplitudes uniform in
[-size, size] / modes.  Every seed perturbs the same fields by waves of
the same kind; the grid, the steps and the work are the seed's in nothing.

The numbers are drawn on the host from the seed (a few hundred of them,
the same on every device) and the fields are built on the device.
"""
from __future__ import annotations

import math
import random

import torch

FIELDS = ("ux", "uy", "uz", "charge", "chargen", "temp")


def _draws(seed: int, modes: int):
    rng = random.Random(f"ekbench-perturb-{seed}")
    return {name: [[rng.random() for _ in range(6)] for _ in range(modes)]
            for name in FIELDS}


def _field(shape, spec, k_max, size, device):
    nz, ny, nx = shape
    kw = dict(dtype=torch.float64, device=device)
    z = torch.arange(nz, **kw)[:, None, None]
    y = torch.arange(ny, **kw)[None, :, None]
    x = torch.arange(nx, **kw)[None, None, :]
    out = torch.zeros(shape, **kw)
    for amp, rx, ry, rz, px, py in spec:
        kx = min(int(rx * (k_max[0] + 1)), k_max[0])
        ky = min(int(ry * (k_max[1] + 1)), k_max[1])
        kz = 1 + min(int(rz * k_max[2]), k_max[2] - 1)
        a = (2.0 * amp - 1.0) * size / len(spec)
        out += (a * torch.sin(math.pi * kz * z / (nz - 1))
                * torch.cos(2.0 * math.pi * kx * x / nx + 2.0 * math.pi * px)
                * torch.cos(2.0 * math.pi * ky * y / ny + 2.0 * math.pi * py))
    out[0] = out[-1] = 0.0       # sin(pi kz) is not exactly 0 in floating point
    return out


def perturbation(shape, traffic: dict, seed: int, device):
    """{field: float64 tensor (NZ, NY, NX)} for FIELDS."""
    p = traffic["perturbation"]
    draws = _draws(seed, p["modes"])
    size = {"ux": p["u"], "uy": p["u"], "uz": p["u"], "charge": p["charge"],
            "chargen": p["chargen"], "temp": p["temp"]}
    return {name: _field(shape, draws[name], p["k_max"], size[name], device)
            for name in FIELDS}


def apply(rho, u, charge, chargen, temp, d: dict, TH: float):
    """The perturbed macroscopic fields, in the fields' own type: u + du,
    c (1 + dc), T + TH dT."""
    dt = rho.dtype
    du = torch.stack([d["ux"], d["uy"], d["uz"]]).to(dt)
    return (rho, u + du, charge * (1.0 + d["charge"].to(dt)),
            chargen * (1.0 + d["chargen"].to(dt)),
            temp + (TH * d["temp"]).to(dt))


def check_fraction(traffic: dict, seed: int) -> float:
    """Where in the window the checked chunk starts, as a share of
    --seconds, uniform over the traffic's `check_at` range."""
    lo, hi = traffic["check_at"]
    return lo + (hi - lo) * random.Random(f"ekbench-check-{seed}").random()


def sample_planes(nz: int, count: int, seed: int):
    """The z planes of the initial populations the check compares: both
    plates and `count` - 2 interior planes drawn from the seed."""
    rng = random.Random(f"ekbench-planes-{seed}")
    inner = rng.sample(range(1, nz - 1), min(count - 2, nz - 2))
    return sorted({0, nz - 1, *inner})
