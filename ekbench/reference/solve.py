"""The spectral Poisson solve, E = -grad(phi) and the Poisson-Boltzmann
cold start, in plain PyTorch.

The potential between the two plates solves
    lap(phi) = -convertCtoCharge (c+ - c-) / eps
on rows z = 1..NZ-2, periodic in x and y, phi = voltage / voltage2 on the
plates.  The plates ride on a z-linear lifting profile; the rest is a DST-I
in z (second-order modified wavenumber 4/dz^2 sin^2(pi m / NE), NE =
2 (NZ - 1)) and a real Hartley transform in y and x (exact wavenumbers),
each a product with its matrix.  Those products are the reference's only
matrix products: full float32 with TF32 off, or with `tf32=True` their
operands rounded to TF32 (10 mantissa bits) first, as the tensor cores'
TF32 mode rounds them.
"""
from __future__ import annotations

import contextlib
from functools import lru_cache

import numpy as np
import torch

from .params import Params


@contextlib.contextmanager
def full_f32():
    """Matrix products in full float32 inside the block (TF32 off)."""
    mm = torch.backends.cuda.matmul.allow_tf32
    cd = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


def round_tf32(a):
    """a rounded to the nearest TF32 value (8-bit exponent, 10-bit
    mantissa), ties away from zero, kept in float32."""
    if a.dtype != torch.float32:
        return a
    bits = a.view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def _mm(a, b, tf32):
    if tf32:
        a, b = round_tf32(a), round_tf32(b)
    return torch.matmul(a, b)


@lru_cache(maxsize=16)
def _matrices(n_z: int, ny: int, nx: int, dtype, device):
    """DST-I (n_z x n_z), Hartley along y (ny x ny) and x (nx x nx)."""
    m = np.arange(1, n_z + 1)
    dst = np.sin(np.pi * np.outer(m, m) / (n_z + 1))

    def cas(n):
        jk = np.outer(np.arange(n), np.arange(n)) * (2.0 * np.pi / n)
        return np.cos(jk) + np.sin(jk)

    to = lambda a: torch.as_tensor(a).to(device=device, dtype=dtype)
    return to(dst), to(cas(ny)), to(cas(nx))


@lru_cache(maxsize=16)
def _inverse_symbol(P: Params, dtype, device):
    """-scale / (sz(m) + ky^2 + kx^2) on the DST modes m = 1..NZ-2, with
    the inverse scales of the DST-I (4 / NE) and the two Hartley stages
    (1 / (NY NX)) folded in."""
    ne = 2 * (P.nz - 1)
    kx, ky = P.wavenumbers()
    m = np.arange(1, P.nz - 1)
    sz = (4.0 / P.dz ** 2) * np.sin(np.pi * m / ne) ** 2
    sym = sz[:, None, None] + (ky ** 2)[None, :, None] + (kx ** 2)[None, None, :]
    scale = 4.0 / (ne * P.ny * P.nx)
    return torch.as_tensor(-scale / sym).to(device=device, dtype=dtype)


def _lifting(P: Params, dtype, device):
    z = torch.arange(P.nz, dtype=torch.float64, device=device)
    prof = P.voltage + (P.voltage2 - P.voltage) * z / (P.nz - 1)
    return prof.to(dtype)[:, None, None]


def _transform(P: Params, a, tf32: bool):
    """DST-I along z, then Hartley along y and x, of (NZ-2, NY, NX)."""
    dst, hy, hx = _matrices(P.nz - 2, P.ny, P.nx, a.dtype, a.device)
    nzi = a.shape[0]
    a = _mm(dst, a.reshape(nzi, -1), tf32).reshape(nzi, P.ny, P.nx)
    a = _mm(hy, a, tf32)                      # batched over z
    return _mm(a.reshape(-1, P.nx), hx, tf32).reshape(nzi, P.ny, P.nx)


def _inverse(P: Params, a, tf32: bool):
    """Hartley along x and y, then DST-I along z (the inverse stages; the
    scales live in the symbol)."""
    dst, hy, hx = _matrices(P.nz - 2, P.ny, P.nx, a.dtype, a.device)
    nzi = a.shape[0]
    a = _mm(a.reshape(-1, P.nx), hx, tf32).reshape(nzi, P.ny, P.nx)
    a = _mm(hy, a, tf32)
    return _mm(dst, a.reshape(nzi, -1), tf32).reshape(nzi, P.ny, P.nx)


def potential(P: Params, charge, chargen, tf32: bool = False):
    """phi (NZ, NY, NX) from the ion concentrations (their rows 1..NZ-2)."""
    kappa = P.convert_c_to_charge / P.eps
    rhs = (charge[1:-1] - chargen[1:-1]) * (-kappa)
    spec = _transform(P, rhs, tf32) * _inverse_symbol(P, rhs.dtype, rhs.device)
    inner = _inverse(P, spec, tf32)
    phi = _lifting(P, rhs.dtype, rhs.device).expand(P.shape).clone()
    phi[1:-1] += inner
    phi[0] = P.voltage
    phi[-1] = P.voltage2
    return phi


def efield(P: Params, phi):
    """E = -grad(phi), (3, NZ, NY, NX) as (Ex, Ey, Ez): centred
    differences with periodic wrap in every direction, then Ez of each
    plate copied from its neighbouring row."""
    def grad(axis, d):
        return (torch.roll(phi, 1, axis) - torch.roll(phi, -1, axis)) * (0.5 / d)

    ez = grad(0, P.dz)
    ez[0] = ez[1]
    ez[-1] = ez[-2]
    return torch.stack([grad(2, P.dx), grad(1, P.dy), ez])


def boltzmann(P: Params, phi):
    """c+ and c- in Boltzmann equilibrium with phi."""
    a = P.electron / (P.kB * P.roomT)
    return (P.chargeinf * torch.exp(-a * phi),
            P.chargeinf * torch.exp(a * phi))


def pb_cold_start(P: Params, device, dtype, tf32: bool = False):
    """The Poisson-Boltzmann relaxation of the double layer (LBM.cu:89):
    pb_iters times the Boltzmann closure, a solve and the under-relaxed
    update phi <- omega phi_solved + (1 - omega) phi, from phi = voltage.
    Returns (phi, c+, c-) with c+- the last closure's (of the phi before
    its update)."""
    omega = P.pb_omega
    phi = torch.full(P.shape, P.voltage, dtype=dtype, device=device)
    c = cn = None
    for _ in range(P.pb_iters):
        c, cn = boltzmann(P, phi)
        phi = omega * potential(P, c, cn, tf32) + (1.0 - omega) * phi
    return phi, c, cn


def temperature_profile(P: Params, device, dtype):
    """The cold start's linear profile TH (lz - dz z) / lz, lz = (NZ-1) dz."""
    z = torch.arange(P.nz, dtype=torch.float64, device=device)
    lz = (P.nz - 1) * P.dz
    prof = P.TH * (lz - P.dz * z) / lz
    return prof.to(dtype)[:, None, None].expand(P.shape).contiguous()

