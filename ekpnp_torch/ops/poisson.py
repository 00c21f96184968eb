"""Spectral Poisson solver for the electric potential and E = -grad(phi)
(port of ekpnp/ops/poisson.py, single device).

Math, identical to the JAX package's:
  - RHS = -convertCtoCharge (c+ - c-) / eps on rows z=1..NZ-2;
  - "fft" reference form: odd extension about z = NZ-1 onto NE = 2(NZ-1)
    rows with the plate potentials folded into rows 1 and NZ-2, complex
    3-D FFT, division by -mu (2nd-order modified wavenumber in z, exact in
    x, y; zero mode pinned), inverse, plate rows pinned;
  - reduced form (`poisson_phi_from_rhs`): DST-I in z and real Hartley in
    x, y, with the plates carried by a z-linear lifting profile so the
    transformed data stays at the charge scale;
  - the x-Hartley route of the kernel step: `rhs_hx=True` takes an RHS
    already transformed along x; `poisson_psi_hx_from_rhs` also leaves its
    result in x-Hartley space (psi_hx), which the next step's kernel
    decodes (`phi_from_psi_hx` / `psi_hx_from_phi` are the codec).

Dispatch of fft_method="auto" follows the tensor's device: the CPU takes
the odd-extension FFT (the golden values rely on it), the card takes the
DST/Hartley matrix-product form.  The solve is plain tensor code: in the
JAX package it is XLA code, not a Pallas kernel.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..config import Config


def wavenumbers(cfg: Config, dtype=np.float64):
    """kx, ky (true spectral) and kz (extended domain) tables, numpy."""
    g = cfg.grid
    two_pi = 2.0 * np.pi
    kx = two_pi * np.fft.fftfreq(g.nx, d=g.dx).astype(dtype)
    ky = two_pi * np.fft.fftfreq(g.ny, d=g.dy).astype(dtype)
    kz = two_pi * np.fft.fftfreq(g.ne, d=g.dz).astype(dtype)
    return kx, ky, kz


def minus_laplacian_symbol(cfg: Config, dtype=np.float64):
    """mu(kz, ky, kx) on the extended grid, zero mode pinned to 1 (numpy)."""
    g = cfg.grid
    kx, ky, kz = wavenumbers(cfg, dtype)
    mu = (((4.0 / g.dz**2) * np.sin(kz * g.dz * 0.5) ** 2)[:, None, None]
          + (ky * ky)[None, :, None] + (kx * kx)[None, None, :])
    mu[0, 0, 0] = 1.0
    return mu


def odd_extension(cfg: Config, charge, chargen):
    """The odd-extended RHS (NE, NY, NX)."""
    p = cfg.physics
    g = cfg.grid
    inv_dz2 = 1.0 / (g.dz * g.dz)
    kappa = p.convert_c_to_charge / p.eps
    rhs = -kappa * (charge - chargen)
    plane = torch.zeros_like(rhs[0])
    top = torch.cat([
        plane[None],
        (rhs[1] - p.voltage * inv_dz2)[None],
        rhs[2: g.nz - 2],
        (rhs[g.nz - 2] - p.voltage2 * inv_dz2)[None],
        plane[None],
    ], dim=0)
    # mirror half: z in (NZ-1, NE) gets -top[NE - z]
    mirror = -torch.flip(top[1: g.nz - 1], dims=(0,))
    return torch.cat([top, mirror], dim=0)


def charge_rhs(cfg: Config, charge, chargen):
    """Charge-only RHS rows z = 1..NZ-2 (the plates ride on the lifting
    profile)."""
    p = cfg.physics
    kappa = p.convert_c_to_charge / p.eps
    return -kappa * (charge[1:-1] - chargen[1:-1])


@lru_cache(maxsize=None)
def _scaled_inv_symbol(cfg: Config, dtype: torch.dtype, device: torch.device,
                       extra_scale: float):
    """-extra_scale / mu on the DST modes m = 1..NZ-2, (NZ-2, NY, NX)."""
    g = cfg.grid
    kx, ky, _ = wavenumbers(cfg, np.float64)
    m = np.arange(1, g.nz - 1, dtype=np.float64)
    sz = (4.0 / g.dz**2) * np.sin(np.pi * m / g.ne) ** 2
    to = lambda a: torch.as_tensor(a).to(device=device, dtype=dtype)
    return -extra_scale / (to(sz)[:, None, None] + to(ky * ky)[None, :, None]
                           + to(kx * kx)[None, None, :])


@lru_cache(maxsize=None)
def lifting_profile(cfg: Config, dtype: torch.dtype, device: torch.device):
    """phi_L[z] = voltage + (voltage2 - voltage) z/(NZ-1), (NZ, 1, 1): the
    z-linear profile matching both plate potentials (zero second
    difference)."""
    p = cfg.physics
    g = cfg.grid
    z = np.arange(g.nz, dtype=np.float64)
    prof = p.voltage + (p.voltage2 - p.voltage) * z / (g.nz - 1)
    return torch.as_tensor(prof).to(device=device, dtype=dtype)[:, None, None]


def _inv_symbol(cfg: Config, like):
    """-1/mu with the combined inverse scale of the DST-I (4/NE) and the
    Hartley/DFT (1/(NY*NX)) stages folded in."""
    g = cfg.grid
    return _scaled_inv_symbol(cfg, like.dtype, like.device,
                              4.0 / (g.ne * g.ny * g.nx))


def poisson_phi_from_rhs(cfg: Config, rhs, rhs_hx: bool = False):
    """phi (NZ, NY, NX) from the interior RHS rows z=1..NZ-2 (what the
    fused step emits).  fft_method "fft" runs the x, y stages by FFT;
    every other value by the real Hartley matrices.

    rhs_hx=True: the RHS arrives already transformed along x (the fused
    step's hartley_x form); the separable stages commute, so the solve
    skips its forward x stage and runs the inverse one last."""
    from ..parallel.fft import (dst_z, dst_z_padded, fft2_xy, hartley2_xy,
                                hartley_x_local, hartley_y)

    g = cfg.grid
    p = cfg.physics
    dtype = rhs.dtype
    if rhs_hx and cfg.run.fft_method == "fft":
        raise ValueError("rhs_hx RHS is Hartley-space; fft_method='fft' "
                         "cannot consume it")
    inv_sym = _inv_symbol(cfg, rhs)
    s_z = dst_z(rhs)
    if rhs_hx:
        back = hartley_x_local(hartley_y(hartley_y(s_z) * inv_sym))
    elif cfg.run.fft_method != "fft":
        back = hartley2_xy(hartley2_xy(s_z) * inv_sym)
    else:
        back = fft2_xy(fft2_xy(s_z) * inv_sym, inverse=True).real.to(dtype) \
            * float(g.ny * g.nx)
    phi = dst_z_padded(back) + lifting_profile(cfg, dtype, rhs.device)
    phi[0] = p.voltage
    phi[-1] = p.voltage2
    return phi


def poisson_psi_hx_from_rhs(cfg: Config, rhs_hx):
    """The solve with neither x stage: x-Hartley RHS in (hartley_x),
    x-Hartley potential psi_hx (NZ, NY, NX) out, its wall rows exactly zero
    (dst_z_padded emits them), with phi = H_x(psi_hx) + lifting
    (phi_from_psi_hx; the fused step's phi_hx form decodes it in the
    kernel)."""
    from ..parallel.fft import dst_z, dst_z_padded, hartley_y

    if cfg.run.fft_method == "fft":
        raise ValueError("psi_hx solve requires the Hartley (matmul) path")
    spec = hartley_y(dst_z(rhs_hx)) * _inv_symbol(cfg, rhs_hx)
    return dst_z_padded(hartley_y(spec))


def phi_from_psi_hx(cfg: Config, psi):
    """Decode the x-Hartley potential: phi = H_x(psi) + lifting.  The wall
    rows come out voltage / voltage2 (psi's wall rows are zero)."""
    from ..parallel.fft import hartley_x_local

    return hartley_x_local(psi) + lifting_profile(cfg, psi.dtype, psi.device)


def psi_hx_from_phi(cfg: Config, phi):
    """Encode real phi into x-Hartley space: psi = H_x(phi - lifting)/NX
    (H_x is self-inverse up to NX)."""
    from ..parallel.fft import hartley_x_local

    lift = lifting_profile(cfg, phi.dtype, phi.device)
    return hartley_x_local(phi - lift) * (1.0 / cfg.grid.nx)


def poisson_solve_dst(cfg: Config, charge, chargen):
    """Reduced solve from the ion concentrations."""
    return poisson_phi_from_rhs(cfg, charge_rhs(cfg, charge, chargen))


def _poisson_phi_ext(cfg: Config, charge, chargen):
    """Odd-extension solve: (c+, c-) -> phi."""
    from ..parallel.fft import fft3

    g = cfg.grid
    p = cfg.physics
    dtype = charge.dtype
    ext = odd_extension(cfg, charge, chargen)
    mu = torch.as_tensor(minus_laplacian_symbol(cfg)).to(device=charge.device,
                                                         dtype=dtype)
    spec = fft3(ext) / (-mu)
    # The DC bin of the odd-extended RHS is zero by symmetry; in f32 the
    # +-voltage/dz^2 folds leave summation noise there that mu=1 would turn
    # into a constant offset in phi, so it is zeroed explicitly.
    spec[0, 0, 0] = 0.0
    phi = fft3(spec, inverse=True)[: g.nz].real.to(dtype)
    phi[0] = p.voltage
    phi[-1] = p.voltage2
    return phi


def poisson_phi(cfg: Config, charge, chargen):
    """One potential solve.  "fft": the odd-extension FFT; "dst"/"matmul":
    the reduced DST/Hartley form; "auto": the FFT form for CPU tensors, the
    reduced form on the card."""
    m = cfg.run.fft_method
    if m == "fft" or (m == "auto" and charge.device.type == "cpu"):
        return _poisson_phi_ext(cfg, charge, chargen)
    return poisson_solve_dst(cfg, charge, chargen)


def poisson_solve(cfg: Config, charge, chargen):
    """(phi, E)."""
    phi = poisson_phi(cfg, charge, chargen)
    return phi, efield(cfg, phi)


def efield(cfg: Config, phi):
    """E = -grad(phi) by centered differences with periodic wrap, then the
    one-sided Ez copy at the walls.  (3, Z, Y, X)."""
    g = cfg.grid

    def grad(axis, d):
        return (torch.roll(phi, 1, axis) - torch.roll(phi, -1, axis)) * (0.5 / d)

    Ez = grad(0, g.dz)
    Ez[0] = Ez[1]
    Ez[-1] = Ez[-2]
    return torch.stack([grad(2, g.dx), grad(1, g.dy), Ez])
