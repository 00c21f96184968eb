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

Sharded runs (ekpnp_torch/parallel): every solve takes `mesh`; its fields
are then lists of per-shard blocks in mesh order, laid out as the state's
phi (z whole, y and x cut by the mesh; None for another process's block),
and the (y, x) stages run distributed (parallel/fft.py).  The z stages, the symbol and the lifting
are per shard.  The psi_hx codec needs x whole: slab meshes only.

Dispatch of fft_method="auto" follows the tensor's device: the CPU takes
the odd-extension FFT (the golden values rely on it), the card takes the
DST/Hartley matrix-product form.  The solve is plain tensor code: in the
JAX package it is XLA code, not a Pallas kernel.
"""
from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import Config


def _shards(a, mesh):
    """The blocks of a field: the list itself on a mesh, [a] without."""
    return a if mesh is not None else [a]


def _unshards(blocks, mesh):
    return blocks if mesh is not None else blocks[0]


def _each(fn, blocks, *more):
    """[fn(block, *more) per block], None for another process's block."""
    return [None if b is None else fn(b, *m) for b, *m in zip(blocks, *more)]


def _first(blocks):
    """A block this process holds."""
    return next(b for b in blocks if b is not None)


def _blocks(cfg: Config, mesh):
    """(y0, ny, x0, nx) of each block (the whole grid without a mesh; None
    for another process's block)."""
    if mesh is None:
        return [(0, cfg.grid.ny, 0, cfg.grid.nx)]
    return mesh.each(lambda i: mesh.block(cfg, i))


def _xy(fn, blocks, mesh, **kw):
    """A (y, x) transform: distributed over the mesh, or on the one block."""
    return fn(blocks, mesh, **kw) if mesh is not None else [fn(blocks[0], **kw)]


def _x_whole(mesh, what: str):
    if mesh is not None and mesh.pencil:
        raise ValueError(f"{what} needs x whole on every shard: slab meshes "
                         f"only (a pencil cuts x)")


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
                       extra_scale: float, block=None):
    """-extra_scale / mu on the DST modes m = 1..NZ-2, (NZ-2, NY, NX); on a
    shard its block (y0, ny, x0, nx) alone, the same values."""
    g = cfg.grid
    kx, ky, _ = wavenumbers(cfg, np.float64)
    if block is not None:
        y0, nyl, x0, nxl = block
        ky, kx = ky[y0:y0 + nyl], kx[x0:x0 + nxl]
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


def _inv_symbols(cfg: Config, blocks, mesh):
    """-1/mu of each block, with the combined inverse scale of the DST-I
    (4/NE) and the Hartley/DFT (1/(NY*NX)) stages folded in."""
    g = cfg.grid
    scale = 4.0 / (g.ne * g.ny * g.nx)
    if mesh is None:
        return [_scaled_inv_symbol(cfg, blocks[0].dtype, blocks[0].device,
                                   scale)]
    return _each(lambda b, blk: _scaled_inv_symbol(cfg, b.dtype, b.device,
                                                   scale, blk),
                 blocks, _blocks(cfg, mesh))


def _pin_plates(cfg: Config, phi):
    phi[0] = cfg.physics.voltage
    phi[-1] = cfg.physics.voltage2
    return phi


def poisson_phi_from_rhs(cfg: Config, rhs, mesh=None, rhs_hx: bool = False):
    """phi (NZ, NY, NX) from the interior RHS rows z=1..NZ-2 (what the
    fused step emits).  fft_method "fft" runs the x, y stages by FFT;
    every other value by the real Hartley matrices.  With `mesh`, `rhs`
    and the result are lists of shards.

    rhs_hx=True: the RHS arrives already transformed along x (the fused
    step's hartley_x form); the separable stages commute, so the solve
    skips its forward x stage and runs the inverse one last."""
    from ..parallel.fft import (dst_z, dst_z_padded, fft2_xy, hartley2_xy,
                                hartley_x_local, hartley_y)

    g = cfg.grid
    if rhs_hx and cfg.run.fft_method == "fft":
        raise ValueError("rhs_hx RHS is Hartley-space; fft_method='fft' "
                         "cannot consume it")
    if rhs_hx:
        _x_whole(mesh, "rhs_hx")
    blocks = _shards(rhs, mesh)
    dtype = _first(blocks).dtype
    inv = _inv_symbols(cfg, blocks, mesh)
    s_z = _each(dst_z, blocks)
    mul = lambda a: _each(torch.mul, a, inv)
    if rhs_hx:
        back = _each(hartley_x_local,
                     _xy(hartley_y, mul(_xy(hartley_y, s_z, mesh)), mesh))
    elif cfg.run.fft_method != "fft":
        back = _xy(hartley2_xy, mul(_xy(hartley2_xy, s_z, mesh)), mesh)
    else:
        back = _each(lambda b: b.real.to(dtype) * float(g.ny * g.nx),
                     _xy(fft2_xy, mul(_xy(fft2_xy, s_z, mesh)), mesh,
                         inverse=True))
    return _unshards(_each(lambda b: _pin_plates(
        cfg, dst_z_padded(b) + lifting_profile(cfg, dtype, b.device)), back),
        mesh)


def poisson_psi_hx_from_rhs(cfg: Config, rhs_hx, mesh=None):
    """The solve with neither x stage: x-Hartley RHS in (hartley_x),
    x-Hartley potential psi_hx (NZ, NY, NX) out, its wall rows exactly zero
    (dst_z_padded emits them), with phi = H_x(psi_hx) + lifting
    (phi_from_psi_hx; the fused step's phi_hx form decodes it in the
    kernel).  With `mesh`, lists of shards."""
    from ..parallel.fft import dst_z, dst_z_padded, hartley_y

    if cfg.run.fft_method == "fft":
        raise ValueError("psi_hx solve requires the Hartley (matmul) path")
    blocks = _shards(rhs_hx, mesh)
    inv = _inv_symbols(cfg, blocks, mesh)
    spec = _each(torch.mul, _xy(hartley_y, _each(dst_z, blocks), mesh), inv)
    return _unshards(_each(dst_z_padded, _xy(hartley_y, spec, mesh)), mesh)


def phi_from_psi_hx(cfg: Config, psi, mesh=None):
    """Decode the x-Hartley potential: phi = H_x(psi) + lifting.  The wall
    rows come out voltage / voltage2 (psi's wall rows are zero).  With a
    (slab) `mesh`, per shard."""
    from ..parallel.fft import hartley_x_local

    _x_whole(mesh, "the psi_hx codec")
    return _unshards(_each(lambda s: hartley_x_local(s) + lifting_profile(
        cfg, s.dtype, s.device), _shards(psi, mesh)), mesh)


def psi_hx_from_phi(cfg: Config, phi, mesh=None):
    """Encode real phi into x-Hartley space: psi = H_x(phi - lifting)/NX
    (H_x is self-inverse up to NX).  With a (slab) `mesh`, per shard."""
    from ..parallel.fft import hartley_x_local

    _x_whole(mesh, "the psi_hx codec")
    return _unshards(_each(lambda s: hartley_x_local(
        s - lifting_profile(cfg, s.dtype, s.device)) * (1.0 / cfg.grid.nx),
        _shards(phi, mesh)), mesh)


def poisson_solve_dst(cfg: Config, charge, chargen, mesh=None):
    """Reduced solve from the ion concentrations."""
    rhs = _each(lambda c, cn: charge_rhs(cfg, c, cn), _shards(charge, mesh),
                _shards(chargen, mesh))
    return poisson_phi_from_rhs(cfg, _unshards(rhs, mesh), mesh)


def _poisson_phi_ext(cfg: Config, charge, chargen, mesh=None):
    """Odd-extension solve: (c+, c-) -> phi."""
    from ..parallel.fft import fft3

    g = cfg.grid
    cs = _shards(charge, mesh)
    dtype = _first(cs).dtype
    ext = _each(lambda c, cn: odd_extension(cfg, c, cn), cs,
                _shards(chargen, mesh))
    mu = minus_laplacian_symbol(cfg)

    def divide(s, block):
        y0, nyl, x0, nxl = block
        m = torch.as_tensor(mu[:, y0:y0 + nyl, x0:x0 + nxl]).to(
            device=s.device, dtype=dtype)
        s = s / (-m)
        # The DC bin of the odd-extended RHS is zero by symmetry; in f32
        # the +-voltage/dz^2 folds leave summation noise there that mu=1
        # would turn into a constant offset in phi, so it is zeroed
        # explicitly.
        if y0 == 0 and x0 == 0:
            s[0, 0, 0] = 0.0
        return s

    out = _each(divide, _xy(fft3, ext, mesh), _blocks(cfg, mesh))
    # .real is a strided view of the complex result: copied to a
    # contiguous phi, which the kernels take
    return _unshards(_each(lambda p: _pin_plates(
        cfg, p[: g.nz].real.to(dtype).contiguous()),
        _xy(fft3, out, mesh, inverse=True)), mesh)


def poisson_phi(cfg: Config, charge, chargen, mesh=None):
    """One potential solve.  "fft": the odd-extension FFT; "dst"/"matmul":
    the reduced DST/Hartley form; "auto": the FFT form for CPU tensors, the
    reduced form on the card.  With `mesh`, lists of shards."""
    m = cfg.run.fft_method
    cpu = _first(_shards(charge, mesh)).device.type == "cpu"
    if m == "fft" or (m == "auto" and cpu):
        return _poisson_phi_ext(cfg, charge, chargen, mesh)
    return poisson_solve_dst(cfg, charge, chargen, mesh)


def poisson_solve(cfg: Config, charge, chargen):
    """(phi, E)."""
    phi = poisson_phi(cfg, charge, chargen)
    return phi, efield(cfg, phi)


class PhiHalo(NamedTuple):
    """The E stencil's reads off one shard of phi (NZ, NY, NX): the rows
    y = -1 and y = NY (NZ, NX) from the y-neighbours and, on a pencil, the
    columns x = -1 and x = NX (NZ, NY) from the x-neighbours (None where x
    is whole)."""
    ylo: torch.Tensor
    yhi: torch.Tensor
    xlo: Optional[torch.Tensor] = None
    xhi: Optional[torch.Tensor] = None


def pad_halo(phi, halo: PhiHalo):
    """phi with its halo around it, (NZ, NY+2, NX[+2]); the corners, which
    the cross-shaped stencil never reads, are zero."""
    a = torch.cat([halo.ylo[:, None], phi, halo.yhi[:, None]], dim=1)
    if halo.xlo is None:
        return a
    zero = a.new_zeros((a.shape[0], 1))
    col = lambda c: torch.cat([zero, c, zero], dim=1)[:, :, None]
    return torch.cat([col(halo.xlo), a, col(halo.xhi)], dim=2)


def efield(cfg: Config, phi, halo: Optional[PhiHalo] = None):
    """E = -grad(phi) by centered differences with periodic wrap, then the
    one-sided Ez copy at the walls.  (3, Z, Y, X).  On a shard, `halo`
    holds the neighbours' rows (and columns) the stencil reads in place of
    the wrap."""
    if halo is not None:
        E = efield(cfg, pad_halo(phi, halo))[:, :, 1:-1]
        return E[..., 1:-1] if halo.xlo is not None else E
    g = cfg.grid

    def grad(axis, d):
        return (torch.roll(phi, 1, axis) - torch.roll(phi, -1, axis)) * (0.5 / d)

    Ez = grad(0, g.dz)
    Ez[0] = Ez[1]
    Ez[-1] = Ez[-2]
    return torch.stack([grad(2, g.dx), grad(1, g.dy), Ez])
