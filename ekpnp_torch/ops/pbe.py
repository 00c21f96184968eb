"""Poisson-Boltzmann initialization of the electric double layer (port of
ekpnp/ops/pbe.py), as a plain Python loop.

Per iteration:
  1. Boltzmann closure  c+- = chargeinf exp(-+ e phi / kB T);
  2. spectral Poisson solve -> phi_solved, E;
  3. under-relaxed update phi <- omega phi_solved + (1 - omega) phi.

Exit-state semantics kept: the returned (c+, c-, E) are those computed
inside the final iteration (from the pre-relaxation phi), while phi carries
the final relaxed update.
"""
from __future__ import annotations

import torch

from ..config import Config
from .poisson import poisson_solve


def boltzmann_closure(cfg: Config, phi):
    p = cfg.physics
    a = p.electron / (p.kB * p.roomT)
    c = p.chargeinf * torch.exp(-a * phi)
    cn = p.chargeinf * torch.exp(a * phi) if p.two_species else torch.zeros_like(c)
    return c, cn


def pb_init(cfg: Config, phi0, with_residual: bool = False):
    """Run the PB relaxation loop; returns (phi, charge, chargen, E), plus
    the final relative update ||phi_new - phi||_inf / ||phi||_inf as a 0-d
    tensor with with_residual=True."""
    p = cfg.physics
    omega = p.pb_omega
    tiny = 1e-300 if phi0.dtype == torch.float64 else 1e-30

    phi = phi0
    c, cn = boltzmann_closure(cfg, phi0)
    E = torch.zeros((3,) + cfg.grid.shape, dtype=phi0.dtype, device=phi0.device)
    res = torch.tensor(float("inf"), dtype=phi0.dtype, device=phi0.device)
    for i in range(p.pb_iters):
        c, cn = boltzmann_closure(cfg, phi)
        phi_solved, E = poisson_solve(cfg, c, cn)
        phi_new = omega * phi_solved + (1.0 - omega) * phi
        if with_residual and i == p.pb_iters - 1:
            res = (torch.max(torch.abs(phi_new - phi))
                   / torch.clamp(torch.max(torch.abs(phi)), min=tiny))
        phi = phi_new
    if with_residual:
        return phi, c, cn, E, res
    return phi, c, cn, E
