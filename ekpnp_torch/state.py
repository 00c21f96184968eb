"""State and macroscopic-field tuples of the port.

Same meaning and layout as `ekpnp/state.py`: populations are (Q, Z, Y, X)
tensors, direction-major with x fastest, so every direction is one
contiguous (Z, Y, X) volume; the rest population is index 0.  `State`
holds the post-stream (pre-collision) populations, the last potential and
the time.  Optional physics (ions, temperature) are `None` entries.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .device import resolve_device, torch_dtype

Tensor = torch.Tensor


class State(NamedTuple):
    """Full simulation state after a step (pre-collision populations)."""

    f: Tensor                # fluid populations, (Q, Z, Y, X)
    h: Optional[Tensor]      # (+) ion populations, or None if EK disabled
    hn: Optional[Tensor]     # (-) ion populations (two-species runs only)
    g: Optional[Tensor]      # temperature populations, or None
    phi: Optional[Tensor]    # electric potential, (Z, Y, X); E = -grad(phi)
    t: Tensor                # physical time, 0-d tensor


class Macro(NamedTuple):
    """Moments of the pre-collision populations with the half-force
    velocity correction and the z=0 wall extrapolation."""

    rho: Tensor              # (Z, Y, X)
    u: Tensor                # (3, Z, Y, X) — (ux, uy, uz)
    charge: Optional[Tensor]
    chargen: Optional[Tensor]
    temp: Optional[Tensor]


def zeros_state(cfg, device="cuda", dtype=None) -> State:
    """An all-zero state with the tensors this configuration carries."""
    dev = resolve_device(device)
    dtype = torch_dtype(dtype or cfg.run.dtype)
    p = cfg.physics

    def zeros(q=None):
        shape = cfg.grid.shape if q is None else (q,) + cfg.grid.shape
        return torch.zeros(shape, dtype=dtype, device=dev)

    qs = cfg.scalar_lat.Q
    return State(
        f=zeros(cfg.lattice.Q),
        h=zeros(qs) if p.enable_ek else None,
        hn=zeros(qs) if p.enable_ek and p.two_species else None,
        g=zeros(qs) if p.enable_thermal else None,
        phi=zeros() if p.enable_ek else None,
        t=torch.zeros((), dtype=dtype, device=dev),
    )
