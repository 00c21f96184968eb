"""Timestep built on the fused step kernels (port of ekpnp/pallas/step.py,
single device).

Each step runs the fused step (kernels/fused_step.py: CUDA kernels on the
card, their plain version on the CPU) and then the spectral solve of the
emitted RHS for the next phi.  The solve consumes the plain RHS: the TPU
kernel's in-kernel x-Hartley stages (hartley_x / phi_hx) are not ported.
"""
from __future__ import annotations

from ..config import Config
from ..ops.poisson import poisson_phi_from_rhs
from ..state import State
from .fused_step import _empty_like_fields, fused_step


def step_fused(cfg: Config, state: State, out=None, post=None):
    """One step.  Returns (state', rhs) with rhs the interior Poisson RHS
    planes (z = 1..NZ-2) from this step's pre-collision ion moments."""
    f1, h1, hn1, g1, rhs = fused_step(cfg, state.f, state.h, state.hn,
                                      state.g, state.phi, out=out, post=post)
    phi = state.phi
    if cfg.physics.enable_ek:
        phi = poisson_phi_from_rhs(cfg, rhs)
    t = state.t + cfg.physics.dt(cfg.grid.dx)
    return State(f=f1, h=h1, hn=hn1, g=g1, phi=phi, t=t), rhs


def multi_step(cfg: Config, state: State, n: int) -> State:
    """n steps with two population sets and one scratch set, ping-ponged.

    The input state's population tensors are DONATED: they serve as one of
    the two buffers and hold an intermediate step afterwards (as the JAX
    package's multi_step donates its state).  Use only the returned state."""
    if n <= 0:
        return state
    post = _empty_like_fields(cfg, state.f)
    spare = _empty_like_fields(cfg, state.f)
    for _ in range(n):
        prev = (state.f, state.h, state.hn, state.g)
        state, _ = step_fused(cfg, state, out=spare, post=post)
        spare = prev
    return state
