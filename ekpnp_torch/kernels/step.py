"""Timestep built on the fused step kernels (port of ekpnp/pallas/step.py,
single device).

Each step runs the fused step (kernels/fused_step.py: CUDA kernels on the
card, their plain version on the CPU) and then the spectral solve of the
emitted RHS for the next phi.  Wherever EK is on and fft_method != "fft",
the fused step emits the RHS already transformed along x (hartley_x) and
the solve skips its forward x stage (`rhs_hx`).  `multi_step` goes one step
further wherever `phi_hx_capable` holds: the chunk carries phi as psi_hx,
encoded once and decoded once, the fused step decodes phi itself (phi_hx)
and the solve runs no x stage at all.  State goes in and out with real phi
either way.
"""
from __future__ import annotations

from ..config import Config
from ..ops.poisson import (phi_from_psi_hx, poisson_phi_from_rhs,
                           poisson_psi_hx_from_rhs, psi_hx_from_phi)
from ..state import State
from .fused_step import _CBC, _empty_like_fields, fused_step, resolve_hartley_x


def step_fused(cfg: Config, state: State, out=None, post=None):
    """One step.  Returns (state', rhs) with rhs the interior Poisson RHS
    planes (z = 1..NZ-2) from this step's pre-collision ion moments, in
    x-Hartley space where the kernel took the hartley_x form."""
    hx = resolve_hartley_x(cfg)
    f1, h1, hn1, g1, rhs = fused_step(cfg, state.f, state.h, state.hn,
                                      state.g, state.phi, out=out, post=post,
                                      hartley_x=hx)
    phi = state.phi
    if cfg.physics.enable_ek:
        phi = poisson_phi_from_rhs(cfg, rhs, rhs_hx=hx)
    t = state.t + cfg.physics.dt(cfg.grid.dx)
    return State(f=f1, h=h1, hn=hn1, g=g1, phi=phi, t=t), rhs


def step_fused_hx(cfg: Config, state: State, out=None, post=None) -> State:
    """One step in x-Hartley phi encoding: state.phi holds psi_hx
    (phi = H_x(psi) + lifting), the fused step decodes it (phi_hx) and emits
    the RHS x-transformed, and the solve returns the next psi_hx."""
    f1, h1, hn1, g1, rhs = fused_step(cfg, state.f, state.h, state.hn,
                                      state.g, state.phi, out=out, post=post,
                                      phi_hx=True)
    psi = poisson_psi_hx_from_rhs(cfg, rhs)
    t = state.t + cfg.physics.dt(cfg.grid.dx)
    return State(f=f1, h=h1, hn=hn1, g=g1, phi=psi, t=t)


def phi_hx_capable(cfg: Config) -> bool:
    """Whether a chunk can carry phi as psi_hx: EK on, a charge BC the
    kernel runs, and the Hartley solve.  The JAX package's TPU strip-width
    rule (phi_hx_profitable) is not carried over: the port takes the route
    wherever it is capable, as the JAX package's interpret mode does."""
    p = cfg.physics
    return (p.enable_ek and p.charge_bc in _CBC
            and cfg.run.fft_method != "fft")


def _chunk(cfg: Config, state: State, n: int, one_step) -> State:
    """n steps of `one_step(cfg, state, out, post) -> state` with two
    population sets and one scratch set, ping-ponged."""
    post = _empty_like_fields(cfg, state.f)
    spare = _empty_like_fields(cfg, state.f)
    for _ in range(n):
        prev = (state.f, state.h, state.hn, state.g)
        state = one_step(cfg, state, out=spare, post=post)
        spare = prev
    return state


def multi_step_rhs(cfg: Config, state: State, n: int) -> State:
    """n steps of `step_fused` (real phi between steps)."""
    return _chunk(cfg, state, n,
                  lambda c, s, out, post: step_fused(c, s, out, post)[0])


def multi_step_hx(cfg: Config, state: State, n: int) -> State:
    """n steps carrying phi as psi_hx: one encode, n `step_fused_hx` steps,
    one decode."""
    state = state._replace(phi=psi_hx_from_phi(cfg, state.phi))
    state = _chunk(cfg, state, n, step_fused_hx)
    return state._replace(phi=phi_from_psi_hx(cfg, state.phi))


def multi_step(cfg: Config, state: State, n: int) -> State:
    """n steps, by the route `ekpnp.step.multi_step` takes: `multi_step_hx`
    wherever `phi_hx_capable` holds, else `multi_step_rhs`.

    The input state's population tensors are DONATED: they serve as one of
    the two buffers and hold an intermediate step afterwards (as the JAX
    package's multi_step donates its state).  Use only the returned state."""
    if n <= 0:
        return state
    if phi_hx_capable(cfg):
        return multi_step_hx(cfg, state, n)
    return multi_step_rhs(cfg, state, n)
