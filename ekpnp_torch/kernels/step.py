"""Timestep built on the fused step kernels (port of ekpnp/pallas/step.py,
single device).

A step is the fused step (kernels/fused_step.py: CUDA kernels on the card,
their plain version on the CPU) and then the spectral solve of the emitted
RHS for the next phi.  Wherever EK is on and fft_method != "fft", the RHS
comes already transformed along x (hartley_x) and the solve skips its
forward x stage (`rhs_hx`).  `multi_step` goes one step further wherever
`phi_hx_capable` holds: the chunk carries phi as psi_hx, encoded once and
decoded once, the kernels decode phi themselves (phi_hx) and the solve runs
no x stage at all.  A chunk of n steps is cut at the stream rather than
after it (`_chunk`): one collide, n - 1 fused passes (the stream of one
step and the collide of the next), one stream.  State goes in and out with
real phi either way.

`step_diff` is the differentiable step: the kernel step forward, the plain
step's VJP backward (a `torch.autograd.Function`).
"""
from __future__ import annotations

import torch

from ..config import Config
from ..ops.poisson import (phi_from_psi_hx, poisson_phi_from_rhs,
                           poisson_psi_hx_from_rhs, psi_hx_from_phi)
from ..state import State
from ..step import step as plain_step
from ..telemetry import CHUNK, PREFIX, span
from .fused_step import (_CBC, _empty_like_fields, collide, fused_pass,
                         fused_step, resolve_hartley_x, stream_bc)


# the time loop's spans (telemetry): a chunk (multi_step, and the sharded
# chunk of parallel/halo.py), its psi_hx codec, and in it at most one of
# each of the others a step (a pass with its row products)
ENCODE, DECODE = PREFIX + "encode", PREFIX + "decode"
COLLIDE, SOLVE = PREFIX + "collide", PREFIX + "solve"
PASS, STREAM = PREFIX + "pass", PREFIX + "stream"


def step_fused(cfg: Config, state: State):
    """One step.  Returns (state', rhs) with rhs the interior Poisson RHS
    planes (z = 1..NZ-2) from this step's pre-collision ion moments, in
    x-Hartley space where the kernel took the hartley_x form."""
    hx = resolve_hartley_x(cfg)
    f1, h1, hn1, g1, rhs = fused_step(cfg, state.f, state.h, state.hn,
                                      state.g, state.phi, hartley_x=hx)
    phi = state.phi
    if cfg.physics.enable_ek:
        phi = poisson_phi_from_rhs(cfg, rhs, rhs_hx=hx)
    t = state.t + cfg.physics.dt(cfg.grid.dx)
    return State(f=f1, h=h1, hn=hn1, g=g1, phi=phi, t=t), rhs


def step_fused_hx(cfg: Config, state: State) -> State:
    """One step in x-Hartley phi encoding: state.phi holds psi_hx
    (phi = H_x(psi) + lifting), the fused step decodes it (phi_hx) and emits
    the RHS x-transformed, and the solve returns the next psi_hx."""
    f1, h1, hn1, g1, rhs = fused_step(cfg, state.f, state.h, state.hn,
                                      state.g, state.phi, phi_hx=True)
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


def _chunk(cfg: Config, state: State, n: int, phi_hx: bool = False) -> State:
    """n steps cut at the stream: one collide of the route's form on the
    input state, then n - 1 times the solve and a fused pass (the stream of
    step k - 1 and the collide of step k, `fused_pass`), the last solve and
    one stream.  A pass emits step k's RHS from the pre-collision moments
    it streams in and collides with the phi the solve just made, so every
    node runs the operations of n `step_fused` steps in their order, and
    the chunk equals them bit for bit.  Two population sets ping-pong: the
    donated input state's and one more.  phi_hx: state.phi holds psi_hx
    (`step_fused_hx`'s route); else real phi (`step_fused`'s)."""
    if n <= 0:
        return state
    hx = resolve_hartley_x(cfg, None, phi_hx)
    form = dict(hartley_x=hx, phi_hx=phi_hx)
    ek = cfg.physics.enable_ek
    dt = cfg.physics.dt(cfg.grid.dx)
    spare = (state.f, state.h, state.hn, state.g)
    with span(COLLIDE):
        *post, rhs = collide(cfg, *spare, state.phi,
                             post=_empty_like_fields(cfg, state.f), **form)
    phi, t = state.phi, state.t
    for k in range(n):
        if ek:
            with span(SOLVE):
                phi = (poisson_psi_hx_from_rhs(cfg, rhs) if phi_hx else
                       poisson_phi_from_rhs(cfg, rhs, rhs_hx=hx))
        t = t + dt
        if k < n - 1:
            with span(PASS):
                *nxt, rhs = fused_pass(cfg, *post, phi, out=spare, **form)
            spare, post = tuple(post), nxt
    with span(STREAM):
        f1, h1, hn1, g1 = stream_bc(cfg, *post, out=spare)
    return State(f=f1, h=h1, hn=hn1, g=g1, phi=phi, t=t)


def multi_step_rhs(cfg: Config, state: State, n: int) -> State:
    """n steps of `step_fused`'s route (real phi between steps)."""
    return _chunk(cfg, state, n)


def multi_step_hx(cfg: Config, state: State, n: int) -> State:
    """n steps of `step_fused_hx`'s route, carrying phi as psi_hx: one
    encode, the chunk, one decode."""
    with span(ENCODE):
        state = state._replace(phi=psi_hx_from_phi(cfg, state.phi))
    state = _chunk(cfg, state, n, phi_hx=True)
    with span(DECODE):
        return state._replace(phi=phi_from_psi_hx(cfg, state.phi))


def multi_step(cfg: Config, state: State, n: int) -> State:
    """n steps, by the route `ekpnp.step.multi_step` takes: `multi_step_hx`
    wherever `phi_hx_capable` holds, else `multi_step_rhs`.

    The input state's population tensors are DONATED: they serve as one of
    the two buffers and hold an intermediate pass afterwards (as the JAX
    package's multi_step donates its state).  Use only the returned state."""
    if n <= 0:
        return state
    with span(CHUNK):
        if phi_hx_capable(cfg):
            return multi_step_hx(cfg, state, n)
        return multi_step_rhs(cfg, state, n)


class _StepDiff(torch.autograd.Function):
    """`step_diff`'s function: forward `step_fused`, backward the VJP of
    the plain step re-run on the saved input."""

    @staticmethod
    def forward(ctx, cfg, *fields):
        ctx.cfg = cfg
        ctx.save_for_backward(*fields)
        new, _ = step_fused(cfg, State(*fields))
        return tuple(new)

    @staticmethod
    def backward(ctx, *grads):
        with torch.enable_grad():
            xs = [None if x is None else x.detach().requires_grad_(True)
                  for x in ctx.saved_tensors]
            new, _ = plain_step(ctx.cfg, State(*xs))
            pairs = [(y, g) for y, g in zip(new, grads)
                     if y is not None and g is not None]
            live = [x for x in xs if x is not None]
            got = iter(torch.autograd.grad(
                [y for y, _ in pairs], live, [g for _, g in pairs],
                allow_unused=True))
        return (None, *(None if x is None else next(got) for x in xs))


def step_diff(cfg: Config, state: State) -> State:
    """One differentiable step (port of ekpnp/pallas/step.py
    step_pallas_diff): the forward pass is the kernel step (`step_fused`:
    the CUDA kernels on the card, their plain version on the CPU), the
    backward pass the exact VJP of the plain step (ekpnp_torch/step.py),
    re-run on the saved input.  The two forwards agree to roundoff
    (tests/test_torch_step.py), so the gradient is the plain step's."""
    return State(*_StepDiff.apply(cfg, *state))
