"""The port's differentiable step (`ekpnp_torch.kernels.step.step_diff`, a
torch.autograd.Function: the kernel step forward, the plain step's VJP
backward) on the CPU, f64, 8x4x9, 3 steps: its gradient against jax.grad
through `ekpnp.step.step` (rtol 1e-10) and against central finite
differences, as tests/test_adjoint.py checks the JAX package."""
import numpy as np
import torch

import test_torch_common  # noqa: F401  (one torch thread per worker)

NSTEPS = 3
SHAPE = (9, 4, 8)  # (Z, Y, X)


def _charge0():
    rng = np.random.default_rng(0)
    return (0.01 + 1e-3 * rng.standard_normal(SHAPE),
            rng.standard_normal(SHAPE))


def _port_loss(cfg, step):
    """charge0 (Z, Y, X) -> kinetic energy + charge second moment after
    NSTEPS steps of `step` from the equilibrium of a uniform state."""
    from ekpnp_torch.init import state_from_macro
    from ekpnp_torch.ops.collide import compute_macro
    from ekpnp_torch.state import Macro

    kw = dict(dtype=torch.float64)

    def loss(charge0):
        macro = Macro(rho=torch.full(SHAPE, 1000.0, **kw),
                      u=torch.zeros((3,) + SHAPE, **kw), charge=charge0,
                      chargen=torch.full(SHAPE, 0.01, **kw),
                      temp=torch.full(SHAPE, 0.5, **kw))
        state = state_from_macro(cfg, macro, torch.zeros(SHAPE, **kw),
                                 torch.zeros((3,) + SHAPE, **kw), 0.0)
        for _ in range(NSTEPS):
            state = step(cfg, state)
        out, _ = compute_macro(cfg, state)
        return torch.sum(out.u ** 2) * 1e6 + torch.sum(out.charge ** 2)

    return loss


def _jax_value_and_grad(charge0):
    import jax
    import jax.numpy as jnp

    import ekpnp
    from ekpnp.init import state_from_macro
    from ekpnp.ops.collide import compute_macro
    from ekpnp.state import Macro
    from ekpnp.step import step

    cfg = ekpnp.preset("reference", nx=8, ny=4, nz=9, dtype="float64")

    def loss(c0):
        macro = Macro(rho=jnp.full(SHAPE, 1000.0), u=jnp.zeros((3,) + SHAPE),
                      charge=c0, chargen=jnp.full(SHAPE, 0.01),
                      temp=jnp.full(SHAPE, 0.5))
        state = state_from_macro(cfg, macro, jnp.zeros(SHAPE),
                                 jnp.zeros((3,) + SHAPE), 0.0)
        for _ in range(NSTEPS):
            state, _ = step(cfg, state)
        out, _ = compute_macro(cfg, state)
        return jnp.sum(out.u ** 2) * 1e6 + jnp.sum(out.charge ** 2)

    val, grad = jax.jit(jax.value_and_grad(loss))(jnp.asarray(charge0))
    return float(val), np.asarray(grad)


def _cfg():
    import ekpnp_torch

    return ekpnp_torch.preset("reference", nx=8, ny=4, nz=9, dtype="float64")


def test_step_diff_grad_equals_jax_grad():
    from ekpnp_torch.kernels.step import step_diff

    c0, _ = _charge0()
    x = torch.tensor(c0, requires_grad=True)
    val = _port_loss(_cfg(), step_diff)(x)
    (grad,) = torch.autograd.grad(val, x)
    jval, jgrad = _jax_value_and_grad(c0)
    np.testing.assert_allclose(val.item(), jval, rtol=1e-10)
    assert np.abs(jgrad).max() > 0
    np.testing.assert_allclose(grad.numpy(), jgrad, rtol=1e-10,
                               atol=1e-10 * np.abs(jgrad).max())


def test_step_diff_matches_finite_difference():
    from ekpnp_torch.kernels.step import step_diff

    c0, direction = _charge0()
    direction = direction / np.linalg.norm(direction)
    loss = _port_loss(_cfg(), step_diff)
    x = torch.tensor(c0, requires_grad=True)
    (grad,) = torch.autograd.grad(loss(x), x)
    eps = 1e-6
    with torch.no_grad():
        fd = (loss(torch.tensor(c0 + eps * direction)).item()
              - loss(torch.tensor(c0 - eps * direction)).item()) / (2 * eps)
    ad = float(np.vdot(grad.numpy(), direction))
    assert abs(ad - fd) <= 1e-5 * max(1.0, abs(fd)), (ad, fd)


def test_step_diff_forward_is_the_kernel_step():
    """The forward pass is `step_fused`, unchanged, and its outputs carry
    the graph back to every population input."""
    from ekpnp_torch.kernels.step import step_diff, step_fused
    from test_torch_common import make_state_np, port_state

    cfg = _cfg()
    state = port_state(cfg, make_state_np(cfg, seed=2))
    want, _ = step_fused(cfg, state)
    leaves = state._replace(**{k: getattr(state, k).clone().requires_grad_()
                               for k in ("f", "h", "hn", "g", "phi")})
    got = step_diff(cfg, leaves)
    for a, b in zip(got, want):
        assert torch.equal(a.detach(), b)
    grads = torch.autograd.grad(got.f.sum() + got.phi.sum(),
                                [leaves.f, leaves.h, leaves.phi])
    assert all(g is not None and torch.isfinite(g).all() for g in grads)
