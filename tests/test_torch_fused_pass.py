"""The one-device time loop cut at the stream (`kernels.step._chunk`: one
collide, n - 1 fused passes, one stream), on the CPU, where every launch
runs its plain version (`fused_pass` runs `fused_pass_reference`).

- Every route of the chunk equals the JAX oracle (`ekpnp.step.step_jit`,
  as tests/test_torch_step.py runs it) after 1, 2 and 3 steps on the
  physics matrix, f64, rtol 1e-11 / atol 1e-13: the plain RHS
  (`fft_method="fft"`), hartley_x (`multi_step_rhs`) and phi_hx
  (`multi_step`).  One JAX run (the Hartley solve) serves the three: the
  fft and Hartley solves agree to roundoff, far inside the tolerance.
- The fused pass is the stream of one step and the collide of the next,
  bit for bit, in every form.
- Chunks of 2 + 3 steps equal one chunk of 5 bit for bit where the chunk
  boundary carries the state exactly (real phi).
- The donated buffers: with each launch writing into the set it is given,
  as on the card, a chunk equals its steps bit for bit.
"""
import numpy as np
import pytest
import torch

from test_torch_common import (CASES, FIELDS, assert_fields_close, configs,
                               jax_state, make_state_np, port_state, to_np)

STEPS = 3


def _jax_states(cfg, arrays, n):
    """The JAX oracle's state after each of n steps, numpy dicts."""
    from ekpnp.step import step_jit

    st, out = jax_state(arrays), []
    for _ in range(n):
        st, _ = step_jit(cfg, st)
        out.append({k: (None if getattr(st, k) is None
                        else np.asarray(getattr(st, k))) for k in FIELDS})
    return out


def _routes(case):
    """(label, port config, chunk function) of every route a case takes:
    the plain RHS always, with EK on also hartley_x and phi_hx."""
    from ekpnp_torch.kernels.step import multi_step, multi_step_rhs

    _, plain = configs(case, fft_method="fft")
    _, hartley = configs(case)
    routes = [("plain RHS", plain, multi_step)]
    if hartley.physics.enable_ek:
        routes += [("hartley_x", hartley, multi_step_rhs),
                   ("phi_hx", hartley, multi_step)]
    return routes


def _equal(a, b, label):
    for k in FIELDS + ("t",):
        x, y = getattr(a, k), getattr(b, k)
        assert (x is None) == (y is None), f"{label}{k}"
        assert x is None or torch.equal(x, y), f"{label}{k}"


@pytest.mark.parametrize("case", sorted(CASES))
def test_chunk_matches_jax_oracle(case):
    from ekpnp_torch.kernels import fused_step as fs
    from ekpnp_torch.kernels.step import phi_hx_capable

    jcfg, _ = configs(case)
    arrays = make_state_np(jcfg, seed=21)
    want = _jax_states(jcfg, arrays, STEPS)
    before = dict(fs.launches)
    for label, cfg, chunk in _routes(case):
        assert phi_hx_capable(cfg) == (label != "plain RHS")
        for n in range(1, STEPS + 1):
            got = chunk(cfg, port_state(cfg, arrays), n)
            assert_fields_close(want[n - 1],
                                {k: to_np(getattr(got, k)) for k in FIELDS},
                                label=f"{case} {label} n={n}: ")
            np.testing.assert_allclose(float(got.t), n * jcfg.dt,
                                       rtol=1e-15)
    assert fs.launches == before  # CPU tensors launch nothing


def _post_set(cfg, arrays):
    """A post-collision set of a seeded state and its phi (collide_reference
    of the state)."""
    from ekpnp_torch.kernels import fused_step as fs

    st = port_state(cfg, arrays)
    *post, _ = fs.collide_reference(cfg, st.f, st.h, st.hn, st.g, st.phi,
                                    hartley_x=False)
    return post, st.phi


@pytest.mark.parametrize("case", ["A", "C", "E", "I"])
def test_fused_pass_is_stream_then_collide(case):
    """fused_pass (every form) and fused_pass_reference equal
    stream_bc_reference followed by collide_reference, bit for bit."""
    from ekpnp_torch.kernels import fused_step as fs
    from ekpnp_torch.ops.poisson import psi_hx_from_phi

    _, cfg = configs(case)
    post, phi = _post_set(cfg, make_state_np(cfg, seed=22))
    forms = [dict(hartley_x=False)]
    if cfg.physics.enable_ek:
        forms += [dict(hartley_x=True), dict(phi_hx=True)]
    for kw in forms:
        p = psi_hx_from_phi(cfg, phi) if kw.get("phi_hx") else phi
        want = fs.collide_reference(cfg, *fs.stream_bc_reference(cfg, *post),
                                    p, **kw)
        for got in (fs.fused_pass(cfg, *post, p, **kw),
                    fs.fused_pass_reference(cfg, *post, p, **kw)):
            assert len(got) == len(want) == 5
            for a, b in zip(got, want):
                assert (a is None) == (b is None), (case, kw)
                assert a is None or torch.equal(a, b), (case, kw)


@pytest.mark.parametrize("case", ["A", "C", "E", "I"])
def test_chunks_compose_bit_for_bit(case):
    """Chunks of 2 + 3 steps equal one chunk of 5 bit for bit where real
    phi crosses the boundary (the plain-RHS and hartley_x routes).  The
    phi_hx route decodes psi_hx at a chunk's end and encodes it again at
    the next start, a round trip that is exact only to roundoff: there
    rtol 1e-11 / atol 1e-13."""
    from ekpnp_torch.kernels.step import multi_step

    for label, cfg, chunk in _routes(case):
        arrays = make_state_np(cfg, seed=23)
        one = chunk(cfg, port_state(cfg, arrays), 5)
        two = chunk(cfg, chunk(cfg, port_state(cfg, arrays), 2), 3)
        if label == "phi_hx":
            assert chunk is multi_step
            assert_fields_close({k: to_np(getattr(one, k)) for k in FIELDS},
                                {k: to_np(getattr(two, k)) for k in FIELDS},
                                label=f"{case} {label}: ")
        else:
            _equal(one, two, f"{case} {label}: ")


def _card_like(fn, key):
    """`fn` (collide, fused_pass or stream_bc) writing its populations into
    the set passed as `key` (post / out), as its kernel does on the card,
    and returning that set; the set must not share storage with an input
    (the populations, phi, and a shard's edge rows and columns)."""
    def run(cfg, *args, **kw):
        buf = kw.get(key)
        res = fn(cfg, *args, **kw)
        if buf is None:
            return res
        edges = [t for e in (kw.get("rows"), kw.get("cols")) if e
                 for pair in e if pair for t in pair]
        taken = {a.untyped_storage().data_ptr() for a in (*args, *edges)
                 if torch.is_tensor(a)}
        assert not any(b is not None and b.untyped_storage().data_ptr()
                       in taken for b in buf), "a launch writes its input"
        pops = tuple(None if r is None else b.copy_(r)
                     for b, r in zip(buf, res))
        return (*pops, *res[len(buf):])
    return run


@pytest.mark.parametrize("case", ["A", "E"])
def test_donated_buffers_leave_the_returned_state_intact(case, monkeypatch):
    """With every launch writing into the set it is given (the input
    state's donated buffers and one more set), the chunk never writes a set
    it still reads and never returns one it overwrote: for n = 1, 2, 3 it
    equals n two-launch steps (`step_fused`, or `step_fused_hx` between an
    encode and a decode) bit for bit, and so does a second chunk of 2 on
    the first one's output, which it donates in turn."""
    from ekpnp_torch.kernels import step as ks
    from ekpnp_torch.ops.poisson import phi_from_psi_hx, psi_hx_from_phi

    _, cfg = configs(case)
    arrays = make_state_np(cfg, seed=24)

    def fresh():  # a copy: port_state shares memory with `arrays`
        st = port_state(cfg, arrays)
        return st._replace(**{k: getattr(st, k).clone() for k in FIELDS
                              if getattr(st, k) is not None})

    def two_launch(st, n, hx):
        if hx:
            st = st._replace(phi=psi_hx_from_phi(cfg, st.phi))
            for _ in range(n):
                st = ks.step_fused_hx(cfg, st)
            return st._replace(phi=phi_from_psi_hx(cfg, st.phi))
        for _ in range(n):
            st, _ = ks.step_fused(cfg, st)
        return st

    routes = [(ks.multi_step_rhs, False)]
    if ks.phi_hx_capable(cfg):
        routes.append((ks.multi_step, True))
    for name in ("collide", "fused_pass", "stream_bc"):
        monkeypatch.setattr(ks, name, _card_like(
            getattr(ks, name), "post" if name == "collide" else "out"))
    for chunk, hx in routes:
        for n in range(1, STEPS + 1):
            got = chunk(cfg, fresh(), n)
            _equal(got, two_launch(fresh(), n, hx), f"{case} n={n}: ")
            _equal(chunk(cfg, got, 2), two_launch(two_launch(fresh(), n, hx),
                                                  2, hx), f"{case} n={n} + 2: ")
