"""The x-Hartley row product of the port (`kernels.fused_step.hartley_rows`,
CUDA `hartley_rows_kernel` on the card) and the x-Hartley collide forms
composed from it, on the CPU against the JAX package (f64).

hartley_rows' plain version is held to `ekpnp.parallel.fft.hartley_x_local`
(no lift) and `ekpnp.ops.poisson.phi_from_psi_hx` (lift) at rtol 1e-12, at
NX 16 and 50 and row counts that are no multiple of the kernel's tile.  The
composed forms (collide with the plain RHS, then the product; phi_hx decodes
psi first) run launch by launch through the CPU dispatch, on one device and
on each shard of a slab-2 mesh (psi's halo rows decoded), against the JAX
package's jnp collide at rtol 1e-11.  chip_smoke.py holds the CUDA kernel
to the same plain version on the card.
"""
import numpy as np
import pytest
import torch

import test_torch_common  # noqa: F401  (one torch thread per worker)
from test_torch_common import (ATOL, CASES, RTOL, jax_state, make_state_np,
                               port_state, to_np)

NAMES = ("f", "h", "hn", "g", "rhs")


def _configs(case, **grid):
    import ekpnp
    import ekpnp_torch

    name, ov = CASES[case]
    ov = dict(ov, **grid, fft_method="matmul", dtype="float64")
    return ekpnp.preset(name, **ov), ekpnp_torch.preset(name, **ov)


@pytest.mark.parametrize("lift", [False, True], ids=["plain", "lift"])
@pytest.mark.parametrize("nx", [16, 50])
def test_plain_row_product_matches_jax(nx, lift):
    """(NZ', NY, NX) blocks of 135 and 133 rows (no multiple of the 128-row
    tile) and (NZ, NX) halo rows: hartley_rows on CPU tensors (its plain
    version, no launch counted) against JAX's hartley_x_local / its
    phi_from_psi_hx, rtol 1e-12."""
    import jax.numpy as jnp
    from ekpnp.ops.poisson import phi_from_psi_hx
    from ekpnp.parallel.fft import hartley_x_local

    from ekpnp_torch.kernels import fused_step as fs

    jcfg, cfg = _configs("A", nx=nx, ny=15, nz=9)
    rng = np.random.default_rng(40 + nx)
    shape = (9, 15, nx) if lift else (7, 19, nx)
    blocks = [rng.standard_normal(shape), rng.standard_normal((9, nx))]
    before = dict(fs.launches)
    for a in blocks:
        a3 = jnp.asarray(a if a.ndim == 3 else a[:, None])
        want = np.asarray(phi_from_psi_hx(jcfg, a3) if lift
                          else hartley_x_local(a3)).reshape(a.shape)
        got = fs.hartley_rows(torch.as_tensor(a),
                              lift=cfg if lift else None)
        assert got.shape == a.shape and got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                                   atol=1e-12 * np.abs(want).max())
    assert fs.launches == before
    with pytest.raises(ValueError, match="grid"):
        fs.hartley_rows(torch.as_tensor(blocks[0][:, :, 1:]), lift=cfg)


def _jax_collide(jcfg, arrays, phi_hx):
    """The JAX package's jnp collide with the x-transformed RHS: (input of
    the form -- psi_hx for phi_hx, else phi --, {f, h, hn, g, rhs})."""
    from ekpnp.ops.boundary import bounce_back_walls
    from ekpnp.ops.collide import collide
    from ekpnp.ops.poisson import charge_rhs, phi_from_psi_hx, psi_hx_from_phi
    from ekpnp.parallel.fft import hartley_x_local

    st = jax_state(arrays)
    src = psi_hx_from_phi(jcfg, st.phi) if phi_hx else st.phi
    phi = phi_from_psi_hx(jcfg, src) if phi_hx else src
    post, macro = collide(jcfg, st._replace(phi=phi))
    out = dict(f=bounce_back_walls(jcfg, post.f, st.f), h=post.h,
               hn=post.hn, g=post.g,
               rhs=hartley_x_local(charge_rhs(jcfg, macro.charge,
                                              macro.chargen)))
    return np.asarray(src), {k: None if v is None else np.asarray(v)
                             for k, v in out.items()}


def _assert_close(want, got, label):
    for name, a, b in zip(NAMES, want, got):
        if a is None:
            assert b is None, f"{label}{name}: expected absent"
            continue
        np.testing.assert_allclose(to_np(b), a, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{label}{name}")


@pytest.mark.parametrize("mesh", ["one", "slab2"])
@pytest.mark.parametrize("phi_hx", [False, True], ids=["hartley_x", "phi_hx"])
@pytest.mark.parametrize("case", ["A", "C", "J"])
def test_composed_x_hartley_collide_matches_jax(case, phi_hx, mesh):
    """collide(hartley_x) and collide(phi_hx) on CPU tensors -- the plain
    collide, the row product of the RHS and, for phi_hx, the decode of psi
    (and of a shard's two psi halo rows) -- equal the JAX package's jnp
    collide with the RHS times H along x, on one device and on each shard
    of a slab-2 mesh (against the global result's y-slab): rtol 1e-11 /
    atol 1e-13; no launch counted."""
    from ekpnp_torch.kernels import fused_step as fs
    from ekpnp_torch.parallel.halo import phi_halos
    from ekpnp_torch.parallel.mesh import (local_cfg, make_mesh, shard,
                                           shard_state)

    jcfg, cfg = _configs(case)
    arrays = make_state_np(cfg, seed=50)
    src, want = _jax_collide(jcfg, arrays, phi_hx)
    state = port_state(cfg, arrays)._replace(
        phi=torch.as_tensor(src.copy()))
    kw = dict(hartley_x=True, phi_hx=phi_hx)
    before = dict(fs.launches)
    if mesh == "one":
        got = fs.collide(cfg, state.f, state.h, state.hn, state.g, state.phi,
                         **kw)
        _assert_close([want[k] for k in NAMES], got, f"{case} ")
    else:
        m = make_mesh(["cpu"] * 2)
        cfg_l = local_cfg(cfg, m)
        sh = shard_state(cfg, m, state)
        for i, halo in enumerate(phi_halos(m, sh.phi)):
            y0, nyl, _, _ = m.block(cfg, i)
            st = shard(sh, i)
            got = fs.collide(cfg_l, st.f, st.h, st.hn, st.g, st.phi,
                             phi_halo=halo, **kw)
            _assert_close([None if want[k] is None else
                           want[k][..., y0:y0 + nyl, :] for k in NAMES],
                          got, f"{case} shard {i} ")
    assert fs.launches == before
