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


# ---------------------------------------------------------------------------
# the tensor-core form's host logic (hartley_rows_tf32x3_kernel runs only on
# the card; chip_smoke.py holds it to the plain version there)
# ---------------------------------------------------------------------------

def _bits(x):
    return torch.as_tensor(np.asarray(x, dtype=np.uint32).view(np.int32)) \
        .view(torch.float32)


def test_tf32_split_rounds_to_nearest_ties_away():
    """tf32_split: hi keeps 10 mantissa bits (13 low bits clear), rounded
    to nearest with ties away from zero (cvt.rna.tf32.f32) on hand-made
    bit patterns of both signs; lo = x - hi rounded the same way, and
    |x - hi - lo| <= 2^-22 |x| on 10^5 seeded values."""
    from ekpnp_torch.kernels.fused_step import tf32_split

    one = 0x3F800000  # 1.0
    for sign in (0, 0x80000000):
        # low 13 bits: below half, just below, the tie, just above, all
        for low, up in ((0x0001, False), (0x0FFF, False), (0x1000, True),
                        (0x1001, True), (0x1FFF, True)):
            for mant in (0x000000, 0x2000, 0x7FE000):  # 0x7FE000: carries
                x = _bits([sign | one | mant | low])
                hi, _ = tf32_split(x)
                want = sign | ((one | mant) + (0x2000 if up else 0))
                got = int(hi.view(torch.int32).numpy().view(np.uint32)[0])
                assert got == want, (hex(sign), hex(mant), hex(low))
    x = torch.as_tensor(np.random.default_rng(7).standard_normal(100000)
                        * np.exp(np.random.default_rng(8).uniform(-20, 20,
                                                                  100000)),
                        dtype=torch.float32)
    hi, lo = tf32_split(x)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    x64, r = x.double(), (x.double() - hi.double() - lo.double()).abs()
    assert torch.all(r <= 2.0 ** -22 * x64.abs())
    assert torch.all((x64 - hi.double()).abs() <= 2.0 ** -11 * x64.abs())
    with pytest.raises(ValueError, match="float32"):
        tf32_split(x.double())


def _three_term(a, lift=None):
    """The tensor-core form's arithmetic with exact sums: a and H split by
    tf32_split, a_hi H_hi + a_hi H_lo + a_lo H_hi, each product exact in
    f64 (two 11-bit significands) and summed in f64, rounded to f32; the
    lift (the config's profile, f64, cast to f32) added in f32."""
    from ekpnp_torch.kernels.fused_step import tf32_split
    from ekpnp_torch.ops.poisson import lifting_profile
    from ekpnp_torch.parallel.fft import _hartley_matrix

    nx = a.shape[-1]
    hh, hl = (t.double() for t in tf32_split(_hartley_matrix(
        nx, torch.float32, a.device)))
    ah, al = (t.double() for t in tf32_split(a))
    out = (ah @ hh + ah @ hl + al @ hh).float()
    if lift is not None:
        out = out + lifting_profile(lift, torch.float64, a.device).float()
    return out


@pytest.mark.parametrize("lift", [False, True], ids=["plain", "lift"])
@pytest.mark.parametrize("nx", [16, 256, 512])
def test_split_tf32_product_matches_jax(nx, lift):
    """On a few hundred f32 rows (9 x 37 lifted, 7 x 41 plain) the
    three-term split product (`_three_term`) is within 2e-6 of max|ref|
    of JAX's hartley_x_local / phi_from_psi_hx (f64, on the same f32
    values), and no worse than 4x the f32 torch.matmul of the same rows
    and H."""
    import jax.numpy as jnp
    from ekpnp.ops.poisson import phi_from_psi_hx
    from ekpnp.parallel.fft import hartley_x_local

    from ekpnp_torch.ops.poisson import lifting_profile
    from ekpnp_torch.parallel.fft import _hartley_matrix

    jcfg, cfg = _configs("A", nx=nx, ny=37 if lift else 41, nz=9)
    shape = (9, 37, nx) if lift else (7, 41, nx)
    a = torch.as_tensor(np.random.default_rng(60 + nx).standard_normal(shape),
                        dtype=torch.float32)
    a3 = jnp.asarray(a.double().numpy())
    want = np.asarray(phi_from_psi_hx(jcfg, a3) if lift
                      else hartley_x_local(a3))
    got = _three_term(a, cfg if lift else None).double().numpy()
    mm = a @ _hartley_matrix(nx, torch.float32, a.device)
    if lift:
        mm = mm + lifting_profile(cfg, torch.float64, a.device).float()
    scale = np.abs(want).max()
    err = np.abs(got - want).max() / scale
    err_mm = np.abs(mm.double().numpy() - want).max() / scale
    assert err <= 2e-6, err
    assert err <= 4 * err_mm, (err, err_mm)


def test_row_product_dispatch_rule():
    """The tensor-core form where f32, NX % 8 == 0 and every pointer is
    16-byte aligned (NX 16, 192, 256, 512); the FMA form for f64, the odd
    widths (10, 25, 50) and a misaligned block."""
    from ekpnp_torch.kernels.fused_step import hartley_rows_tc

    f32, f64 = torch.float32, torch.float64
    for nx in (16, 192, 256, 512):
        assert hartley_rows_tc(f32, nx, 0, 4096, 16)
        assert not hartley_rows_tc(f64, nx, 0, 4096)
        assert not hartley_rows_tc(f32, nx, 4, 4096)  # one element off
    for nx in (10, 12, 25, 50, 100):
        assert not hartley_rows_tc(f32, nx, 0, 4096)


@pytest.mark.parametrize("m", [135, 259, 8160, 65280, 65792])
def test_row_product_grid_covers_every_output_once(m):
    """hartley_rows_grid's blocks (block b: row tile b // nc, column tile
    b % nc) cover every row and column of the output exactly once, for
    both forms at NX 16, 256 and 512.  The tensor-core form's 128 x 128
    tile gives slab 8's 8160 RHS rows 128 blocks (one wave of the 132
    SMs, a block each) and the full 65280 rows 1020."""
    from ekpnp_torch.kernels.fused_step import hartley_rows_grid

    for tc in (False, True):
        for nx in (16, 256, 512):
            bm, bn, blocks = hartley_rows_grid(m, nx, 4, tc)
            nc = -(-nx // bn)
            rows, cols = np.zeros(m, int), np.zeros(nx, int)
            for b in range(blocks):
                r0, c0 = (b // nc) * bm, (b % nc) * bn
                assert r0 < m and c0 < nx
                if b % nc == 0:
                    rows[r0:r0 + bm] += 1
                if b < nc:
                    cols[c0:c0 + bn] += 1
            assert (rows == 1).all() and (cols == 1).all(), (tc, nx)
            if tc and nx == 256:
                assert (bm, bn) == (128, 128)
                assert blocks == {8160: 128, 65280: 1020}.get(m, blocks)


def test_tensor_core_tile_index_rules():
    """The kernel's index rules, mirrored in numpy (two warpgroups, 256
    threads): every 16-byte piece of a stage's A and B tile (128 rows
    each) lands in its own slot of the 128-byte swizzle (row r, piece c at
    r * 128 + (c ^ r % 8) * 16), the threads' copies cover each piece once;
    each warpgroup's split covers its 64 rows of A once; and the
    epilogue's float4 stores (lanes q, q ^ 1 swapping a row's pair) cover
    the 128 x 128 tile once, 4 consecutive columns of one row a store."""
    threads = 256
    for rows in (128,):
        slots = np.zeros(rows * 128 // 16, int)
        pieces = np.zeros((rows, 8), int)
        for tid in range(threads):
            for j in range(rows * 8 // threads):
                c = tid + j * threads
                r, ch = c // 8, c % 8
                pieces[r, ch] += 1
                slots[(r * 128 + ((ch ^ (r % 8)) << 4)) // 16] += 1
        assert (pieces == 1).all() and (slots == 1).all()
    split = np.zeros(128 * 128 // 16, int)  # float4s of A, both groups
    for t in range(threads):
        wg, wt = t // 128, t % 128
        for j in range(64 * 128 // 16 // 128):
            split[wg * 64 * 128 // 16 + wt + j * 128] += 1
    assert (split == 1).all()
    cells = np.zeros((128, 128), int)
    for t in range(threads):
        wg, wt = t // 128, t % 128
        warp, lane = wt // 32, wt % 32
        g, q = lane // 4, lane % 4
        # the m64nNk8 accumulator: d[4j + 0, 1] at row g, columns
        # 8j + 2q, + 1; d[4j + 2, 3] at row g + 8
        top = q % 2 == 0
        r = wg * 64 + warp * 16 + g + (0 if top else 8)
        for j in range(16):
            col = 8 * j + 2 * (q & 2)
            assert col % 4 == 0
            cells[r, col:col + 4] += 1
            # what the four values are: own pair and the partner's
            own = [8 * j + 2 * q, 8 * j + 2 * q + 1]
            partner = [8 * j + 2 * (q ^ 1), 8 * j + 2 * (q ^ 1) + 1]
            assert sorted(own + partner) == list(range(col, col + 4))
    assert (cells == 1).all()
