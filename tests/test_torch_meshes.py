"""The port's sharded time loop on the wider meshes the JAX package runs, on
the CPU (shards in one process, plain versions of the kernels, f64):
pencil 2x3 with a y cut that x does not divide (a shard's NYl rows go
over its 3 x-shards as 6/5/5, or 2/2/1), pencil 2x4 and slab 8.  On
these a shard's left and right x-neighbours, and its diagonal
neighbours, are different shards, which pencil 2x2 cannot show.

Held to the JAX package (the unsharded solve; its GSPMD oracle on a
(2, 3) mesh) at rtol 1e-11 / atol 1e-13, to the port's one-device step
on the same route at rtol 1e-11, and to the two-launch sharded steps
(`step_halo`) bit for bit."""
import functools

import numpy as np
import pytest
import torch

import test_torch_common  # noqa: F401  (one torch thread per worker)
from test_torch_common import (FIELDS, assert_fields_close, configs,
                               jax_state, make_state_np, port_state, to_np)

# name: (shards, pencil, nx of case C): the y cut is 32 rows over 2 or 8;
# pencil 2x3 puts NYl = 16 over 3 x-shards (6/5/5)
MESHES = {"pencil2x3": (6, True, 24), "pencil2x4": (8, True, 16),
          "slab8": (8, False, 16)}


def port_mesh(name):
    from ekpnp_torch.parallel.mesh import make_mesh

    n, pencil, _ = MESHES[name]
    return make_mesh(["cpu"] * n, pencil=pencil)


def blocks_of(cfg, mesh, a):
    """Per-shard tensors of a global numpy array (..., NY, NX)."""
    def cut(i):
        y0, nyl, x0, nxl = mesh.block(cfg, i)
        return torch.as_tensor(np.ascontiguousarray(
            a[..., y0:y0 + nyl, x0:x0 + nxl]))
    return mesh.each(cut)


def gathered(mesh, state):
    from ekpnp_torch.convert import state_to_numpy
    from ekpnp_torch.parallel.mesh import gather_state

    return state_to_numpy(gather_state(mesh, state))


@pytest.mark.parametrize("fft_method", ["auto", "matmul", "fft"])
def test_uneven_pencil_solve_matches_jax(fft_method):
    """ROADMAP fault 8's witness: `reference` 16x10x9 on pencil 2x2 (NYl 5
    over 2 x-shards, 3/2): the distributed solve, gathered, equals the JAX
    package's unsharded `poisson_phi_from_rhs` at rtol 1e-11 (it raised
    before the way back cut what the way out joined)."""
    import jax.numpy as jnp

    from ekpnp.ops.poisson import poisson_phi_from_rhs as jax_solve
    from ekpnp_torch.ops.poisson import poisson_phi_from_rhs
    from ekpnp_torch.parallel.mesh import gather_field, make_mesh

    jcfg, cfg = configs("A", ny=10, fft_method=fft_method)
    mesh = make_mesh(["cpu"] * 4, pencil=True)
    assert mesh.grid == (2, 2)
    rhs = np.random.default_rng(3).standard_normal((7, 10, 16))
    want = np.asarray(jax_solve(jcfg, jnp.asarray(rhs)))
    got = gather_field(mesh, poisson_phi_from_rhs(
        cfg, blocks_of(cfg, mesh, rhs), mesh)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-11,
                               atol=1e-11 * np.abs(want).max())


def test_uneven_pencil_2x3_matches_jax_gspmd(eight_devices):
    """3 steps of case C at 24x32 on pencil 2x3 (NYl 16 over 3 x-shards)
    equal the JAX package's make_sharded_multi_step on a (2, 3) mesh:
    rtol 1e-11 / atol 1e-13 on f, h, hn, g and phi."""
    from ekpnp.parallel import mesh as jpm
    from ekpnp_torch.parallel.mesh import (make_sharded_multi_step,
                                           shard_state)

    jcfg, cfg = configs("C", nx=24)
    arrays = make_state_np(cfg, seed=51)
    jmesh = jpm.make_mesh(eight_devices[:6], pencil=True)
    assert dict(jmesh.shape) == {"y": 2, "x": 3}
    jout = jpm.make_sharded_multi_step(jcfg, jmesh, 3)(
        jpm.shard_state(jcfg, jmesh, jax_state(arrays)))
    want = {k: None if getattr(jout, k) is None else np.asarray(getattr(jout, k))
            for k in FIELDS}
    mesh = port_mesh("pencil2x3")
    got = gathered(mesh, make_sharded_multi_step(cfg, mesh, 3)(
        shard_state(cfg, mesh, port_state(cfg, arrays))))
    assert_fields_close(want, got, label="pencil2x3 ")


def _neighbours(mesh, i):
    """Shard i's x-lo and x-hi neighbours, and its diagonal neighbours
    (dy, dx) = (-1, -1), (-1, 1), (1, -1), (1, 1)."""
    ny, nx = mesh.grid
    yi, xi = mesh.coords(i)
    at = lambda dy, dx: ((yi + dy) % ny) * nx + (xi + dx) % nx
    return at(0, -1), at(0, 1), [at(dy, dx) for dy in (-1, 1)
                                 for dx in (-1, 1)]


@pytest.mark.parametrize("name", sorted(MESHES))
def test_wider_meshes_match_single_device(name):
    """Case C (two species, D3Q7, zerograd-top: the ions' top plane
    streams along x) at ny=32: a chunk of 3 sharded steps equals 3 steps
    of the port's one-device step on the same route (phi_hx on the slab,
    plain RHS on the pencils) at rtol 1e-11 / atol 1e-13, and 3 two-launch
    sharded steps (`step_halo`) bit for bit.  On the pencils a shard's
    x-lo and x-hi columns come from two different shards, and the corners
    of its rows from its diagonal shards."""
    from ekpnp_torch.kernels.step import multi_step, multi_step_rhs
    from ekpnp_torch.parallel.halo import post_edges, step_halo
    from ekpnp_torch.parallel.mesh import (local_cfg, make_sharded_multi_step,
                                           shard_state)

    _, cfg = configs("C", nx=MESHES[name][2])
    arrays = make_state_np(cfg, seed=52)
    mesh = port_mesh(name)
    single = multi_step_rhs if mesh.pencil else multi_step
    want = {k: to_np(getattr(single(cfg, port_state(cfg, arrays), 3), k))
            for k in FIELDS}
    chunk = gathered(mesh, make_sharded_multi_step(cfg, mesh, 3)(
        shard_state(cfg, mesh, port_state(cfg, arrays))))
    assert_fields_close(want, chunk, label=f"{name} ")

    # step_halo carries real phi: on the slab's phi_hx route the chunk's
    # codec runs once around the steps, as make_halo_multi_step runs it
    from ekpnp_torch.kernels.step import phi_hx_capable
    from ekpnp_torch.ops.poisson import phi_from_psi_hx, psi_hx_from_phi

    hx = not mesh.pencil and phi_hx_capable(local_cfg(cfg, mesh))
    st = shard_state(cfg, mesh, port_state(cfg, arrays))
    if hx:
        st = st._replace(phi=psi_hx_from_phi(cfg, st.phi, mesh))
    for _ in range(3):
        st = step_halo(cfg, mesh, st, phi_hx=hx)
    if hx:
        st = st._replace(phi=phi_from_psi_hx(cfg, st.phi, mesh))
    two = gathered(mesh, st)
    for k in FIELDS:
        if want[k] is not None:
            np.testing.assert_array_equal(chunk[k], two[k], err_msg=k)

    if not mesh.pencil:
        return
    cfg_l = local_cfg(cfg, mesh)
    g = cfg_l.grid
    # every value of shard i's populations is i + 1: what arrives says
    # whence (and a direction that does not travel stays 0)
    lats = (cfg_l.lattice,) + (cfg_l.scalar_lat,) * 3
    posts = mesh.each(lambda i: tuple(
        torch.full((lat.Q, g.nz, g.ny, g.nx), i + 1.0) for lat in lats))
    for i, (rows, cols) in enumerate(post_edges(cfg_l, mesh, posts)):
        lo, hi, diag = _neighbours(mesh, i)
        assert lo != hi and diag[0] != diag[1]
        xlo, xhi = cols[0]
        assert torch.all(xlo == lo + 1) and torch.all(xhi == hi + 1)
        # the rows come from the y-neighbours, widened by the columns
        # they received: their ends are the diagonal shards' corners
        ylo, yhi = rows[0]
        for end, d in ((ylo[..., 0], diag[0]), (ylo[..., -1], diag[1]),
                       (yhi[..., 0], diag[2]), (yhi[..., -1], diag[3])):
            assert set(end.unique().tolist()) == {0.0, d + 1.0}


def test_uneven_all_to_all_round_trip():
    """On pencil 2x3 with NYl 16 (6/5/5 over x), each leg of the (y, x)
    stages out and back returns every shard's block with its extents and
    values exactly."""
    from ekpnp_torch.parallel.collectives import all_to_all, even_cut

    mesh = port_mesh("pencil2x3")
    rng = np.random.default_rng(4)
    blocks = mesh.each(lambda i: torch.as_tensor(
        rng.standard_normal((3, 16, 8))))
    ys = even_cut(16, 3)
    assert ys == [6, 5, 5]
    rows, cols = ys * 2, even_cut(24, 6)
    a = all_to_all(mesh, blocks, "x", 1, 2)
    assert [tuple(b.shape) for b in a] == [(3, y, 24) for y in ys] * 2
    b = all_to_all(mesh, a, ("y", "x"), 2, 1, cat_sizes=rows)
    assert [tuple(t.shape) for t in b] == [(3, 32, c) for c in cols]
    back = all_to_all(mesh, b, ("y", "x"), 1, 2, rows, cols)
    for x, y in zip(back, a):
        assert torch.equal(x, y)
    home = all_to_all(mesh, back, "x", 2, 1, cat_sizes=ys)
    for x, y in zip(home, blocks):
        assert torch.equal(x, y)


# ROADMAP fault 10's witnesses: grids whose solve cuts an empty piece.
# name: (case A overrides, shards, pencil).  `reference` 10x4x9 on pencil
# 2x5 cuts a shard's NYl = 2 rows over 5 x-shards (1/1/0/0/0); 4x8x9 on
# slab 8 cuts NX = 4 over 8 shards (1/1/1/1/0/0/0/0).
EMPTY_PIECES = {"pencil2x5": (dict(nx=10, ny=4), 10, True),
                "slab8": (dict(nx=4, ny=8), 8, False)}


def _empty_piece_case(name, fft_method):
    from ekpnp_torch.parallel.mesh import make_mesh

    grid, n, pencil = EMPTY_PIECES[name]
    jcfg, cfg = configs("A", fft_method=fft_method, nz=9, **grid)
    return jcfg, cfg, make_mesh(["cpu"] * n, pencil=pencil)


@pytest.mark.parametrize("fft_method", ["fft", "matmul", "auto"])
@pytest.mark.parametrize("name", sorted(EMPTY_PIECES))
def test_empty_piece_solve_matches_jax(name, fft_method):
    """The distributed solve on a mesh whose all-to-all cuts an empty
    piece, gathered, equals the JAX package's unsharded
    `poisson_phi_from_rhs` at rtol 1e-11 (the fft route raised in
    torch.fft on the empty block)."""
    import jax.numpy as jnp

    from ekpnp.ops.poisson import poisson_phi_from_rhs as jax_solve
    from ekpnp_torch.ops.poisson import poisson_phi_from_rhs
    from ekpnp_torch.parallel.mesh import gather_field

    jcfg, cfg, mesh = _empty_piece_case(name, fft_method)
    g = cfg.grid
    rhs = np.random.default_rng(5).standard_normal((g.nz - 2, g.ny, g.nx))
    want = np.asarray(jax_solve(jcfg, jnp.asarray(rhs)))
    got = gather_field(mesh, poisson_phi_from_rhs(
        cfg, blocks_of(cfg, mesh, rhs), mesh)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-11,
                               atol=1e-11 * np.abs(want).max())


@functools.lru_cache(maxsize=None)
def _jax_two_steps(name):
    """2 steps of the JAX package's unsharded `multi_step` on the grid of
    `name`, its fft route, from the seeded state (one run a grid: the
    solve routes agree to roundoff, and each JAX run compiles for ~3 s)."""
    import ekpnp.step as jstep

    jcfg, cfg, _ = _empty_piece_case(name, "fft")
    jout = jstep.multi_step(jcfg, jax_state(make_state_np(cfg, seed=53)), 2)
    return {k: None if getattr(jout, k) is None else np.asarray(getattr(jout, k))
            for k in FIELDS}


@pytest.mark.parametrize("fft_method", ["fft", "matmul", "auto"])
@pytest.mark.parametrize("name", sorted(EMPTY_PIECES))
def test_empty_piece_steps_match_jax(name, fft_method):
    """2 steps of `make_halo_multi_step` on the same meshes, on each solve
    route, equal 2 steps of the JAX package's unsharded `multi_step` at
    rtol 1e-11."""
    from ekpnp_torch.parallel.halo import make_halo_multi_step
    from ekpnp_torch.parallel.mesh import shard_state

    _, cfg, mesh = _empty_piece_case(name, fft_method)
    want = _jax_two_steps(name)
    got = gathered(mesh, make_halo_multi_step(cfg, mesh, 2)(
        shard_state(cfg, mesh, port_state(cfg, make_state_np(cfg, seed=53)))))
    assert_fields_close(want, got, rtol=1e-11, label=f"{name} {fft_method} ")
