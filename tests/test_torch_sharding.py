"""The port's sharded time loop on the CPU (`ekpnp_torch.parallel`), shards
in one process: the collectives against the JAX package's permutations,
the distributed transforms against `ekpnp.parallel.fft` on the same mesh
shapes, the sharded step against JAX's `make_sharded_multi_step` (its
GSPMD oracle on the CPU, f64, fft_method "matmul") and against the port's
own single-device step.  The halo / shard_x kernel forms run here through
their plain versions; chip_smoke.py holds the CUDA kernels to them."""
import numpy as np
import pytest
import torch

import test_torch_common  # noqa: F401  (one torch thread per worker)
from test_torch_common import (CASES, assert_fields_close, jax_state,
                               make_state_np, port_state, to_np)

MESHES = {"slab4": (4, False), "pencil2x2": (4, True)}


def configs(case, fft_method="matmul", **grid):
    """(JAX config, port config) of one case, f64, with `grid` overrides."""
    import ekpnp
    import ekpnp_torch

    name, ov = CASES[case]
    ov = dict(ov, **grid, fft_method=fft_method, dtype="float64")
    return ekpnp.preset(name, **ov), ekpnp_torch.preset(name, **ov)


def port_mesh(name):
    from ekpnp_torch.parallel.mesh import make_mesh

    n, pencil = MESHES[name]
    return make_mesh(["cpu"] * n, pencil=pencil)


def jax_mesh(devices, name):
    from ekpnp.parallel.mesh import make_mesh

    n, pencil = MESHES[name]
    return make_mesh(devices[:n], pencil=pencil)


def jax_blocks(arr, jmesh):
    """The per-device blocks of a sharded JAX array, in mesh order."""
    by_dev = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
    return [by_dev[d] for d in jmesh.devices.flat]


def shard_np(mesh, a):
    """Per-shard CPU tensors of a global numpy array (..., NY, NX)."""
    ny, nx = mesh.grid
    rows = np.split(a, ny, axis=-2)
    return [torch.as_tensor(np.ascontiguousarray(b))
            for r in rows for b in np.split(r, nx, axis=-1)]


def put(jmesh, a, spec):
    import jax
    from jax.sharding import NamedSharding

    return jax.device_put(a, NamedSharding(jmesh, spec))


def test_kernel_edge_slots_are_the_exchanged_rows():
    """The stream kernel's edge_slot table (csrc/fused_step.cu) gives each
    direction its row in the exchanged post rows: its place in
    `edge_dirs(lat, ey)`, on every lattice (D3Q19 and D3Q7 are prefixes of
    D3Q27)."""
    import re

    from ekpnp_torch.kernels import fused_step as fs
    from ekpnp_torch.lattice import get_lattice

    with open(fs.SOURCE) as fh:
        src = fh.read()
    body = re.search(r"int edge_slot\(int d\) \{.*?\{(.*?)\};", src,
                     re.S).group(1)
    tab = [int(v) for v in body.replace("\n", " ").split(",")]
    assert len(tab) == 27
    for name in ("D3Q27", "D3Q19", "D3Q7"):
        lat = get_lattice(name)
        for ey in (1, -1):
            dirs = fs.edge_dirs(lat, ey)
            assert len(dirs) == {27: 9, 19: 5, 7: 1}[lat.Q]
            assert [tab[d] for d in dirs] == list(range(len(dirs)))


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(MESHES))
def test_ring_shift_is_jax_ppermute(eight_devices, name):
    """ring_shift(+1 / -1) along each mesh axis moves every block where
    ppermute with the JAX package's perm_fwd / perm_bwd (halo.py:180-184)
    moves it."""
    import jax
    from jax.sharding import PartitionSpec as P

    from ekpnp_torch.parallel.collectives import ring_shift

    mesh, jmesh = port_mesh(name), jax_mesh(eight_devices, name)
    a = np.arange(3 * 8 * 8, dtype=np.float64).reshape(3, 8, 8)
    spec = P(None, "y", "x") if mesh.pencil else P(None, "y", None)
    for axis in mesh.axis_names:
        n = mesh.shape[axis]
        for shift, perm in ((1, [(i, (i + 1) % n) for i in range(n)]),
                            (-1, [(i, (i - 1) % n) for i in range(n)])):
            fn = jax.shard_map(lambda b: jax.lax.ppermute(b, axis, perm),
                               mesh=jmesh, in_specs=spec, out_specs=spec,
                               check_vma=False)
            want = jax_blocks(jax.jit(fn)(put(jmesh, a, spec)), jmesh)
            got = ring_shift(mesh, shard_np(mesh, a), axis, shift)
            for w, g in zip(want, got):
                np.testing.assert_array_equal(g.numpy(), w)


def test_all_to_all_is_the_jax_repartition(eight_devices):
    """all_to_all gives the blocks XLA's repartition gives between the
    layouts the distributed transforms use (fft.py:198-210)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ekpnp_torch.parallel.collectives import all_to_all

    a = np.random.default_rng(0).standard_normal((4, 16, 16))
    steps = {
        "slab4": [(P(None, "y", None), "y", 2, 1, P(None, None, "y"))],
        "pencil2x2": [
            (P(None, "y", "x"), "x", 1, 2, P(None, ("y", "x"), None)),
            (P(None, ("y", "x"), None), ("y", "x"), 2, 1,
             P(None, None, ("y", "x"))),
            (P(None, "y", "x"), "x", 0, 2, P("x", "y", None)),
            (P("x", "y", None), "y", 2, 1, P("x", None, "y")),
        ],
    }
    for name, seq in steps.items():
        mesh, jmesh = port_mesh(name), jax_mesh(eight_devices, name)
        for src, axis, split, cat, dst in seq:
            arr = put(jmesh, a, src)
            blocks = [torch.tensor(b) for b in jax_blocks(arr, jmesh)]
            moved = jax.jit(lambda b: jax.lax.with_sharding_constraint(
                b, NamedSharding(jmesh, dst)))(arr)
            got = all_to_all(mesh, blocks, axis, split, cat)
            for w, g in zip(jax_blocks(moved, jmesh), got):
                np.testing.assert_array_equal(g.numpy(), w)


# ---------------------------------------------------------------------------
# the distributed transforms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(MESHES))
def test_mesh_transforms_match_jax(eight_devices, name):
    """hartley2_xy, hartley_y, fft2_xy (both ways) and fft3 on slab 4 and
    pencil 2x2 equal `ekpnp.parallel.fft` on the same mesh shape: rtol
    1e-12, with atol 1e-12 of the field's maximum (the DFT-as-matmul and
    the FFT round near zero differently)."""
    import jax
    from jax.sharding import PartitionSpec as P

    import ekpnp.parallel.fft as jfft
    import ekpnp_torch.parallel.fft as tfft
    from ekpnp_torch.parallel.mesh import gather_field

    mesh, jmesh = port_mesh(name), jax_mesh(eight_devices, name)
    spec = P(None, "y", "x") if mesh.pencil else P(None, "y", None)
    rng = np.random.default_rng(1)
    a = rng.standard_normal((7, 16, 16))
    ext = rng.standard_normal((16, 16, 16))
    cases = [
        (tfft.hartley2_xy, jfft.hartley2_xy, {}, a),
        (tfft.hartley_y, jfft.hartley_y, {}, a),
        (tfft.fft2_xy, jfft.fft2_xy, {}, a),
        (tfft.fft2_xy, jfft.fft2_xy, dict(inverse=True), a),
        (tfft.fft3, jfft.fft3, {}, ext),
    ]
    for tfn, jfn, kw, x in cases:
        want = np.asarray(jax.jit(lambda b: jfn(b, jmesh, **kw))(
            put(jmesh, x, spec)))
        got = gather_field(mesh, tfn(shard_np(mesh, x), mesh, **kw)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-12,
                                   atol=1e-12 * np.abs(want).max(),
                                   err_msg=f"{tfn.__name__} {kw}")


def test_uneven_repartition_matches_single_device():
    """The reference's 50-wide x over 4 slabs: the all-to-all cuts x
    unevenly, as XLA pads it, and the distributed Hartley transform
    equals the single-device one."""
    import ekpnp_torch.parallel.fft as tfft
    from ekpnp_torch.parallel.mesh import gather_field

    mesh = port_mesh("slab4")
    a = np.random.default_rng(2).standard_normal((5, 8, 50))
    got = gather_field(mesh, tfft.hartley2_xy(shard_np(mesh, a), mesh))
    want = tfft.hartley2_xy(torch.as_tensor(a))
    assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())


# ---------------------------------------------------------------------------
# the sharded step
# ---------------------------------------------------------------------------

def _gathered(mesh, state):
    from ekpnp_torch.convert import state_to_numpy
    from ekpnp_torch.parallel.mesh import gather_state

    return state_to_numpy(gather_state(mesh, state))


def _port_sharded(cfg, arrays, mesh, n, **kw):
    from ekpnp_torch.parallel.mesh import make_sharded_multi_step, shard_state

    state = shard_state(cfg, mesh, port_state(cfg, arrays))
    return make_sharded_multi_step(cfg, mesh, n, **kw)(state)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_sharded_multi_step_matches_jax_gspmd(eight_devices, name):
    """3 sharded steps (slab 4: the phi_hx route per shard; pencil 2x2:
    the plain-RHS shard_x route) equal the JAX package's
    make_sharded_multi_step on the same mesh shape (its GSPMD oracle on
    the CPU): rtol 1e-11 / atol 1e-13 on f, h, hn, g and phi."""
    from ekpnp.parallel import mesh as jpm

    jcfg, cfg = configs("A", ny=16)
    arrays = make_state_np(cfg, seed=31)
    jmesh = jax_mesh(eight_devices, name)
    jout = jpm.make_sharded_multi_step(jcfg, jmesh, 3)(
        jpm.shard_state(jcfg, jmesh, jax_state(arrays)))
    want = {k: None if getattr(jout, k) is None else np.asarray(getattr(jout, k))
            for k in ("f", "h", "hn", "g", "phi")}
    got = _gathered(port_mesh(name), _port_sharded(cfg, arrays,
                                                   port_mesh(name), 3))
    assert_fields_close(want, got, label=f"{name} ")


@pytest.mark.parametrize("case", ["I", "C", "G"])
@pytest.mark.parametrize("name", sorted(MESHES))
def test_sharded_cases_match_single_device(case, name):
    """Injection (I), D3Q7 with zerograd-top (C) and a single species (G):
    3 sharded steps equal 3 steps of the port's single-device step on the
    same route (phi_hx chunk on the slab, plain RHS on the pencil), rtol
    1e-11 / atol 1e-13."""
    from ekpnp_torch.kernels.step import multi_step, multi_step_rhs

    # y extents of 16 or more: 4-row shards on the pencil's 2 x 2
    _, cfg = configs(case, ny=max(16, CASES[case][1]["ny"]))
    arrays = make_state_np(cfg, seed=32)
    mesh = port_mesh(name)
    single = multi_step_rhs if mesh.pencil else multi_step
    want = {k: to_np(getattr(single(cfg, port_state(cfg, arrays), 3), k))
            for k in ("f", "h", "hn", "g", "phi")}
    got = _gathered(mesh, _port_sharded(cfg, arrays, mesh, 3))
    assert_fields_close(want, got, label=f"{case} {name} ")


def test_psi_hx_chunk_on_a_slab_matches_multi_step_hx():
    """The slab chunk carries psi_hx per shard (encode once, decode once):
    equal to kernels.step.multi_step_hx, rtol 1e-11 / atol 1e-13, and the
    hartley_x route (phi_hx=False) equal to multi_step_rhs."""
    from ekpnp_torch.kernels.step import multi_step_hx, multi_step_rhs

    _, cfg = configs("B")
    arrays = make_state_np(cfg, seed=33)
    mesh = port_mesh("slab4")
    for kw, single in ((dict(), multi_step_hx),
                       (dict(phi_hx=False), multi_step_rhs)):
        from ekpnp_torch.parallel.halo import make_halo_multi_step
        from ekpnp_torch.parallel.mesh import shard_state

        want = {k: to_np(getattr(single(cfg, port_state(cfg, arrays), 4), k))
                for k in ("f", "h", "hn", "g", "phi")}
        out = make_halo_multi_step(cfg, mesh, 4, **kw)(
            shard_state(cfg, mesh, port_state(cfg, arrays)))
        assert_fields_close(want, _gathered(mesh, out), label=f"{kw} ")


@pytest.mark.parametrize("name", sorted(MESHES))
def test_overlapped_chunk_bit_exact_vs_serial(name):
    """The post-row exchange overlapped with the solve gives the serial
    chunk's state bit for bit."""
    _, cfg = configs("A", ny=16)
    arrays = make_state_np(cfg, seed=34)
    mesh = port_mesh(name)
    a = _gathered(mesh, _port_sharded(cfg, arrays, mesh, 3, overlap=True))
    b = _gathered(mesh, _port_sharded(cfg, arrays, mesh, 3, overlap=False))
    for k in ("f", "h", "hn", "g", "phi"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_sharded_first_step_matches_the_plain_step():
    """make_sharded_step (the plain per-shard step, with the perturbation
    seeded at global coordinates and the plain step's solve, distributed)
    equals the port's single-device plain step, slab and pencil."""
    from ekpnp_torch.parallel.mesh import make_sharded_step, shard_state
    from ekpnp_torch.step import step

    _, cfg = configs("A", fft_method="auto", ny=16)
    arrays = make_state_np(cfg, seed=35)
    want, _ = step(cfg, port_state(cfg, arrays), perturb=True)
    want = {k: to_np(getattr(want, k)) for k in ("f", "h", "hn", "g", "phi")}
    for name in sorted(MESHES):
        mesh = port_mesh(name)
        out, macro = make_sharded_step(cfg, mesh, perturb=True)(
            shard_state(cfg, mesh, port_state(cfg, arrays)))
        assert len(macro.rho) == mesh.size
        assert_fields_close(want, _gathered(mesh, out), label=f"{name} ")


def test_shard_gather_round_trip_is_exact():
    from ekpnp_torch.parallel.mesh import gather_state, shard_state

    _, cfg = configs("C")
    st = port_state(cfg, make_state_np(cfg, seed=36))
    for name in sorted(MESHES):
        mesh = port_mesh(name)
        sh = shard_state(cfg, mesh, st)
        assert len(sh.f) == mesh.size
        assert tuple(sh.f[0].shape) == (27, 9, 32 // mesh.grid[0],
                                        16 // mesh.grid[1])
        back = gather_state(mesh, sh)
        for a, b in zip(back, st):
            assert (a is None and b is None) or torch.equal(a, b)


def test_indivisible_meshes_raise():
    from ekpnp_torch.parallel.fft import fft3
    from ekpnp_torch.parallel.mesh import (make_mesh,
                                           make_sharded_multi_step,
                                           shard_state)

    _, cfg = configs("A")
    _, cfg12 = configs("A", ny=12)
    with pytest.raises(ValueError, match="ny=12 not divisible by mesh "
                                         "y-extent 8"):
        make_sharded_multi_step(cfg12, make_mesh(["cpu"] * 8), 1)
    with pytest.raises(ValueError, match="nx=16 not divisible by mesh "
                                         "x-extent 3"):
        shard_state(cfg, make_mesh(["cpu"] * 6, pencil=True),
                    port_state(cfg, make_state_np(cfg)))
    mesh = make_mesh(["cpu"] * 3)
    with pytest.raises(ValueError, match="extended z extent 16 must divide "
                                         "mesh 'y' size 3"):
        fft3([torch.zeros(16, 8, 8)] * 3, mesh)


def test_sharded_series_point_matches_gathered():
    """The diagnostics of a sharded state: maxima exactly those of the
    gathered state, the current and mean T to 1e-13 (summation order)."""
    from ekpnp_torch.diagnostics import check_finite, series_point
    from ekpnp_torch.parallel.mesh import gather_state, shard_state

    _, cfg = configs("I", ny=16)
    st = port_state(cfg, make_state_np(cfg, seed=37))
    want = [float(x) for x in series_point(cfg, st)]
    for name in sorted(MESHES):
        mesh = port_mesh(name)
        sh = shard_state(cfg, mesh, st)
        got = [float(x) for x in series_point(cfg, sh, mesh)]
        assert got[0] == want[0] and got[1] == want[1] and got[4] == want[4]
        np.testing.assert_allclose(got[2:4], want[2:4], rtol=1e-13)
        assert check_finite(sh)
        sh.f[1][0, 0, 0, 0] = float("nan")
        assert not check_finite(sh)
        assert not bool(series_point(cfg, sh, mesh)[4])
        assert check_finite(gather_state(mesh, shard_state(cfg, mesh, st)))


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_mesh_run_and_merge(tmp_path, capsys):
    """`run reference --device cpu --mesh slab --mesh-devices 4` writes
    per-shard dumps and no data.dat; `merge` then writes a data.dat (and
    data_end.dat) byte-identical to what the JAX package's merge_run_dir
    writes from the same dumps, and a data_end.npz equal to the unsharded
    run's: measured 1.7e-15 of each field group's maximum (the sharded
    run's first step solves by the odd-extension FFT, the unsharded one's
    by the Hartley route), held at 1e-9, the golden tolerance."""
    from ekpnp import preset
    from ekpnp.io.fields import merge_run_dir
    from ekpnp_torch.run import main

    common = ["--steps", "6", "--device", "cpu", "--precision", "f64",
              "--set", "nsave=3", "print_current=3", "pb_iters=100"]
    shards, plain = tmp_path / "mesh", tmp_path / "plain"
    assert main(["run", "reference", *common, "--outdir", str(shards),
                 "--mesh", "slab", "--mesh-devices", "4"]) == 0
    out = capsys.readouterr().out
    assert "Iteration: 6" in out and "mesh: {'y': 4}" in out
    assert not (shards / "data.dat").exists()
    dumps = sorted(p.name for p in shards.glob("fields_*.shards"))
    assert dumps == ["fields_000000.shards", "fields_000003.shards",
                     "fields_000006.shards"]
    assert main(["merge", "reference", str(shards)]) == 0
    assert "merged 3 zones" in capsys.readouterr().out
    jcfg = preset("reference", dtype="float64")
    assert merge_run_dir(str(shards), jcfg,
                         data_path=str(tmp_path / "jax_data.dat"),
                         end_path=str(tmp_path / "jax_end.dat"),
                         end_npz_path=str(tmp_path / "jax_end.npz")) == 3
    assert (tmp_path / "jax_data.dat").read_bytes() == \
        (shards / "data.dat").read_bytes()
    assert (tmp_path / "jax_end.dat").read_bytes() == \
        (shards / "data_end.dat").read_bytes()

    assert main(["run", "reference", *common, "--outdir", str(plain)]) == 0
    a, b = np.load(shards / "data_end.npz"), np.load(plain / "data_end.npz")
    groups = {"u": ("ux", "uy", "uz"), "E": ("Ex", "Ey", "Ez")}
    for key in b.files:
        group = next((g for g in groups.values() if key in g), (key,))
        scale = max(np.abs(b[k]).max() for k in group)
        np.testing.assert_allclose(a[key], b[key], rtol=0,
                                   atol=1e-9 * max(scale, 1e-300),
                                   err_msg=key)
