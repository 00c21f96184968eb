"""The port's I/O against the JAX package's, on the CPU (f64): the native
formatters (csrc/ekio.cpp) byte for byte against their plain Python
versions and against `ekpnp.io.native`; every checkpoint kind read across
the packages in both directions, exactly; the lossless resume; the
mesh-elastic sharded restore; VTK and scalar files byte for byte."""
import os

import numpy as np
import pytest
import torch

import test_torch_common  # noqa: F401  (one torch thread per worker)
from test_torch_common import FIELDS, jax_state, make_state_np, port_state, to_np

SHAPE = (51, 8, 50)  # the reference grid (Z, Y, X)


# printf corner cases: "%g" columns take any double; the "%10.6f" ones
# stay within what the JAX package's library formats (|v| < 1e24)
G_CORNER = [0.0, -0.0, 1e-18, -1e-18, 1e-300, 1e300, -2.5e+123, 123456789.0,
            0.5, 1e16, 5e-5, -999999.5]
F_CORNER = [0.0, -0.0, 1e-18, -1e-18, 0.5, -5e-7, 999999.5, 1e16, -1e20,
            5e-7, 0.0000125, -0.0000005]


def _columns(ncols, seed=0, g_cols=8, f_corner=F_CORNER):
    """ncols seeded columns over 50x8x51 rows at scales 1e-8..1e8, with the
    corner cases in the first rows: the first `g_cols` columns are "%g"."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(SHAPE))
    cols = []
    for j in range(ncols):
        c = rng.standard_normal(n) * 10.0 ** rng.integers(-8, 8, size=n)
        corner = G_CORNER if j < g_cols else f_corner
        c[:len(corner)] = corner
        cols.append(c)
    return cols


@pytest.mark.parametrize("kind", ["tecplot", "table"])
def test_native_format_equals_plain_and_jax(kind):
    from ekpnp.io import native as jnative

    from ekpnp_torch.io import native

    cols = (_columns(14) if kind == "tecplot" else _columns(12, g_cols=0))
    got = getattr(native, f"format_{kind}")(cols)
    assert got == getattr(native, f"format_{kind}_plain")(cols)
    assert got == getattr(jnative, f"format_{kind}")(cols)
    assert got.count("\n") == cols[0].size and got.endswith("\n")


@pytest.mark.parametrize("kind", ["tecplot", "table"])
def test_native_format_takes_wide_fixed_values(kind):
    """"%10.6f" of 1e300 is 308 characters: the port's library formats it
    as printf does (the JAX package's overruns its row estimate there)."""
    from ekpnp_torch.io import native

    wide = [1e300, -1.7e308, 2.5e200, 1e24, -1e23]
    cols = (_columns(14, f_corner=wide) if kind == "tecplot"
            else _columns(12, g_cols=0, f_corner=wide))
    got = getattr(native, f"format_{kind}")(cols)
    assert got == getattr(native, f"format_{kind}_plain")(cols)
    assert len(got.splitlines()[1]) > 300


def test_parse_table_equals_jax_and_checks_the_count():
    from ekpnp.io import native as jnative

    from ekpnp_torch.io import native

    cols = _columns(12, seed=1)
    text = native.format_table(cols)
    n = cols[0].size
    got = native.parse_table(text, n, 12)
    np.testing.assert_array_equal(got, jnative.parse_table(text, n, 12))
    np.testing.assert_array_equal(got, np.loadtxt(text.splitlines()))
    for rows in (n - 1, n + 1):  # a table too long, and too short
        with pytest.raises(ValueError, match="expected"):
            native.parse_table(text, rows, 12)


def test_native_build_is_keyed_by_the_source(tmp_path, monkeypatch):
    """The library is built under a key of the source, and a failed build
    raises with g++'s output."""
    from ekpnp_torch.io import native

    assert os.path.basename(native.library_path()).startswith("ekio_")
    assert os.path.exists(native.build())
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()
    assert os.listdir(tmp_path / "build") == []  # no temporary left behind


def _reference_fields():
    """(JAX cfg, port cfg, JAX macro, phi, E) of a seeded reference state."""
    import ekpnp
    from ekpnp.ops.collide import compute_macro
    from ekpnp.ops.poisson import efield

    import ekpnp_torch

    cj = ekpnp.preset("reference", dtype="float64")
    ct = ekpnp_torch.preset("reference", dtype="float64")
    st = jax_state(make_state_np(cj, seed=4))
    macro, _ = compute_macro(cj, st)
    return cj, ct, macro, st.phi, efield(cj, st.phi)


def _port_macro(macro):
    from ekpnp_torch.state import Macro

    return Macro(*(None if a is None else torch.as_tensor(np.array(a))
                   for a in macro))


def test_write_zone_equals_jax(tmp_path):
    import io

    from ekpnp.io.tecplot import write_zone as jwrite

    from ekpnp_torch.io.tecplot import write_zone

    cj, ct, macro, phi, E = _reference_fields()
    pm, pphi, pE = (_port_macro(macro), torch.as_tensor(np.array(phi)),
                    torch.as_tensor(np.array(E)))
    a, b = io.StringIO(), io.StringIO()
    jwrite(a, cj, macro, phi, E, 1.5e-9, first=True)
    write_zone(b, ct, pm, pphi, pE, 1.5e-9, first=True)
    assert a.getvalue() == b.getvalue()
    # a file: the body goes from the C buffer into the file's own buffer
    path = tmp_path / "data.dat"
    with open(path, "w") as fout:
        write_zone(fout, ct, pm, pphi, pE, 1.5e-9, first=True)
        write_zone(fout, ct, pm, pphi, pE, 2.5e-9)
    c = io.StringIO()
    jwrite(c, cj, macro, phi, E, 2.5e-9)
    assert path.read_text() == a.getvalue() + c.getvalue()


def test_vtk_and_scalars_equal_jax(tmp_path):
    from ekpnp.io.scalars import save_scalars as jscalars
    from ekpnp.io.vtk import write_vtk as jvtk

    from ekpnp_torch.io.scalars import save_scalars
    from ekpnp_torch.io.vtk import read_vtk, write_vtk

    cj, ct, macro, phi, E = _reference_fields()
    pm, pphi, pE = (_port_macro(macro), torch.as_tensor(np.array(phi)),
                    torch.as_tensor(np.array(E)))
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jvtk(str(tmp_path / "j" / "f.vtk"), cj, macro, phi, E, 2e-9)
    write_vtk(str(tmp_path / "t" / "f.vtk"), ct, pm, pphi, pE, 2e-9)
    jscalars(str(tmp_path / "j"), 7, cj, macro, phi, E)
    save_scalars(str(tmp_path / "t"), 7, ct, pm, pphi, pE)
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t")) and len(names) == 12
    for name in names:
        assert (tmp_path / "j" / name).read_bytes() == \
            (tmp_path / "t" / name).read_bytes(), name
    back = read_vtk(str(tmp_path / "t" / "f.vtk"))
    np.testing.assert_array_equal(back["phi"], np.asarray(phi).ravel())


def _assert_states_equal(a, b, label):
    """a: JAX or numpy-valued state, b: port state; exact."""
    for name in FIELDS + ("t",):
        x, y = getattr(a, name), getattr(b, name)
        if x is None:
            assert y is None, f"{label}: {name}"
            continue
        np.testing.assert_array_equal(to_np(y), np.asarray(x),
                                      err_msg=f"{label}: {name}")


@pytest.mark.parametrize("kind", ["npz", "ascii", "full"])
def test_checkpoints_load_across_packages(tmp_path, kind):
    """Each package reads the other's checkpoint into the same state as
    its own loader does, exactly (the lossy kinds re-equilibrate by the
    same arithmetic in both packages)."""
    from ekpnp.io import checkpoint as jck

    from ekpnp_torch.io import checkpoint as tck

    cj, ct, macro, phi, E = _reference_fields()
    pm = _port_macro(macro)
    pphi, pE = torch.as_tensor(np.array(phi)), torch.as_tensor(np.array(E))
    jp, tp = str(tmp_path / "jax"), str(tmp_path / "port")
    if kind == "npz":
        jck.save_npz(jp, cj, macro, phi, E, 3e-9)
        tck.save_npz(tp, ct, pm, pphi, pE, 3e-9)
        jload, tload = jck.load_npz, tck.load_npz
    elif kind == "ascii":
        jck.save_reference_ascii(jp, cj, macro, phi, E, 3e-9)
        tck.save_reference_ascii(tp, ct, pm, pphi, pE, 3e-9)
        assert open(jp).read() == open(tp).read()
        jload, tload = jck.load_reference_ascii, tck.load_reference_ascii
    else:
        arrays = make_state_np(cj, seed=5)
        jck.save_full_npz(jp, cj, jax_state(arrays))
        tck.save_full_npz(tp, ct, port_state(ct, arrays))
        jload, tload = jck.load_full_npz, tck.load_full_npz
        assert tck.is_full_checkpoint(jp + ".npz")
        assert jck.is_full_checkpoint(tp + ".npz")
    suffix = "" if kind == "ascii" else ".npz"
    jp, tp = jp + suffix, tp + suffix
    want = jload(jp, cj)
    _assert_states_equal(want, tload(jp, ct, device="cpu"), "port reads JAX")
    _assert_states_equal(jload(tp, cj), tload(tp, ct, device="cpu"),
                         "JAX reads port")
    _assert_states_equal(want, tload(tp, ct, device="cpu"), "port reads port")


def test_full_checkpoint_rejects_another_precision(tmp_path):
    import ekpnp_torch
    from ekpnp_torch.io import checkpoint as tck

    c64 = ekpnp_torch.preset("reference", dtype="float64")
    c32 = ekpnp_torch.preset("reference", dtype="float32")
    tck.save_full_npz(str(tmp_path / "s.npz"), c64,
                      port_state(c64, make_state_np(c64, seed=1)))
    with pytest.raises(ValueError, match="matching precision"):
        tck.load_full_npz(str(tmp_path / "s.npz"), c32, device="cpu")


def test_sharded_checkpoint_across_packages_and_meshes(tmp_path, eight_devices):
    """JAX writes on slab 4; the port restores under pencil 2x2 and with
    no mesh.  The port writes on slab 4; JAX restores under pencil 2x2 and
    on one device.  Every restore equals the saved state exactly."""
    import ekpnp
    from ekpnp.io import checkpoint as jck
    from ekpnp.parallel import mesh as jmesh

    import ekpnp_torch
    from ekpnp_torch.io import checkpoint as tck
    from ekpnp_torch.parallel import mesh as tmesh

    cj = ekpnp.preset("reference", dtype="float64")
    ct = ekpnp_torch.preset("reference", dtype="float64")
    arrays = make_state_np(cj, seed=6)
    want = jax_state(arrays)
    slab_j = jmesh.make_mesh(eight_devices[:4])
    jck.save_sharded(str(tmp_path / "jax.ckpt"), cj,
                     jmesh.shard_state(cj, slab_j, want))
    pencil_t = tmesh.make_mesh(["cpu"] * 4, pencil=True)
    got = tck.load_sharded(str(tmp_path / "jax.ckpt"), ct, pencil_t)
    _assert_states_equal(want, tmesh.gather_state(pencil_t, got),
                         "port pencil 2x2 reads JAX slab 4")
    _assert_states_equal(want, tck.load_sharded(str(tmp_path / "jax.ckpt"),
                                                ct, device="cpu"),
                         "port, no mesh, reads JAX slab 4")

    slab_t = tmesh.make_mesh(["cpu"] * 4)
    tck.save_sharded(str(tmp_path / "port.ckpt"), ct,
                     tmesh.shard_state(ct, slab_t, port_state(ct, arrays)),
                     slab_t)
    assert tck.is_sharded_checkpoint(str(tmp_path / "port.ckpt"))
    pencil_j = jmesh.make_mesh(eight_devices[:4], pencil=True)
    one_j = jmesh.make_mesh(eight_devices[:1])
    for label, m in (("pencil 2x2", pencil_j), ("one device", one_j)):
        back = jck.load_sharded(str(tmp_path / "port.ckpt"), cj, m)
        _assert_states_equal(back, port_state(ct, arrays),
                             f"JAX {label} reads port slab 4")
    got = tck.load_sharded(str(tmp_path / "port.ckpt"), ct, pencil_t)
    _assert_states_equal(want, tmesh.gather_state(pencil_t, got),
                         "port pencil 2x2 reads port slab 4")


@pytest.mark.parametrize("fft_method", ["fft", "matmul"])
def test_full_state_resume_continues_the_run(tmp_path, fft_method):
    """run(6) against run(3), save_full_npz, load_full_npz, run(3): bit for
    bit on the plain-RHS route, whose chunks equal their steps exactly;
    rtol 1e-11 on the phi_hx route, whose psi round trip at a chunk
    boundary is not exact (test_torch_fused_pass.py)."""
    import ekpnp_torch
    from ekpnp_torch.io import checkpoint as tck
    from ekpnp_torch.kernels.step import multi_step

    cfg = ekpnp_torch.preset("reference", nx=16, ny=8, nz=9, dtype="float64",
                             fft_method=fft_method)
    arrays = make_state_np(cfg, seed=7)
    whole = multi_step(cfg, port_state(cfg, arrays), 6)
    half = multi_step(cfg, port_state(cfg, arrays), 3)
    tck.save_full_npz(str(tmp_path / "s.npz"), cfg, half)
    resumed = multi_step(cfg, tck.load_full_npz(str(tmp_path / "s.npz"), cfg,
                                                device="cpu"), 3)
    for name in FIELDS + ("t",):
        a, b = to_np(getattr(whole, name)), to_np(getattr(resumed, name))
        if fft_method == "fft" or name == "t":
            np.testing.assert_array_equal(b, a, err_msg=name)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-11, atol=1e-13,
                                       err_msg=name)
