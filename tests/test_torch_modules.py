"""The port's modules against the JAX package's, one by one (CPU, f64).

Same numpy inputs through both; tolerance rtol=1e-11, atol=1e-13 where
the arithmetic is the same up to operation order.
"""
import dataclasses
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ekpnp
import ekpnp_torch
from test_torch_common import (ATOL, RTOL, assert_fields_close, configs,
                               jax_state, make_state_np, port_state, to_np)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRESETS = ("reference", "ethd", "poiseuille", "ek-channel", "ek-pnp",
           "ek-pnp-thermal", "pod")
LATTICES = ("D3Q27", "D3Q19", "D3Q7")


def close(a, b, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(to_np(b) if torch.is_tensor(b) else b,
                               np.asarray(a), rtol=rtol, atol=atol, err_msg=msg)


@pytest.mark.parametrize("name", PRESETS)
def test_copied_preset_equals_jax_preset(name):
    a, b = ekpnp.preset(name), ekpnp_torch.preset(name)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert a.omegas() == b.omegas() and a.cs2_s == b.cs2_s
    ov = dict(compat="reference", nx=12, charge_bc="injection", joule=2.0)
    assert (dataclasses.asdict(ekpnp.preset(name, **ov))
            == dataclasses.asdict(ekpnp_torch.preset(name, **ov)))


def test_copied_config_rejects_what_the_original_rejects():
    for bad in (dict(nope=1), dict(compat="sometimes")):
        with pytest.raises(ValueError):
            ekpnp.preset("reference", **bad)
        with pytest.raises(ValueError):
            ekpnp_torch.preset("reference", **bad)


@pytest.mark.parametrize("name", LATTICES)
def test_copied_lattice_tables_equal(name):
    from ekpnp.lattice import get_lattice as jl
    from ekpnp_torch.lattice import get_lattice as tl

    a, b = jl(name), tl(name)
    assert a.name == b.name and a.Q == b.Q
    for k in ("E", "W", "OPP"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
        assert getattr(a, k).dtype == getattr(b, k).dtype
    assert a.cs2_lat == b.cs2_lat


@pytest.mark.parametrize("name", LATTICES)
def test_feq_moments_trt_split(name):
    from ekpnp.lattice import get_lattice as jl
    from ekpnp.ops import equilibrium as je
    from ekpnp_torch.lattice import get_lattice as tl
    from ekpnp_torch.ops import equilibrium as te

    rng = np.random.default_rng(1)
    m = 1.0 + 0.1 * rng.standard_normal((5, 4, 6))
    v = 1e-2 * rng.standard_normal((3, 5, 4, 6))
    cfl, cs2 = 0.01, 1.0 / 3.0 / 1e-4
    a = je.feq(jl(name), jnp.asarray(m), jnp.asarray(v), cfl, cs2)
    b = te.feq(tl(name), torch.as_tensor(m), torch.as_tensor(v), cfl, cs2)
    close(a, b)
    pops = np.asarray(a) * (1 + 1e-3 * rng.standard_normal(a.shape))
    for x, y in zip(je.moments(jl(name), jnp.asarray(pops), cfl),
                    te.moments(tl(name), torch.as_tensor(pops), cfl)):
        close(x, y, atol=1e-12)
    for x, y in zip(je.trt_split(jl(name), jnp.asarray(pops)),
                    te.trt_split(tl(name), torch.as_tensor(pops))):
        close(x, y)


@pytest.mark.parametrize("case", ["H", "I"])
def test_collide_and_macro(case):
    from ekpnp.ops.collide import collide as jc
    from ekpnp_torch.ops.collide import collide as tc

    jcfg, tcfg = configs(case)
    arrays = make_state_np(jcfg, seed=2)
    post_a, mac_a = jc(jcfg, jax_state(arrays))
    post_b, mac_b = tc(tcfg, port_state(tcfg, arrays))
    assert_fields_close(post_a._asdict(), {k: to_np(v) for k, v in
                                           post_b._asdict().items()},
                        names=("f", "h", "hn", "g"), label="post.")
    for k in ("rho", "u", "charge", "chargen", "temp"):
        a, b = getattr(mac_a, k), getattr(mac_b, k)
        assert (a is None) == (b is None), k
        if a is not None:
            close(a, b, atol=1e-15, msg=k)


@pytest.mark.parametrize("case", ["A", "E", "E-compat"])
def test_bounce_back_walls(case):
    from ekpnp.ops.boundary import bounce_back_walls as jb
    from ekpnp_torch.ops.boundary import bounce_back_walls as tb

    jcfg, tcfg = configs(case)
    pre = make_state_np(jcfg, seed=3)["f"]
    post = make_state_np(jcfg, seed=4)["f"]
    close(jb(jcfg, jnp.asarray(post), jnp.asarray(pre)),
          tb(tcfg, torch.as_tensor(post), torch.as_tensor(pre)))


@pytest.mark.parametrize("name", LATTICES)
def test_stream(name):
    from ekpnp.lattice import get_lattice as jl
    from ekpnp.ops.stream import stream as js
    from ekpnp_torch.lattice import get_lattice as tl
    from ekpnp_torch.ops.stream import stream as ts

    pops = np.random.default_rng(5).standard_normal((jl(name).Q, 5, 4, 6))
    np.testing.assert_array_equal(np.asarray(js(jl(name), jnp.asarray(pops))),
                                  to_np(ts(tl(name), torch.as_tensor(pops))))


@pytest.mark.parametrize("which", ["noflux", "temperature", "injection",
                                   "zerograd-top"])
@pytest.mark.parametrize("scalar_lattice", ["same", "D3Q7"])
def test_scalar_wall_bcs(which, scalar_lattice):
    from ekpnp.ops.boundary import scalar_wall_bcs as jw
    from ekpnp_torch.ops.boundary import scalar_wall_bcs as tw

    ov = dict(nx=6, ny=4, nz=5, scalar_lattice=scalar_lattice)
    jcfg, tcfg = ekpnp.preset("reference", **ov), ekpnp_torch.preset("reference", **ov)
    q = jcfg.scalar_lat.Q
    rng = np.random.default_rng(6)
    streamed, post = (rng.standard_normal((q, 5, 4, 6)) for _ in range(2))
    wall = (0.3, 0.7) if which == "injection" else None
    close(jw(jcfg, jnp.asarray(streamed), jnp.asarray(post), which, wall=wall),
          tw(tcfg, torch.as_tensor(streamed), torch.as_tensor(post), which,
             wall=wall))


@pytest.mark.parametrize("fft_method", ["matmul", "fft"])
def test_poisson_phi_from_rhs_and_efield(fft_method):
    from ekpnp.ops import poisson as jp
    from ekpnp_torch.ops import poisson as tp

    jcfg, tcfg = configs("J", fft_method=fft_method)
    arrays = make_state_np(jcfg, seed=7)
    c = np.asarray(arrays["h"]).sum(0)
    cn = np.asarray(arrays["hn"]).sum(0)
    rhs = np.array(jp.charge_rhs(jcfg, jnp.asarray(c), jnp.asarray(cn)))
    close(rhs, tp.charge_rhs(tcfg, torch.as_tensor(c), torch.as_tensor(cn)),
          atol=1e-2)
    phi_a = jp.poisson_phi_from_rhs(jcfg, jnp.asarray(rhs))
    phi_b = tp.poisson_phi_from_rhs(tcfg, torch.as_tensor(rhs))
    close(phi_a, phi_b)
    # the full solve from the concentrations: "auto" takes the odd-extension
    # FFT on the CPU in both packages
    acfg, bcfg = configs("J", fft_method="auto" if fft_method == "fft" else "matmul")
    close(jp.poisson_phi(acfg, jnp.asarray(c), jnp.asarray(cn)),
          tp.poisson_phi(bcfg, torch.as_tensor(c), torch.as_tensor(cn)))
    close(jp.efield(jcfg, phi_a), tp.efield(tcfg, phi_b), atol=1e-8)


HX_FUNCTIONS = ("hartley_y", "hartley_x_local", "poisson_phi_from_rhs_hx",
                "poisson_psi_hx_from_rhs", "phi_from_psi_hx", "psi_hx_from_phi")


@pytest.mark.parametrize("fn", HX_FUNCTIONS)
@pytest.mark.parametrize("case", ["A", "C"])
def test_x_hartley_route_functions(case, fn):
    """The single transform stages and the solve / codec functions of the
    x-Hartley route against ekpnp.parallel.fft and ekpnp.ops.poisson, on a
    seeded RHS (as tests/test_poisson.py:119-135 builds it) and a seeded
    phi; the solve forms also equal the plain solve, and refuse
    fft_method="fft" as the JAX package's do."""
    from ekpnp.ops import poisson as jp
    from ekpnp.parallel import fft as jf
    from ekpnp_torch.ops import poisson as tp
    from ekpnp_torch.parallel import fft as tf

    jcfg, tcfg = configs(case)
    g = jcfg.grid
    rng = np.random.default_rng(5)
    c, cn = (rng.random(g.shape) for _ in range(2))
    rhs = np.array(jp.charge_rhs(jcfg, jnp.asarray(c), jnp.asarray(cn)))
    rhs_hx = np.array(jf.hartley_x_local(jnp.asarray(rhs)))
    T = torch.as_tensor
    if fn in ("hartley_y", "hartley_x_local"):
        a = rng.standard_normal((g.nz - 2, g.ny, g.nx))
        close(getattr(jf, fn)(jnp.asarray(a)), getattr(tf, fn)(T(a)))
    elif fn == "poisson_phi_from_rhs_hx":
        phi = tp.poisson_phi_from_rhs(tcfg, T(rhs_hx), rhs_hx=True)
        close(jp.poisson_phi_from_rhs(jcfg, jnp.asarray(rhs_hx), rhs_hx=True), phi)
        close(tp.poisson_phi_from_rhs(tcfg, T(rhs)), phi)
        with pytest.raises(ValueError, match="rhs_hx"):
            tp.poisson_phi_from_rhs(configs(case, fft_method="fft")[1],
                                    T(rhs_hx), rhs_hx=True)
    elif fn == "poisson_psi_hx_from_rhs":
        psi = tp.poisson_psi_hx_from_rhs(tcfg, T(rhs_hx))
        close(jp.poisson_psi_hx_from_rhs(jcfg, jnp.asarray(rhs_hx)), psi)
        assert not psi[0].any() and not psi[-1].any()
        close(tp.poisson_phi_from_rhs(tcfg, T(rhs)), tp.phi_from_psi_hx(tcfg, psi))
        with pytest.raises(ValueError, match="psi_hx"):
            tp.poisson_psi_hx_from_rhs(configs(case, fft_method="fft")[1],
                                       T(rhs_hx))
    elif fn == "phi_from_psi_hx":
        psi = 1e-4 * rng.standard_normal(g.shape)
        psi[0] = psi[-1] = 0.0
        close(jp.phi_from_psi_hx(jcfg, jnp.asarray(psi)),
              tp.phi_from_psi_hx(tcfg, T(psi)))
    else:
        phi = jcfg.physics.voltage * (1.0 + 0.05 * rng.standard_normal(g.shape))
        psi = tp.psi_hx_from_phi(tcfg, T(phi))
        close(jp.psi_hx_from_phi(jcfg, jnp.asarray(phi)), psi)
        close(phi, tp.phi_from_psi_hx(tcfg, psi))


def test_pb_init_20_iterations():
    from ekpnp.ops.pbe import pb_init as jpb
    from ekpnp_torch.ops.pbe import pb_init as tpb

    ov = dict(nx=16, ny=8, nz=9, pb_iters=20, dtype="float64")
    jcfg, tcfg = ekpnp.preset("reference", **ov), ekpnp_torch.preset("reference", **ov)
    phi0 = np.full(jcfg.grid.shape, jcfg.physics.voltage)
    a = jpb(jcfg, jnp.asarray(phi0), with_residual=True)
    b = tpb(tcfg, torch.as_tensor(phi0), with_residual=True)
    for name, x, y in zip(("phi", "charge", "chargen", "E"), a[:4], b[:4]):
        close(x, y, atol=1e-8 if name == "E" else ATOL, msg=name)
    np.testing.assert_allclose(float(b[4]), float(a[4]), rtol=1e-6)


def test_state_crosses_through_numpy_unchanged():
    from ekpnp_torch.convert import state_from_numpy, state_to_numpy

    _, tcfg = configs("G")
    arrays = make_state_np(tcfg, seed=8)
    back = state_to_numpy(state_from_numpy(tcfg, arrays, device="cpu"))
    for k in ("f", "h", "hn", "g", "phi", "t"):
        if arrays[k] is None:
            assert back[k] is None
        else:
            np.testing.assert_array_equal(back[k], arrays[k])
    with pytest.raises(ValueError):
        state_from_numpy(tcfg, dict(arrays, g=arrays["f"]), device="cpu")
    from ekpnp.state import zeros_state as jz
    from ekpnp_torch.state import zeros_state as tz

    a, b = jz(configs("G")[0]), tz(tcfg, device="cpu")
    for k in ("f", "h", "hn", "g", "phi", "t"):
        x, y = getattr(a, k), getattr(b, k)
        assert (x is None) == (y is None), k
        if x is not None:
            assert tuple(x.shape) == tuple(y.shape) and not y.any(), k


def test_entry_points_raise_without_a_card():
    from ekpnp_torch.device import resolve_device
    from ekpnp_torch.init import initialize

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = ekpnp_torch.preset("reference", nx=6, ny=4, nz=5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        initialize(cfg)


def test_port_imports_neither_jax_nor_ekpnp():
    code = (
        "import sys, pkgutil, importlib, ekpnp_torch\n"
        "for m in pkgutil.walk_packages(ekpnp_torch.__path__, 'ekpnp_torch.'):\n"
        "    if m.name != 'ekpnp_torch.__main__':\n"
        "        importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
        " or k == 'ekpnp' or k.startswith('ekpnp.'))\n"
        "print(len([k for k in sys.modules if k.startswith('ekpnp_torch')]), bad)\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    pat = re.compile(r"^\s*(import\s+(jax|ekpnp)\b(?!_)|from\s+(jax|ekpnp)\b(?!_))",
                     re.M)
    for root, _, files in os.walk(os.path.join(REPO, "ekpnp_torch")):
        for fn in files:
            if fn.endswith((".py", ".cu")):
                with open(os.path.join(root, fn)) as fh:
                    src = fh.read()
                assert not pat.search(src), fn
