"""End-to-end checks of the port on the CPU: the golden run and the kernel
wrapper's host-side contract.  The CUDA kernels themselves run only on the
card, where chip_smoke.py holds them to their plain versions."""
import os
import sys

import numpy as np
import pytest
import torch

import test_torch_common  # noqa: F401  (one torch thread per worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_golden_reference_run():
    """`reference` preset, f64, CPU: initialize + 60 plain steps reproduce
    the JAX package's golden values (tests/test_golden.py) at rtol=1e-9."""
    import ekpnp_torch
    from ekpnp_torch.diagnostics import ionic_current, umax
    from ekpnp_torch.init import initialize
    from ekpnp_torch.ops.collide import compute_macro
    from ekpnp_torch.ops.poisson import efield
    from ekpnp_torch.step import multi_step
    from test_golden import GOLDEN

    cfg = ekpnp_torch.preset("reference")
    state, _ = initialize(cfg, device="cpu")
    state = multi_step(cfg, state, 60)
    macro, _ = compute_macro(cfg, state)
    E = efield(cfg, state.phi)
    got = {
        "umax": umax(macro.u),
        "current": ionic_current(cfg, macro.charge, macro.chargen, E[2]),
        "rho_mean": torch.mean(macro.rho),
        "charge_sum": torch.sum(macro.charge),
        "chargen_sum": torch.sum(macro.chargen),
        "temp_mean": torch.mean(macro.temp),
        "phi_min": torch.min(state.phi),
        "phi_max": torch.max(state.phi),
        "uz_abs_sum": torch.sum(torch.abs(macro.u[2])),
    }
    for key, want in GOLDEN.items():
        np.testing.assert_allclose(float(got[key]), want, rtol=1e-9,
                                   err_msg=key)


def test_chip_smoke_golden_copy_is_the_golden():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    from test_golden import GOLDEN

    assert chip_smoke.GOLDEN == GOLDEN


def test_chip_smoke_pinned_tail_copy_is_the_pinned_tail():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    from test_production_run import _PINNED_TAIL

    assert chip_smoke.PINNED_TAIL == _PINNED_TAIL


def test_kernel_constant_blocks_match_the_cuda_structs():
    """The packed (ints, consts) blocks have the length of HostInts /
    HostConsts in csrc/fused_step.cu, field by field."""
    import re

    from ekpnp_torch import preset
    from ekpnp_torch.kernels import fused_step as fs

    with open(fs.SOURCE) as fh:
        src = fh.read()

    def struct_fields(name, ctype):
        body = re.search(r"struct %s \{(.*?)\};" % name, src, re.S).group(1)
        body = re.sub(r"//[^\n]*", "", body)
        n = 0
        for decl in body.split(";"):
            decl = decl.strip()
            if not decl.startswith(ctype + " "):
                continue
            for var in decl[len(ctype) + 1:].split(","):
                dims = [int(d) for d in re.findall(r"\[(\d+)\]", var)]
                n += int(np.prod(dims)) if dims else 1
        return n

    ints, consts = fs.pack_constants(preset("reference", joule=1.0,
                                            charge_bc="injection"))
    assert len(ints) == struct_fields("HostInts", "int") == len(fs._INTS)
    assert len(consts) == struct_fields("HostConsts", "double")
    assert ints.dtype == np.int32 and consts.dtype == np.float64


def test_fused_step_dispatch_on_cpu_runs_the_plain_version():
    from ekpnp_torch.kernels import fused_step as fs
    from test_torch_common import configs, make_state_np, port_state

    _, cfg = configs("B")
    st = port_state(cfg, make_state_np(cfg, seed=21))
    before = dict(fs.launches)
    got = fs.fused_step(cfg, st.f, st.h, st.hn, st.g, st.phi)
    want = fs.fused_step_reference(cfg, st.f, st.h, st.hn, st.g, st.phi)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert fs.launches == before  # no kernel launched for CPU tensors
    with pytest.raises(ValueError, match="required"):
        fs.fused_step(cfg, st.f, st.h, None, st.g, st.phi)
    with pytest.raises(ValueError, match="shape"):
        fs.fused_step(cfg, st.f[:, 1:], st.h, st.hn, st.g, st.phi)



def test_plain_x_hartley_forms_transform_the_plain_form():
    """The plain versions of the x-Hartley forms: hartley_x emits the plain
    form's RHS times H along x (max abs diff <= 1e-15) with the same
    populations; phi_hx equals hartley_x on the decoded potential.  The
    CPU dispatch runs them and launches nothing."""
    from ekpnp_torch.kernels import fused_step as fs
    from ekpnp_torch.ops.poisson import phi_from_psi_hx, psi_hx_from_phi
    from ekpnp_torch.parallel.fft import hartley_x_local
    from test_torch_common import configs, make_state_np, port_state

    _, cfg = configs("B")
    st = port_state(cfg, make_state_np(cfg, seed=22))
    pops = (st.f, st.h, st.hn, st.g)
    plain = fs.collide_reference(cfg, *pops, st.phi, hartley_x=False)
    hx = fs.collide_reference(cfg, *pops, st.phi, hartley_x=True)
    assert float((hx[4] - hartley_x_local(plain[4])).abs().max()) <= 1e-15
    for a, b in zip(hx[:4], plain[:4]):
        assert torch.equal(a, b)
    psi = psi_hx_from_phi(cfg, st.phi)
    want = fs.fused_step_reference(cfg, *pops, phi_from_psi_hx(cfg, psi),
                                   hartley_x=True)
    before = dict(fs.launches)
    got = fs.fused_step(cfg, *pops, psi, phi_hx=True)
    assert fs.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_form_resolution_phi_hx_gate_and_row_blocks():
    import ekpnp_torch
    from ekpnp_torch.kernels.fused_step import (ROWS_TILE, hartley_rows_grid,
                                                resolve_hartley_x)
    from ekpnp_torch.kernels.step import phi_hx_capable

    small = dict(nx=16, ny=8, nz=9)
    ek = ekpnp_torch.preset("reference", fft_method="matmul", **small)
    auto = ekpnp_torch.preset("reference", **small)
    fft = ekpnp_torch.preset("reference", fft_method="fft", **small)
    fluid = ekpnp_torch.preset("reference", enable_ek=False, **small)
    assert resolve_hartley_x(ek) and resolve_hartley_x(auto)
    assert not resolve_hartley_x(fft) and not resolve_hartley_x(fluid)
    assert not resolve_hartley_x(ek, hartley_x=False)
    assert resolve_hartley_x(fft, phi_hx=True)
    with pytest.raises(ValueError, match="EK"):
        resolve_hartley_x(fluid, hartley_x=True)
    with pytest.raises(ValueError, match="phi_hx"):
        resolve_hartley_x(ek, hartley_x=False, phi_hx=True)
    assert phi_hx_capable(ek) and phi_hx_capable(auto)
    assert not phi_hx_capable(fft) and not phi_hx_capable(fluid)
    # the row product's tiles and grid: every output of m rows of nx
    # values once, for m not a multiple of the tile (the kernel's block b
    # takes tile rows b // nc and tile columns b % nc, clipped)
    # (the tensor-core form, f32, its own tile)
    assert ROWS_TILE == {4: (128, 128), 8: (128, 64), "tf32x3": (128, 128)}
    for itemsize, tc in ((4, False), (8, False), (4, True)):
        for nx in (16, 50, 256, 512):
            for m in (1, 127, 255 * 7 + 3):
                bm, bn, blocks = hartley_rows_grid(m, nx, itemsize, tc)
                assert (bm, bn) == ROWS_TILE["tf32x3" if tc else itemsize]
                nc = -(-nx // bn)
                hits = np.zeros((m, nx), dtype=np.int64)
                for b in range(blocks):
                    r0, c0 = (b // nc) * bm, (b % nc) * bn
                    assert r0 < m and c0 < nx  # no idle block
                    hits[r0:r0 + bm, c0:c0 + bn] += 1
                assert (hits == 1).all(), (itemsize, tc, nx, m)
