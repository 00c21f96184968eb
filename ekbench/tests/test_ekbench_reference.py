"""The frozen reference (`ekbench.reference`) against the port's plain path
(`ekpnp_torch.step`, `init`, `diagnostics`) at the upstream's own size,
50x8x51, in float64 on the CPU, on both scalar lattices.  The test may
import the port; the reference never does."""
import dataclasses

import pytest
import torch

from ekbench.reference import lbm, params, shards, solve

torch.set_num_threads(2)
STEPS = 4


def _cfg(scalar_lattice):
    from ekpnp_torch.config import preset

    return preset("reference", scalar_lattice=scalar_lattice, pb_iters=60)


def _params(cfg):
    return params.from_config({k: dataclasses.asdict(getattr(cfg, k))
                               for k in ("grid", "physics", "run")})


def _rel(a, b, scale):
    return float((a - b).abs().max()) / scale


@pytest.mark.parametrize("scalar_lattice", ["same", "D3Q7"])
def test_reference_follows_the_port(scalar_lattice):
    from ekpnp_torch.diagnostics import series_point
    from ekpnp_torch.init import initialize, state_from_macro
    from ekpnp_torch.ops.poisson import efield
    from ekpnp_torch.state import Macro
    from ekpnp_torch.step import step

    cfg = _cfg(scalar_lattice)
    P = _params(cfg)
    st, mac = initialize(cfg, device="cpu")
    phi, c, cn = solve.pb_cold_start(P, "cpu", torch.float64)
    gap = float((phi - P.voltage).abs().max())
    assert _rel(st.phi, phi, gap) < 1e-12
    assert _rel(mac.charge, c, float(c.abs().max())) < 1e-12
    assert _rel(mac.chargen, cn, float(cn.abs().max())) < 1e-12

    g = torch.Generator().manual_seed(7)
    du = 1e-3 * torch.randn((3,) + cfg.grid.shape, generator=g,
                            dtype=torch.float64)
    dc = 0.05 * torch.randn(cfg.grid.shape, generator=g, dtype=torch.float64)
    m = Macro(rho=mac.rho, u=mac.u + du, charge=mac.charge * (1 + dc),
              chargen=mac.chargen * (1 - dc), temp=mac.temp + dc)
    port = state_from_macro(cfg, m, st.phi, efield(cfg, st.phi), 0.0)
    ref = lbm.initial_state(P, m.rho, m.u, m.charge, m.chargen, m.temp,
                            st.phi, solve.efield(P, st.phi))
    for k in lbm.POPS:
        assert _rel(getattr(port, k), ref[k],
                    float(ref[k].abs().max())) < 1e-14
    start = dict(ref)
    for _ in range(STEPS):
        port, _ = step(cfg, port)
        ref = lbm.step(P, ref)
    for k in lbm.POPS:
        change = float((ref[k] - start[k]).abs().max())
        assert _rel(getattr(port, k), ref[k], change) < 1e-9, k
    assert _rel(port.phi, ref["phi"], gap) < 1e-12
    got = [float(x) for x in series_point(cfg, port)[:4]]
    want = lbm.series(P, ref)
    for v, k in zip(got, ("umax", "umag", "current", "mean_T")):
        assert v == pytest.approx(want[k], rel=1e-9, abs=1e-30), k


def test_reference_imports_nothing_of_the_program():
    import subprocess
    import sys

    code = ("import sys, ekbench.reference.lbm, ekbench.reference.solve, "
            "ekbench.reference.shards, ekbench.reference.params, "
            "ekbench.compare, ekbench.perturb\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'ekpnp', 'ekpnp_torch')]\n"
            "print(','.join(bad))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=_root())
    assert out.stdout.strip() == ""


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12,
                      -(1.0 + 3 * 2.0 ** -12)], dtype=torch.float32)
    got = solve.round_tf32(x).tolist()
    assert got == [1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, 1.0,
                   -(1.0 + 2.0 ** -10)]


def test_slab_rows_cut_y_in_order():
    assert [shards.rows(256, 4, i) for i in range(4)] == [
        (0, 64), (64, 128), (128, 192), (192, 256)]
    a = torch.arange(2 * 8 * 3).reshape(2, 8, 3)
    assert torch.equal(torch.cat([shards.cut(a, 4, i) for i in range(4)], 1), a)
    with pytest.raises(ValueError):
        shards.rows(10, 4, 0)


def _root():
    import os

    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
