"""Shared helpers of the PyTorch-port tests (no tests of its own).

Each case's inputs are built once with numpy: equilibrium populations of a
seeded macroscopic state plus small seeded noise, and a seeded phi near
`voltage`.  The same arrays go to the JAX package (`jnp.asarray`) and to
the port (`ekpnp_torch.convert.state_from_numpy`).  The JAX side runs its
oracle step (`ekpnp.step.step_jit`, use_pallas=False).
"""
import numpy as np
import torch

torch.set_num_threads(1)

# f64 tolerances of the fused-kernel equality tests (test_pallas_fused.py)
RTOL, ATOL = 1e-11, 1e-13
FIELDS = ("f", "h", "hn", "g", "phi")

# the physics matrix: (preset, overrides) per case
CASES = {
    "A": ("reference", dict(nx=16, ny=8, nz=9)),
    "B": ("reference", dict(nx=16, ny=8, nz=9, charge_bc="zerograd-top")),
    "C": ("reference", dict(nx=16, ny=32, nz=9, charge_bc="zerograd-top",
                            scalar_lattice="D3Q7")),
    "D": ("poiseuille", dict(nx=16, ny=16, nz=9, exf=1e9)),
    "E": ("reference", dict(nx=16, ny=8, nz=9, enable_ek=False,
                            enable_thermal=False, uw=0.5)),
    "E-compat": ("reference", dict(nx=16, ny=8, nz=9, enable_ek=False,
                                   enable_thermal=False, uw=0.5,
                                   compat_ref_multis=True)),
    "F": ("reference", dict(nx=16, ny=8, nz=9, enable_ek=False)),
    "G": ("ek-pnp", dict(nx=16, ny=8, nz=9)),
    "H": ("ek-channel", dict(nx=16, ny=8, nz=9, scalar_lattice="D3Q7",
                             joule=1.0e4)),
    "I": ("reference", dict(nx=16, ny=8, nz=9, charge_bc="injection",
                            joule=1.0e4)),
    "J": ("reference", dict(nx=10, ny=8, nz=9)),
}


def configs(case, fft_method="matmul", **grid):
    """(JAX config, port config) of one case, f64, with `grid` overrides."""
    import ekpnp
    import ekpnp_torch

    name, ov = CASES[case]
    ov = dict(ov, **grid, fft_method=fft_method, dtype="float64")
    return ekpnp.preset(name, **ov), ekpnp_torch.preset(name, **ov)


def _feq_np(lat, m, v, cfl, cs2):
    E = lat.E.astype(np.float64)
    t = np.einsum("qa,a...->q...", E, v) / (cs2 * cfl)
    omusq = 1.0 - 0.5 * np.sum(v * v, axis=0) / cs2
    return lat.W[:, None, None, None] * m[None] * (omusq[None] + t * (1.0 + 0.5 * t))


def make_state_np(cfg, seed=0, noise=1e-3):
    """dict {f, h, hn, g, phi, t} of numpy f64 arrays for `cfg` (a config of
    either package: only numpy-level fields are read)."""
    rng = np.random.default_rng(seed)
    g = cfg.grid
    p = cfg.physics
    shape = g.shape
    lat, lat_s = cfg.lattice, cfg.scalar_lat
    cfl, cs2, cs2_s = p.cfl, cfg.cs2, cfg.cs2_s

    def jitter(a, rel):
        return a * (1.0 + rel * rng.standard_normal(a.shape))

    rho = jitter(np.full(shape, p.rho0), 1e-4)
    u = 1e-2 * rng.standard_normal((3,) + shape)

    def pops(lt, m, v):
        return jitter(_feq_np(lt, m, v, cfl, cs2 if lt is lat else cs2_s), noise)

    out = {"f": pops(lat, rho, u), "h": None, "hn": None, "g": None,
           "phi": None, "t": np.float64(0.0)}
    if p.enable_ek:
        out["h"] = pops(lat_s, jitter(np.full(shape, p.charge0), 0.05), u)
        if p.two_species:
            out["hn"] = pops(lat_s, jitter(np.full(shape, p.charge0n), 0.05), u)
        out["phi"] = p.voltage * (1.0 + 0.05 * rng.standard_normal(shape))
    if p.enable_thermal:
        z = np.arange(g.nz)[:, None, None]
        temp = np.broadcast_to(p.TH * (1.0 - z / (g.nz - 1)), shape)
        out["g"] = pops(lat_s, temp + 0.01 * rng.standard_normal(shape), u)
    return out


def jax_state(arrays):
    import jax.numpy as jnp

    from ekpnp.state import State

    conv = lambda a: None if a is None else jnp.asarray(a)
    return State(**{k: conv(arrays[k]) for k in FIELDS},
                 t=jnp.asarray(arrays["t"]))


def port_state(cfg, arrays):
    from ekpnp_torch.convert import state_from_numpy

    return state_from_numpy(cfg, arrays, device="cpu", dtype="float64")


def jax_steps(cfg, arrays, n):
    """n oracle steps of the JAX package from `arrays`; numpy dict out."""
    from ekpnp.step import step_jit

    st = jax_state(arrays)
    for _ in range(n):
        st, _ = step_jit(cfg, st)
    return {k: (None if getattr(st, k) is None else np.asarray(getattr(st, k)))
            for k in FIELDS}


def to_np(t):
    return None if t is None else t.detach().cpu().numpy()


def assert_fields_close(want, got, names=FIELDS, rtol=RTOL, atol=ATOL,
                        label=""):
    """want/got: mappings name -> array (or None for an absent field)."""
    for name in names:
        a, b = want[name], got[name]
        if a is None:
            assert b is None, f"{label}{name}: expected absent"
            continue
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=rtol,
                                   atol=atol, err_msg=f"{label}{name}")
