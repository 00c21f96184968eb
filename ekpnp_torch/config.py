"""Configuration for the PyTorch/CUDA port.

The port's own copy of `ekpnp/config.py`: same dataclasses, field names,
defaults and presets, so config files and `--set` work in both packages;
tests/test_torch_modules.py holds every preset equal field by field.
The port does not read `RunConfig.use_pallas`: on CUDA tensors the step
always runs the hand-written kernel, on CPU tensors its plain version.

The reference keeps ALL configuration as compile-time `__constant__` globals
(reference LBM.h:28-125).  Here everything is a runtime frozen dataclass:
hashable, so configs can be passed to `jax.jit` as static arguments, and the
same binary serves every grid size / physics setup.

Defaults reproduce the reference's canonical ETHD microchannel case exactly
(reference LBM.h values cited per field).  Named presets cover the 5 BASELINE
configs (BASELINE.json:configs).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

from .lattice import Lattice, get_lattice

_TWO_PI = 2.0 * math.pi


@dataclasses.dataclass(frozen=True)
class GridConfig:
    """Domain discretization (reference LBM.h:32-45)."""

    nx: int = 50          # grid points in x (LBM.h:32)
    ny: int = 8           # grid points in y (LBM.h:34)
    nz: int = 51          # grid points in z — wall-normal (LBM.h:35)
    dx: float = 1.0e-8    # cell size [m] (LBM.h:43-45: 1e-6/100)
    dy: float = 1.0e-8
    dz: float = 1.0e-8

    @property
    def ne(self) -> int:
        """z-extent of the odd-extended Poisson domain (LBM.h:37)."""
        return 2 * (self.nz - 1)

    @property
    def lx(self) -> float:
        return self.nx * self.dx

    @property
    def ly(self) -> float:
        return self.ny * self.dy

    @property
    def lz(self) -> float:
        # Reference Lz = 0.5e-6 with nz=51, dz=1e-8: Lz = (nz-1)*dz (LBM.h:42)
        return (self.nz - 1) * self.dz

    @property
    def shape(self) -> tuple[int, int, int]:
        """Scalar-field shape, (Z, Y, X) — x fastest, matching TPU lanes."""
        return (self.nz, self.ny, self.nx)

    @property
    def num_nodes(self) -> int:
        return self.nx * self.ny * self.nz


@dataclasses.dataclass(frozen=True)
class PhysicsConfig:
    """Physical constants (reference LBM.h:46-99) and TRT magic parameters
    (LBM.h:115-118).  All in SI units, matching the reference's physical-unit
    formulation (velocities are scaled by 1/CFL inside the ops)."""

    # -- time stepping / lattice scaling (LBM.h:51-54)
    cfl: float = 0.01           # CFL = dt/dx
    rho0: float = 1000.0        # fluid density [kg/m^3]
    nu: float = 0.889e-6        # kinematic viscosity [m^2/s] (LBM.h:67)

    # -- electrokinetics (LBM.h:56-90)
    chargeinf: float = 0.01       # bulk ion concentration [mol/m^3]
    charge0: float = 1.2364549e-2   # (+) injection lower (dead in ref; kept)
    charge1: float = 1.2364549e-2   # (+) injection upper
    charge0n: float = 8.087639e-3   # (-) injection lower
    charge1n: float = 8.087639e-3   # (-) injection upper
    voltage: float = -5.2574e-3   # zeta potential, lower plate [V]
    voltage2: float = -5.2574e-3  # zeta potential, upper plate [V]
    ext_field: float = 1.0e4      # external E field along x [V/m] (Ext)
    eps: float = 6.95e-10         # permittivity [F/m]
    diffu: float = 1.0e-8         # (+) ion diffusivity [m^2/s]
    diffun: float = 1.0e-8        # (-) ion diffusivity [m^2/s]
    K: float = 4.245e-7           # (+) ion mobility [m^2/(V s)]
    Kn: float = -4.245e-7         # (-) ion mobility
    convert_c_to_charge: float = 9.64e4  # mol/m^3 -> C/m^3 (LBM.h:90)
    NA: float = 6.022e23
    kB: float = 1.38e-23
    electron: float = 1.6e-19
    roomT: float = 273.0
    pb_omega: float = 0.05        # PB init relaxation factor (LBM.h:91)
    pb_iters: int = 501           # reference loop: i in 0..500 (LBM.cu:89)
    two_species: bool = True      # False: single-species Nernst-Planck
                                  # (BASELINE config 2) — no (-) population;
                                  # chargen is identically zero
    charge_bc: str = "noflux"     # ion wall BC at the plates:
                                  # "noflux" (reference default, Yoshida
                                  # localized scheme, LBM.cu:2102-2218) |
                                  # "injection" (Dirichlet anti-bounce-back
                                  # h1 = -h2_opp + 2 c_w w_i with the
                                  # charge0/charge1[n] plate levels — the
                                  # reference's commented-out ETHD injection
                                  # regime, LBM.cu:2231-2292, the BC its
                                  # dead constants LBM.h:57-58,81-83 exist
                                  # for) | "zerograd-top" (zero-gradient
                                  # outflow at the upper plate, noflux at
                                  # the lower — LBM.cu:1929-1958, also
                                  # commented out; oracle path only)
    joule: float = 0.0            # Joule-heating coefficient: adds a
                                  # volumetric source joule (c+ + c-) |E|^2
                                  # to the temperature field (extension
                                  # beyond the reference; 0 = parity)

    # -- thermal (LBM.h:95-98)
    D: float = 0.889e-6           # thermal diffusivity [m^2/s]
    Ra: float = 1.0               # Rayleigh number
    TH: float = 1.0               # lower-plate temperature

    # -- driving (LBM.h:47-50)
    uw: float = 0.0               # upper-wall x velocity (moving lid)
    exf: float = 0.0              # external body force in x (Poiseuille)

    # -- TRT magic parameters (LBM.h:115-118)
    V: float = 1.0 / 12.0
    VC: float = 1.0e-6
    VCn: float = 1.0e-6
    VT: float = 1.0 / 12.0

    # -- reference bit-parity quirk (see also RunConfig.compat_cadence;
    #    `--set compat=reference` enables both)
    compat_ref_multis: bool = False   # reproduce the reference's moving-wall
                                      # quirk: direction 3 (+y) receives the
                                      # +multis momentum term at the upper
                                      # plate despite e_3x = 0 (LBM.cu:1904).
                                      # Default off = the physically-standard
                                      # e_ix-proportional term; identical
                                      # results at the default uw = 0.

    # -- coupling switches (which populations are active)
    enable_ek: bool = True        # ion populations h / hn + Poisson
    enable_thermal: bool = True   # temperature population + buoyancy

    def dt(self, dx: float) -> float:
        """dt = dx * CFL (LBM.h:52)."""
        return self.cfl * dx

    def cs_square(self) -> float:
        """Physical-units sound speed squared: (dx/dt)^2/3 = 1/(3 CFL^2)
        in units where dx=dt relation holds (LBM.h:53).  NOTE: the reference
        hardcodes 1/3/CFL^2 * 1 (m/s)^2 because dx/dt = 1e-8/1e-10 = 100 m/s
        and cs^2 = (100)^2/3 = 1/3/0.01^2.  We reproduce the same value for
        the same (dx, cfl); for other dx the lattice velocity is dx/dt =
        1/cfl * 1 m/s only if dx is in units of 1e-8 m — we instead use the
        dimensionally-correct (dx/dt)^2/3 which equals the reference value
        for its parameters."""
        return 1.0 / 3.0 / (self.cfl * self.cfl)

    # -- TRT relaxation rates (reference LBM.cu:488-495) --------------------
    def omegas(self, dx: float, scalar_cs2: Optional[float] = None) -> dict[str, float]:
        """scalar_cs2: sound speed squared of the scalar-transport lattice
        (equals cs_square() for the reference-parity D3Q27 scalars; 1/4/CFL^2
        when RunConfig.scalar_lattice = "D3Q7")."""
        dt = self.dt(dx)
        cs2 = self.cs_square()
        cs2_s = scalar_cs2 if scalar_cs2 is not None else cs2

        def plus_minus(diff: float, magic: float, c2: float) -> tuple[float, float]:
            tau = diff / c2 / dt
            om_sym = 1.0 / (tau + 0.5) / dt          # relaxes the diffusive part
            om_anti = 1.0 / (magic / tau + 0.5) / dt
            return om_sym, om_anti

        # fluid: omega_plus relaxes the even (viscous) part
        omega_plus, omega_minus = plus_minus(self.nu, self.V, cs2)
        # scalars: omega_minus relaxes the odd part (diffusivity), the
        # even rate comes from the magic parameter (LBM.cu:490-495)
        omega_c_minus, omega_c_plus = plus_minus(self.diffu, self.VC, cs2_s)
        omega_cn_minus, omega_cn_plus = plus_minus(self.diffun, self.VCn, cs2_s)
        omega_T_minus, omega_T_plus = plus_minus(self.D, self.VT, cs2_s)
        return dict(
            omega_plus=omega_plus,
            omega_minus=omega_minus,
            omega_c_plus=omega_c_plus,
            omega_c_minus=omega_c_minus,
            omega_cn_plus=omega_cn_plus,
            omega_cn_minus=omega_cn_minus,
            omega_T_plus=omega_T_plus,
            omega_T_minus=omega_T_minus,
        )

    # -- dimensionless groups (reference LBM.cu:2419-2446) ------------------
    def dimensionless(self, lz: float) -> dict[str, float]:
        M = math.sqrt(self.eps / self.rho0) / self.K
        T = self.eps * self.voltage / (self.K * self.nu * self.rho0)
        C = self.chargeinf * lz * lz / (self.voltage * self.eps)
        Fe = self.K * self.voltage / self.diffu
        Pr = self.nu / self.D
        return dict(M=M, T=T, C=C, Fe=Fe, Pr=Pr)


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Run control (reference LBM.h:122-125) + framework knobs."""

    nsteps: int = 1000
    nsave: int = 500              # tecplot dump cadence (NSAVE)
    print_current: int = 50       # diagnostics cadence (printCurrent)
    dtype: str = "float64"        # "float64" (validation) | "float32" (perf)
    lattice: str = "D3Q27"
    scalar_lattice: str = "same"  # lattice for the scalar-transport fields
                                  # (ions, temperature): "same" = the fluid
                                  # lattice (reference parity, LBM.cu:162-463)
                                  # | "D3Q7" (ADE-sufficient, 7/27 the HBM
                                  # traffic per scalar field) | "D3Q19"
    use_pallas: bool = False      # fused Pallas collide path
    fft_method: str = "auto"      # "auto" | "fft" | "matmul" (MXU DFT)
    perturb_first_step: bool = False  # seed a convection pattern at step 0
    perturb_pattern: str = "square"   # "square" (reference LBM.cu:651-654) |
                                      # "hexagon" (the reference's commented
                                      # intent, LBM.cu:655-661, with the
                                      # algebra corrected — see
                                      # ops/collide.perturbation_velocity)
    LL: float = 0.5               # perturbation wavelength ratio (LBM.h:39)
    compat_cadence: bool = False  # reproduce the reference's save/diagnostic
                                  # cadence exactly: events fire after loop
                                  # iteration i when i % N == 1, i.e. after
                                  # 2, N+2, 2N+2, ... completed steps
                                  # (main.cu:206,211) instead of at exact
                                  # multiples of N.  `--set compat=reference`
                                  # enables this together with
                                  # PhysicsConfig.compat_ref_multis for
                                  # step-aligned, term-identical comparison
                                  # against the CUDA binary.
    outdir: str = "out"


@dataclasses.dataclass(frozen=True)
class Config:
    grid: GridConfig = dataclasses.field(default_factory=GridConfig)
    physics: PhysicsConfig = dataclasses.field(default_factory=PhysicsConfig)
    run: RunConfig = dataclasses.field(default_factory=RunConfig)

    @property
    def lattice(self) -> Lattice:
        return get_lattice(self.run.lattice)

    @property
    def scalar_lat(self) -> Lattice:
        """Lattice for the scalar-transport fields (ions, temperature)."""
        if self.run.scalar_lattice == "same":
            return self.lattice
        return get_lattice(self.run.scalar_lattice)

    @property
    def dt(self) -> float:
        return self.physics.dt(self.grid.dx)

    @property
    def cs2(self) -> float:
        return self.physics.cs_square()

    @property
    def cs2_s(self) -> float:
        """Physical-units sound speed squared of the scalar lattice:
        cs2_lat (dx/dt)^2 = cs2_lat / CFL^2 (cf. PhysicsConfig.cs_square)."""
        return self.scalar_lat.cs2_lat / (self.physics.cfl ** 2)

    def omegas(self) -> dict[str, float]:
        return self.physics.omegas(self.grid.dx, scalar_cs2=self.cs2_s)


# ---------------------------------------------------------------------------
# Named presets: the 5 BASELINE configs (BASELINE.json) + the reference case.
# ---------------------------------------------------------------------------

def preset(name: str, **overrides) -> Config:
    name = name.lower()
    if name in ("reference", "ethd"):
        cfg = Config()
    elif name == "poiseuille":
        # BASELINE config 1: plain LBM channel flow, no EK/thermal.
        cfg = Config(
            grid=GridConfig(nx=64, ny=32, nz=32),
            physics=PhysicsConfig(
                enable_ek=False, enable_thermal=False, exf=1.0e-4,
            ),
            run=RunConfig(lattice="D3Q19", nsteps=2000),
        )
    elif name == "ek-channel":
        # BASELINE config 2: LBM + Poisson + single species, fixed zeta.
        cfg = Config(
            grid=GridConfig(nx=128, ny=64, nz=65),
            physics=PhysicsConfig(enable_thermal=False, two_species=False),
            run=RunConfig(),
        )
    elif name == "ek-pnp":
        # BASELINE config 3: two-species NP + Poisson + body-force feedback.
        cfg = Config(
            grid=GridConfig(nx=128, ny=128, nz=129),
            physics=PhysicsConfig(enable_thermal=False),
            run=RunConfig(),
        )
    elif name == "ek-pnp-thermal":
        # BASELINE config 4: full coupling + thermal, single host.
        cfg = Config(
            grid=GridConfig(nx=256, ny=256, nz=257),
            physics=PhysicsConfig(),
            run=RunConfig(dtype="float32"),
        )
    elif name == "pod":
        # BASELINE config 5: multi-host sharded run.
        cfg = Config(
            grid=GridConfig(nx=512, ny=256, nz=257),
            physics=PhysicsConfig(),
            run=RunConfig(dtype="float32"),
        )
    else:
        raise ValueError(f"unknown preset {name!r}")
    return _apply_overrides(cfg, overrides)


def from_file(path: str, **extra_overrides) -> Config:
    """Build a Config from a YAML or JSON file (SURVEY.md §1 L5 mapping:
    `ekpnp run config.yaml`).

    File layout: an optional top-level `preset:` key (default "reference")
    selects the base; every other key is a config-field override — either
    flat, or grouped under `grid:` / `physics:` / `run:` sections.
    Keyword overrides (the CLI's --steps/--set/...) win over file values.
    """
    import json

    with open(path) as f:
        text = f.read()
    if path.endswith(".json"):
        data = json.loads(text)
    else:
        import yaml

        data = yaml.safe_load(text)
    if not isinstance(data, dict):
        raise ValueError(f"config file {path!r} must contain a mapping")
    data = dict(data)
    name = data.pop("preset", "reference")
    flat = {}
    for k, v in data.items():
        if k in ("grid", "physics", "run") and isinstance(v, dict):
            dup = set(v) & set(flat)
            if dup:
                raise ValueError(f"duplicate config keys in {path!r}: {sorted(dup)}")
            flat.update(v)
        else:
            flat[k] = v
    flat.update(extra_overrides)
    return preset(name, **flat)


def _apply_overrides(cfg: Config, overrides: dict) -> Config:
    if not overrides:
        return cfg
    overrides = dict(overrides)
    compat = overrides.pop("compat", None)
    if compat is not None:
        if compat not in ("reference", "none"):
            raise ValueError(f"unknown compat mode {compat!r} (reference|none)")
        on = compat == "reference"
        overrides.setdefault("compat_ref_multis", on)
        overrides.setdefault("compat_cadence", on)
    grid_f = {f.name for f in dataclasses.fields(GridConfig)}
    phys_f = {f.name for f in dataclasses.fields(PhysicsConfig)}
    run_f = {f.name for f in dataclasses.fields(RunConfig)}
    g, p, r = {}, {}, {}
    for k, v in overrides.items():
        if k in grid_f:
            g[k] = v
        elif k in phys_f:
            p[k] = v
        elif k in run_f:
            r[k] = v
        else:
            raise ValueError(f"unknown config field {k!r}")
    return Config(
        grid=dataclasses.replace(cfg.grid, **g),
        physics=dataclasses.replace(cfg.physics, **p),
        run=dataclasses.replace(cfg.run, **r),
    )
