#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`ekpnp_torch`) on one NVIDIA H100.

    python3 chip_smoke.py          # needs one CUDA device; run from the repo root

It drives the port only (no JAX, nothing of `ekpnp`) and fails, without
printing the final line, if any phase fails:

  1. card: name and power limit (nvidia-smi), torch and CUDA versions;
  2. build the fused step kernels from csrc/fused_step.cu (nvcc, sm_90a),
     registers and spill stores per kernel (per lattice pair for the
     collide, the passes and the stream, the row-staged shard pass
     fused_pass_rows_kernel per tile beside the per-node
     fused_pass_halo_kernel; the row product's tensor-core form
     hartley_rows_tf32x3_kernel on a line of its own);
  3. kernels vs their plain PyTorch versions on the card: the row product
     alone at NX 10, 16, 25, 50, 256 and 512 on row counts no multiple of
     its tile (plain and lifted, aligned and not), in both forms: in f32
     at NX 16, 256 and 512 the tensor-core form (hartley_rows_tf32x3_kernel,
     taken by the wrapper's rule, read from the launch counts) and the FMA
     form (hartley_rows_kernel, forced), elsewhere the FMA form;
     every collide form and the stream on an odd 25x7x9 grid (their
     one-value staging and pull paths); then physics cases A-J and the reference's own 50x8x51, f64 and f32,
     3 steps each, every collide form (plain RHS; with EK on also
     hartley_x and phi_hx, psi encoded from the case's phi) and the fused
     pass of every form (fused_pass_kernel on the plain collide's
     post-collision set):
     max|d|/max|ref| per field <= 1e-12 (f64) / 1e-5 (f32);
  4. golden: `reference`, f64, initialize + 60 steps of the default
     multi_step (one chunk: a collide, 59 fused passes and a stream on the
     phi_hx route, its launches counted), the golden values of
     tests/test_golden.py at rtol 1e-9;
  5. main path at full size through the port's API: `ek-pnp-thermal`
     (256x256x257, f32, every field D3Q27): PB init (501 iterations, with
     pb_omega 0.02: the preset's 0.05 diverges at this NZ) + 100
     steps of the default multi_step (phi_hx route) with a series point
     every 50, then 50 steps with phi_hx off (hartley_x form); then the
     bench headline (256x256x257, f32, D3Q7 scalars) the same way for
     50 + 50 steps, and 40 steps of it with fft_method "fft" (the
     plain-RHS form's path).  Launch counts are zeroed before each run and
     must be, per chunk, one collide and one stream of the run's form and
     a fused pass for every other step (and the row products per step);
     the state must stay finite; 20 steps of the fused chunk must equal 20
     two-launch steps (step_fused_hx) bit for bit; every collide form, the
     fused pass of every form, stream_bc (next to Tensor.copy_ of the same
     bytes, its practical ceiling), the row product in both forms (next to
     torch.matmul on the same rows, also device-only, and each one's error
     against the f64 product) and the three solves are timed by CUDA
     events and each kernel is held to its plain version on that run's
     state; every full-size f32 run's row products must all be of the
     tensor-core form (hartley_rows_kernel.tf32x3 = hartley_rows_kernel);
  6. the CLI with the perturbed first step, 10 steps on the card: rc 0,
     finite series;
then the sharded time loop (ekpnp_torch/parallel), its shards all on the
one card (a mesh may hold a device more than once):
  3b. every sharded kernel form against its plain version, on slab 2,
     slab 4 and pencil 2x2 meshes, cases A-J and 50x8x51, f64 and f32, two
     rounds per case (the halo exchange of parallel/halo.py between): the
     .halo collide forms (plain RHS; with EK also hartley_x and phi_hx) and
     the .shard_x collide on pencils, the fused pass of each form
     (fused_pass_kernel .halo / .shard_x, pulling across the shard's edges
     from the exchanged rows and a pencil's columns), stream_bc .halo on
     both, <= 1e-12 (f64) / 1e-5 (f32); 3 sharded chunk steps against 3
     single-device steps on the same route, and against 3 two-launch
     sharded steps (step_halo) bit for bit; the overlapped chunk equal to
     the serial one bit for bit (these cases' shards take the per-node
     shard pass, fused_pass_halo_kernel); then the row-staged shard pass
     (fused_pass_rows_kernel) at shapes that take it: cases A, C, I, F at
     NX 256 on slab 2, slab 4, pencil 2x2 and pencil 2x4 (tiles 128 and
     64), f64 and f32, every form and shard: its launch counted, within
     the tolerances above of its plain version and equal to the forced
     per-node pass bit for bit;
  4b. golden: `reference`, f64, one chunk of 60 steps on a slab-2 mesh
     (phi_hx route per shard, its launches counted), rtol 1e-9;
  3c. a mesh whose solve cuts an empty piece: `reference` 4x8x9, f64, fft
     route (cuFFT) on slab 8 (NX 4 over 8 shards), 2 sharded steps against
     2 one-device steps at 1e-11;
  5b. full size: `ek-pnp-thermal` 256x256x257 f32 from phase 5's start
     state, one chunk of 20 steps on slab 4 (phi_hx .halo route) and one
     on pencil 2x2 (shard_x route), each held to 20 single-device steps
     (F32_SHARDED) and to 20 two-launch sharded steps bit for bit; on slab
     4 also 10 steps with phi_hx off (hartley_x .halo) and 10 with
     fft_method "fft" (plain-RHS .halo); every shard pass of these runs
     must be of the row-staged kernel (fused_pass_rows_kernel = the
     passes); each collide form, its fused pass (beside the two launches
     it replaces and the forced per-node pass, which must equal it bit for
     bit) and the stream timed by CUDA events on shard 0 and held to their
     plain versions there, the row product on shard 0's RHS rows too.
     Then the `pod` preset (BASELINE config 5, 512x256x257, f32, every
     field D3Q27, PB init with pb_omega 0.02): 50 steps on slab 4 and 50 on pencil 2x2 (re-sharded
     from the slab run's state), ms/step, MLUPS, per-launch, exchange and
     solve times, launch counts, peak memory;
  5c. the wider meshes at full width: `ek-pnp-thermal` f32 on pencil 2x3
     (192x256x257, the one cut NX 256 -> 192: shards 64x128x257 whose 128
     rows the solve cuts 43/43/42 over x), pencil 2x4 and slab 8
     (256x256x257: shards 64x128x257 and 256x32x257), each from a seeded
     make_state state of its size: one chunk of 20 steps after 20
     one-device steps on the route (the two one after the other), held
     to them (F32_SHARDED) and to 20 two-launch sharded steps bit for
     bit, the route's launches counted per chunk and shard (every pass
     row-staged); the route's forms timed on shard 0 beside their bounds
     and the per-node pass, held to their plain versions and to the
     per-node pass (bit for bit) on shard 0 and on the last shard (whose
     x-neighbours are two different shards on the pencils), exchange,
     solve, peak memory,
     ms/step from a second 20-step chunk (the first pays the mesh's first
     allocations);
  6b. the CLI with `--mesh slab --mesh-devices 4`, 10 steps, then `merge`:
     rc 0, a merged data.dat, finite series;
  6c. `run --distributed` through `python -m torch.distributed.run
     --standalone`: a world of one NCCL process driving 4 shards on the
     card (and, where there are 2+ cards, a world of min(4, cards)
     processes), each beside the same CLI run without --distributed:
     `ek-pnp-thermal` 256x256x257 f32, pb_omega 0.02, slab 4, 20 steps
     (series.csv byte for byte, the last per-process dump's fields bit for
     bit, the route's launches), then `reference` f64 with
     --checkpoint-full (series.csv, state_end.ckpt and the merged
     data_end.dat bit for bit); a compressed full-size checkpoint takes
     minutes of zlib a run, so the checkpoint is compared at reference
     size;
then the production run loop, through the entry points a user calls:
  a. the 1000-step reference experiment through the CLI, f64, perturbed
     first step, --checkpoint-full: the JAX package's pinned series tail
     (tests/test_production_run.py) at rtol 1e-8, 3 zones, six artifacts;
  b. the full-size CLI run: `run ek-pnp-thermal --steps 300 --set
     pb_omega=0.02 nsave=150 print_current=50` in its own process, one
     dump on the writer thread inside the loop, 3 zones of 256x256x257,
     after the same run with nsave=300 (no dump in the loop): rc 0,
     finite series, the route's launches, each MLUPS beside phase 5's loop
     MLUPS (the output is deleted once read);
  c. resume at reference size (fft route, whose chunks equal their steps
     bit for bit): f32 and f64 run(6) against run(3) + --checkpoint-full +
     --resume + run(3), exactly; a slab-4 state_end.ckpt resumed on
     pencil 2x2 against run(6) at rtol 1e-10 (f64); a --profile trace;
  d. `python -m ekpnp_torch bench` with its defaults and one line each of
     --mode poisson, pbinit and fluid: one JSON line each at 256^3, the
     headline within 10 % of phase 5's D3Q7 MLUPS and its all-D3Q27
     companion within 10 % of phase 5's all-D3Q27 MLUPS;
  e. step_diff on the card (f64, 8x4x9, 3 steps): the forward pass
     launches the kernels, the gradient equals the CPU's plain gradient at
     rtol 1e-10;
  7. one JSON line describing each CUDA kernel form;
  8. the final line {"ok": true, "device": {...}}.
Launch counts are zeroed before each main-path run and read after it: a
sharded run must show, per chunk and shard, one collide and one stream of
its route's forms and a fused pass for every other step, and none of any
other form; the CLI
zeroes them as its clock starts and prints them after it (a, b), the
benchmark puts those of its timed windows into its line (d).  Details
go to smoke_out/chip_smoke.json.
"""
import json
import os
import subprocess
import sys
import time

# tests/test_golden.py GOLDEN (test_torch_run.py keeps the two equal)
GOLDEN = {
    "umax": 5.187470428001874e-06,
    "current": 3.876682369403333e-18,
    "rho_mean": 1000.0000000000034,
    "charge_sum": 222.36470208917254,
    "chargen_sum": 187.76456959284795,
    "temp_mean": 0.4999999904026738,
    "phi_min": -0.0052574,
    "phi_max": -0.0006892896051530279,
    "uz_abs_sum": 0.02935283751694766,
}
# tests/test_production_run.py _PINNED_TAIL: step -> (umax_uz, umax_mag,
# current) of the 1000-step reference experiment (test_torch_run.py keeps
# the two equal)
PINNED_TAIL = {
    900: (5.199975618e-06, 3.227607422e-05, 3.876292858e-18),
    950: (5.200272947e-06, 3.250047060e-05, 3.876425318e-18),
    1000: (5.200554956e-06, 3.268748869e-05, 3.876603747e-18),
}
TOL = {"float64": 1e-12, "float32": 1e-5}
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
    "ref50": ("reference", dict()),
}
SOURCE = "ekpnp_torch/csrc/fused_step.cu"
# the TPU kernel each launch replaces: the pl.pallas_call of
# build_fused_step, and for the other forms the lines of the form (the
# halo inputs of halo=True, the pcol inputs of shard_x, the halo blocks
# the stream reads)
REPLACES = {
    "collide_kernel": "ekpnp/pallas/fused_step.py:1321",
    "collide_kernel.hartley_x": "ekpnp/pallas/fused_step.py:984",
    "collide_kernel.phi_hx": "ekpnp/pallas/fused_step.py:680",
    "fused_pass_kernel": "ekpnp/pallas/fused_step.py:1321",
    "fused_pass_kernel.hartley_x": "ekpnp/pallas/fused_step.py:984",
    "fused_pass_kernel.phi_hx": "ekpnp/pallas/fused_step.py:680",
    "hartley_rows_kernel": "ekpnp/pallas/fused_step.py:984",
    "stream_bc_kernel": "ekpnp/pallas/fused_step.py:1321",
    "collide_kernel.halo": "ekpnp/pallas/fused_step.py:516",
    "collide_kernel.hartley_x.halo": "ekpnp/pallas/fused_step.py:516",
    "collide_kernel.phi_hx.halo": "ekpnp/pallas/fused_step.py:516",
    "collide_kernel.shard_x": "ekpnp/pallas/fused_step.py:521",
    "stream_bc_kernel.halo": "ekpnp/pallas/fused_step.py:570",
    "fused_pass_kernel.halo": "ekpnp/pallas/fused_step.py:516",
    "fused_pass_kernel.hartley_x.halo": "ekpnp/pallas/fused_step.py:516",
    "fused_pass_kernel.phi_hx.halo": "ekpnp/pallas/fused_step.py:516",
    "fused_pass_kernel.shard_x": "ekpnp/pallas/fused_step.py:521",
    "hartley_rows_kernel.tf32x3": "ekpnp/pallas/fused_step.py:984",
    "fused_pass_rows_kernel": "ekpnp/pallas/fused_step.py:516",
}
# row products per step of each collide form (its collide or fused pass):
# the RHS (hartley_x); psi and the RHS (phi_hx), and on a slab shard psi's
# two halo rows
ROWS_PER_COLLIDE = {"collide_kernel.hartley_x": 1, "collide_kernel.phi_hx": 2,
                    "collide_kernel.hartley_x.halo": 1,
                    "collide_kernel.phi_hx.halo": 4}
# the sharded meshes of phase 3b: (shards, pencil)
MESHES = {"slab2": (2, False), "slab4": (4, False), "pencil2x2": (4, True)}
# phase 3b's shapes of the row-staged shard pass (fused_pass_rows_kernel):
# cases of CASES at NX 256, on slab 2 / slab 4 (shards 256 wide: tile
# 128, two segments a row), pencil 2x2 (128: one a row) and pencil 2x4
# (64: two rows a block)
ROWS_CASES = ("A", "C", "I", "F")
ROWS_MESHES = {"slab2": (2, False), "slab4": (4, False),
               "pencil2x2": (4, True), "pencil2x4": (8, True)}
# the shard passes that took the row-staged kernel count under both names
ROWS_PASS = "fused_pass_rows_kernel"
# phase 5c, ek-pnp-thermal at full width on the meshes of a 6- and an
# 8-card host: name -> (shards, pencil, preset overrides, the route's
# collide form).  The uneven pencil's one cut: NX 256 -> 192, the nearest
# multiple of 3; its shards' 128 rows go 43/43/42 over x in the solve.
WIDE = {"pencil2x3": (6, True, dict(nx=192), "collide_kernel.shard_x"),
        "pencil2x4": (8, True, {}, "collide_kernel.shard_x"),
        "slab8": (8, False, {}, "collide_kernel.phi_hx.halo")}
# f32 tolerance of a 20-step sharded run against the single-device run
# (max|d| / max|ref| per field): the distributed solve sums in another
# order than the single-device one, and the pencil takes the plain-RHS
# route where the single device takes phi_hx
F32_SHARDED = 1e-4
# the collide forms: (kernel, keyword arguments of fused_step.collide)
FORMS = (("collide_kernel", dict(hartley_x=False)),
         ("collide_kernel.hartley_x", dict(hartley_x=True)),
         ("collide_kernel.phi_hx", dict(phi_hx=True)))

# the row product's widths in phase 3: case J's, the collide cases', an odd
# one, the reference's, 256^3's and pod's
ROWS_NX = (10, 16, 25, 50, 256, 512)
# device-memory rate by card name (NVIDIA data sheets)
HBM_BW = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12), ("H200", 4.8e12),
          ("H100", 3.35e12))
PEAK = {"float32": 67e12, "float64": 34e12}  # H100 SXM, outside tensor cores
PEAK_TF32 = 495e12  # H100 SXM, TF32 dense on the tensor cores
# the row product's two forms: the FMA form's launches count under
# hartley_rows_kernel alone, the tensor-core form's under both names
ROWS_FMA, ROWS_TC = "hartley_rows_kernel", "hartley_rows_kernel.tf32x3"


def log(*a):
    print(*a, flush=True)


def fused_name(form, mesh=None):
    """The fused pass of a collide form; on a shard of `mesh` the pass's
    .halo / .shard_x form (a shard's collide without EK takes no halo and
    keeps the one-device name, its pass pulls across the shard's edges)."""
    name = form.replace("collide_kernel", "fused_pass_kernel")
    if mesh is not None and not name.endswith((".halo", ".shard_x")):
        name += ".shard_x" if mesh.pencil else ".halo"
    return name


def fmt_err(e):
    """An error as logged: 0 where it is exactly 0."""
    return "0" if e == 0 else f"{e:.1e}"


def rel_err(a, b):
    """max|a - b| / max|b| (0 where both are all zero)."""
    d = float((a - b).abs().max())
    r = float(b.abs().max())
    return d / r if r > 0 else d


def make_state(cfg, seed, device):
    """Equilibrium populations of a seeded macroscopic state plus 1e-3
    relative noise, and phi near `voltage`: the macroscopic fields from
    numpy, the equilibria (f64) and their noise (a torch.Generator of the
    same seed) on `device`, then in the config's type.  On the card, so
    that a 256^3 state takes seconds, not the host's minutes."""
    import numpy as np
    import torch

    from ekpnp_torch.device import resolve_device, torch_dtype
    from ekpnp_torch.init import state_from_macro
    from ekpnp_torch.ops.poisson import efield
    from ekpnp_torch.state import Macro, State

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    p = cfg.physics
    shape = cfg.grid.shape
    jit = lambda v, rel: v * (1.0 + rel * rng.standard_normal(shape))
    t = lambda a: torch.as_tensor(a, dtype=torch.float64).to(dev)
    z = np.arange(cfg.grid.nz)[:, None, None] / (cfg.grid.nz - 1)
    macro = Macro(rho=t(jit(p.rho0, 1e-4)),
                  u=t(1e-2 * rng.standard_normal((3,) + shape)),
                  charge=t(jit(p.charge0, 0.05)), chargen=t(jit(p.charge0n, 0.05)),
                  temp=t(p.TH * (1.0 - z) + 0.01 * rng.standard_normal(shape)))
    phi = t(jit(p.voltage, 0.05))
    pops = dict(zip(("f", "h", "hn", "g"), state_from_macro(
        cfg, macro, phi, efield(cfg, phi), 0.0)[:4]))
    del macro
    gen = torch.Generator(device=dev).manual_seed(seed)
    dtype = torch_dtype(cfg.run.dtype)
    for k, a in pops.items():  # f, h, hn, g: None where inactive
        if a is not None:
            pops[k] = (a * (1.0 + 1e-3 * torch.randn(
                a.shape, generator=gen, dtype=a.dtype, device=dev))).to(dtype)
            del a
    return State(**pops, phi=phi.to(dtype) if p.enable_ek else None,
                 t=torch.tensor(0.0, dtype=dtype, device=dev))


def phase_card():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else ""
    if not card:
        raise SystemExit(f"chip_smoke: nvidia-smi failed: {smi.stderr}")
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}")
    name = torch.cuda.get_device_name(0)
    bw = next((b for tag, b in HBM_BW if tag in name), None)
    if bw is None:
        bw = 3.35e12
        log(f"  unknown card {name!r}: bounds assume 3.35 TB/s")
    return card, bw


def phase_build():
    import re

    from ekpnp_torch.kernels import fused_step as fs

    t0 = time.perf_counter()
    fs._load()
    secs = time.perf_counter() - t0
    info = fs.build_info
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", info["log"])]
    spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores", info["log"])]
    # registers and spill stores per kernel (and the row product's vec
    # instantiation) and type, max over the lattice pairs
    fam, fam_spill, each = {}, {}, {}
    for name in re.findall(r"Compiling entry function '(\w+)'", info["log"]):
        m = re.search(r"(hartley_rows_tf32x3_kernel|hartley_rows_kernel|"
                      r"collide_kernel|fused_pass_kernel|"
                      r"fused_pass_halo_kernel|fused_pass_rows_kernel|"
                      r"stream_bc_halo_kernel|stream_bc_kernel)"
                      r"I([fd])(?:Li(\d+)ELi(\d+)E)?(?:Li(\d+)E)?"
                      r"(?:Lb([01])E)?", name)
        rest = info["log"][info["log"].index(name):]
        used = re.search(r"Used (\d+) registers", rest)
        spill = re.search(r"(\d+) bytes spill stores", rest)
        if m and used:
            # .vec: the row product's aligned form, the stream's 16-byte
            # one; .tw128 / .tw64: the row-staged shard pass's tiles
            vec = m.group(6) == "1" or int(m.group(5) or 1) > 1
            tag = (f".tw{m.group(5)}" if m.group(1) == ROWS_PASS
                   else ".vec" if vec else "")
            key = m.group(1) + tag + f" {m.group(2)}"
            r, sp = int(used.group(1)), int(spill.group(1)) if spill else 0
            fam[key] = max(fam.get(key, 0), r)
            fam_spill[key] = max(fam_spill.get(key, 0), sp)
            pair = f" {m.group(3)}/{m.group(4)}" if m.group(3) else ""
            each[key + pair] = (r, sp)
    log(f"build: {info['seconds']:.1f} s nvcc, {secs:.1f} s build+load; "
        f"{len(regs)} kernel instantiations, registers max {max(regs or [0])}, "
        f"spill stores max {max(spills or [0])} B; registers / spill stores "
        f"(B) by kernel: " + ", ".join(f"{k} {v}/{fam_spill[k]}"
                                       for k, v in sorted(fam.items())))
    tc = "hartley_rows_tf32x3_kernel f"
    if tc not in fam:
        raise SystemExit("chip_smoke: the build has no hartley_rows_tf32x3_kernel")
    for t in ("f", "d"):
        for tw in (128, 64):
            if f"{ROWS_PASS}.tw{tw} {t}" not in fam:
                raise SystemExit(f"chip_smoke: the build has no {ROWS_PASS} "
                                 f"at tile {tw} ({t})")
    log(f"  hartley_rows_tf32x3_kernel (the row product's tensor-core form, "
        f"f32): {fam[tc]} registers, {fam_spill[tc]} B spill stores; the FMA "
        f"form hartley_rows_kernel: " + ", ".join(
            f"{k.replace('hartley_rows_kernel', '').strip() or 'f'} "
            f"{fam[k]}/{fam_spill[k]}" for k in sorted(fam)
            if k.startswith("hartley_rows_kernel")))
    for fam_name in ("collide_kernel", "fused_pass_kernel",
                     "fused_pass_halo_kernel", ROWS_PASS + ".tw128",
                     ROWS_PASS + ".tw64", "stream_bc_kernel",
                     "stream_bc_kernel.vec"):
        log(f"  {fam_name} by type and lattice pair QF/QS: " + ", ".join(
            f"{k.replace(fam_name + ' ', '')} {r}/{sp}"
            for k, (r, sp) in sorted(each.items())
            if k.startswith(fam_name + " ")))
    return {"nvcc_s": info["seconds"], "load_s": secs,
            "registers_max": max(regs or [0]), "spill_max": max(spills or [0]),
            "registers": fam, "spill_stores": fam_spill,
            "instantiations": each, "ptxas": info["log"]}


def _form_inputs(cfg, ins, kw):
    """The collide inputs of a form: phi_hx takes psi_hx in place of phi."""
    from ekpnp_torch.ops.poisson import psi_hx_from_phi

    if kw.get("phi_hx"):
        return (*ins[:4], psi_hx_from_phi(cfg, ins[4]))
    return ins


def _forms(cfg):
    """The collide forms a config can take: plain RHS always, the x-Hartley
    forms where EK is on and the solve is the Hartley one."""
    hx = cfg.physics.enable_ek and cfg.run.fft_method != "fft"
    return FORMS if hx else FORMS[:1]


def rows_vs_plain():
    """The row product against its plain version on the card, f64 and f32,
    at every NX of ROWS_NX on 37 x 7 = 259 rows (two 128-row tiles and 3):
    lifted psi blocks (NZ, NY, NX) and halo rows (NZ, NX), plain RHS blocks
    (NZ-2, NY, NX), and a block one element off 16-byte alignment (the
    one-element cp.async path).  Each call's form is read from the launch
    counts: in f32 at NX 16, 256 and 512 the aligned blocks take the
    tensor-core form (hartley_rows_tf32x3_kernel) and are held again in the
    FMA form (hartley_rows_kernel, forced); f64, NX 10, 25 and 50 and the
    misaligned block take the FMA form.  Returns {(dtype, kernel): worst},
    the tensor-core form under hartley_rows_kernel.tf32x3."""
    import numpy as np
    import torch

    import ekpnp_torch
    from ekpnp_torch.kernels import fused_step as fs

    worst = {}
    nz, ny = 37, 7
    for dtype in ("float64", "float32"):
        for nx in ROWS_NX:
            cfg = ekpnp_torch.preset("reference", nx=nx, ny=ny, nz=nz,
                                     dtype=dtype)
            rng = np.random.default_rng(nx)
            t = lambda *shape: torch.as_tensor(
                rng.standard_normal(shape), dtype=getattr(torch, dtype),
                device="cuda")
            off = t(nz * ny * nx + 1)[1:].view(nz, ny, nx)
            errs = {ROWS_FMA: [], ROWS_TC: []}
            for a, lift in ((t(nz, ny, nx), cfg), (t(nz, nx), cfg),
                            (t(nz - 2, ny, nx), None), (off, cfg)):
                want = fs.hartley_rows_reference(a, lift=lift)
                tc = (dtype == "float32" and nx % 8 == 0
                      and a.data_ptr() % 16 == 0)
                before = fs.launches[ROWS_TC]
                errs[ROWS_TC if tc else ROWS_FMA].append(
                    rel_err(fs.hartley_rows(a, lift=lift), want))
                if fs.launches[ROWS_TC] - before != int(tc):
                    raise SystemExit(f"chip_smoke: row product {dtype} NX={nx}"
                                     f" {tuple(a.shape)}: tensor-core form "
                                     f"{not tc}, want {tc}")
                if tc:
                    errs[ROWS_FMA].append(rel_err(
                        fs.hartley_rows(a, lift=lift, fma=True), want))
            torch.cuda.synchronize()
            for k, e in errs.items():
                if not e:
                    continue
                worst[(dtype, k)] = max(worst.get((dtype, k), 0.0), *e)
                if max(e) > TOL[dtype]:
                    raise SystemExit(f"chip_smoke: {k} {dtype} NX={nx} rel "
                                     f"err {max(e):.3e} > {TOL[dtype]}")
            log(f"  row product {dtype} NX={nx:3d}: " + "; ".join(
                f"{'tensor-core' if k == ROWS_TC else 'FMA'} form "
                + " ".join(f"{x:.1e}" for x in e)
                for k, e in errs.items() if e))
    return worst


def odd_grid_vs_plain(worst):
    """The collide forms and the stream on grids whose node count is odd
    and NX no multiple of 2 (25x7x9: the collide's one-value staging, the
    stream's one-value path, which the cases' even grids leave to f32 at
    NX 10 and 50), the reference and zerograd-top with D3Q7 scalars, f64
    and f32, against their plain versions; `worst` takes the errors."""
    import ekpnp_torch
    from ekpnp_torch.kernels import fused_step as fs

    for dtype in ("float64", "float32"):
        for seed, ov in enumerate((dict(), dict(charge_bc="zerograd-top",
                                                scalar_lattice="D3Q7"))):
            cfg = ekpnp_torch.preset("reference", nx=25, ny=7, nz=9,
                                     dtype=dtype, **ov)
            st = make_state(cfg, seed=100 + seed, device="cuda")
            ins = (st.f, st.h, st.hn, st.g, st.phi)
            errs = {}
            for kname, kw in _forms(cfg):
                x = _form_inputs(cfg, ins, kw)
                kp = fs.collide(cfg, *x, **kw)
                errs[kname] = max(rel_err(a, b) for a, b in zip(
                    kp, fs.collide_reference(cfg, *x, **kw)) if b is not None)
                if kname == "collide_kernel":
                    errs["stream_bc_kernel"] = max(
                        rel_err(a, b) for a, b in zip(
                            fs.stream_bc(cfg, *kp[:4]),
                            fs.stream_bc_reference(cfg, *kp[:4]))
                        if b is not None)
            for lab, e in errs.items():
                if e > TOL[dtype]:
                    raise SystemExit(f"chip_smoke: 25x7x9 {dtype} {lab} rel "
                                     f"err {e:.3e} > {TOL[dtype]}")
                worst[(dtype, lab)] = max(worst.get((dtype, lab), 0.0), e)
            log(f"  25x7x9 {ov.get('charge_bc', 'noflux')} {dtype}: " + " ".join(
                f"{lab.replace('_kernel', '')} {fmt_err(e)}"
                for lab, e in errs.items()))


def phase_kernels_vs_plain():
    import torch

    import ekpnp_torch
    from ekpnp_torch.kernels import fused_step as fs
    from ekpnp_torch.ops.poisson import poisson_phi_from_rhs

    worst = rows_vs_plain()  # (dtype, kernel) -> max rel err
    odd_grid_vs_plain(worst)
    for dtype in ("float64", "float32"):
        for seed, (case, (name, ov)) in enumerate(CASES.items()):
            cfg = ekpnp_torch.preset(name, dtype=dtype, **ov)
            st = make_state(cfg, seed=seed, device="cuda")
            errs = {}
            for _ in range(3):
                ins = (st.f, st.h, st.hn, st.g, st.phi)
                for kname, kw in _forms(cfg):
                    x = _form_inputs(cfg, ins, kw)
                    kp = fs.collide(cfg, *x, **kw)
                    rp = fs.collide_reference(cfg, *x, **kw)
                    checks = [(kname, kp, rp)]
                    if kname == "collide_kernel":
                        ko = fs.stream_bc(cfg, *kp[:4])
                        ro = fs.stream_bc_reference(cfg, *kp[:4])
                        whole = fs.fused_step_reference(cfg, *x, **kw)
                        checks += [("stream_bc_kernel", ko, ro),
                                   ("step", (*ko, kp[4]), whole)]
                        plain, plain_out = kp, ko
                    # the fused pass of this form on the plain collide's
                    # post-collision set (the stream of this round and the
                    # collide of the next, with this round's phi / psi)
                    checks.append((
                        fused_name(kname),
                        fs.fused_pass(cfg, *plain[:4], x[4], **kw),
                        fs.fused_pass_reference(cfg, *plain[:4], x[4], **kw)))
                    for lab, ks, rs in checks:
                        for fld, a, b in zip(("f", "h", "hn", "g", "rhs"), ks, rs):
                            if b is None:
                                assert a is None, (case, lab, fld)
                                continue
                            e = rel_err(a, b)
                            errs[(lab, fld)] = max(errs.get((lab, fld), 0.0), e)
                phi = (poisson_phi_from_rhs(cfg, plain[4])
                       if plain[4] is not None else None)
                st = st._replace(f=plain_out[0], h=plain_out[1],
                                 hn=plain_out[2], g=plain_out[3], phi=phi)
            torch.cuda.synchronize()
            short = lambda lab: (lab.replace("_kernel", "")
                                 .replace("collide.", "")
                                 .replace("fused_pass", "pass"))
            by_lab = {}
            for (lab, _), e in errs.items():
                by_lab[lab] = max(by_lab.get(lab, 0.0), e)
            log(f"  case {case:8s} {dtype} (max over fields): " + " ".join(
                f"{short(lab)} {fmt_err(e)}" for lab, e in by_lab.items()))
            for (lab, fld), e in errs.items():
                if e > TOL[dtype]:
                    raise SystemExit(f"chip_smoke: {case} {dtype} {lab} {fld} "
                                     f"rel err {e:.3e} > {TOL[dtype]}")
                if lab != "step":
                    worst[(dtype, lab)] = max(worst.get((dtype, lab), 0.0), e)
    log("kernels vs plain (the row product, every collide form and fused "
        "pass): all cases within 1e-12 (f64) / 1e-5 (f32); f64 max "
        + ", ".join(f"{k} {fmt_err(v)}" for (d, k), v in sorted(worst.items())
                    if d == "float64"))
    return worst


def _golden_devs(cfg, state, label):
    """Relative deviations of a state's golden values; fails above 1e-9."""
    import torch

    from ekpnp_torch.diagnostics import ionic_current, umax
    from ekpnp_torch.ops.collide import compute_macro
    from ekpnp_torch.ops.poisson import efield

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
    devs = {k: abs(float(got[k]) / want - 1.0) for k, want in GOLDEN.items()}
    for k, e in devs.items():
        if e > 1e-9:
            raise SystemExit(f"chip_smoke: {label}: golden {k} = "
                             f"{float(got[k])!r}, want {GOLDEN[k]!r} "
                             f"(rel {e:.3e})")
    worst = max(devs.values())
    log(f"{label}: max rel dev {worst:.2e} ({max(devs, key=devs.get)})")
    return devs


def _tc(cfg):
    """Whether the config's row products take the tensor-core form: f32 and
    NX % 8 == 0 (the port's rows are contiguous tensors of their own, 16-byte
    aligned): every full-size f32 run."""
    return cfg.run.dtype == "float32" and cfg.grid.nx % 8 == 0


def _route(form, steps, chunks, stream="stream_bc_kernel", tc=False,
           rows=False):
    """The launches of `steps` steps of collide form `form` in `chunks`
    chunks and their row products: a collide and a stream per chunk and a
    fused pass of the form for every other step; with `tc` every row
    product of the tensor-core form.  On shards, steps and chunks count
    each shard's (steps x shards, chunks x shards), the stream is .halo
    and the pass the collide form's .halo / .shard_x; with `rows` every
    shard pass of the row-staged kernel (`_rows_path`)."""
    want = {form: chunks, stream: chunks}
    if steps > chunks:
        want[fused_name(form)] = steps - chunks
        if rows:
            want[ROWS_PASS] = steps - chunks
    if ROWS_PER_COLLIDE.get(form):
        want[ROWS_FMA] = ROWS_PER_COLLIDE[form] * steps
        if tc:
            want[ROWS_TC] = want[ROWS_FMA]
    return want


def _rows_path(cfg, mesh):
    """Whether the shard passes of `cfg` on `mesh` take the row-staged
    fused_pass_rows_kernel (the wrapper's rule by shape: every sharded
    tensor of the port is one of its own, 16-byte aligned)."""
    from ekpnp_torch.kernels.fused_step import shard_pass_tile
    from ekpnp_torch.parallel.mesh import local_cfg

    g = local_cfg(cfg, mesh).grid
    return shard_pass_tile(g.ny, g.nx) > 0


def _want_launches(counts, label, **want):
    """counts must be `want` and 0 for every other kernel form."""
    from ekpnp_torch.kernels.fused_step import KERNELS

    full = {k: 0 for k in KERNELS}
    full.update(want)
    if counts != full:
        raise SystemExit(f"chip_smoke: {label}: launches {counts}, want "
                         f"{full}: the path bypassed its kernel forms")


def phase_golden():
    import ekpnp_torch
    from ekpnp_torch.init import initialize
    from ekpnp_torch.kernels import fused_step as fs
    from ekpnp_torch.kernels.step import multi_step

    cfg = ekpnp_torch.preset("reference", dtype="float64")
    state, _ = initialize(cfg, device="cuda")
    fs.reset_launches()
    state = multi_step(cfg, state, 60)
    _want_launches(dict(fs.launches), "golden run (x-Hartley route)",
                   **_route("collide_kernel.phi_hx", 60, chunks=1))
    return _golden_devs(cfg, state,
                        "golden (reference, f64, 60 steps, phi_hx route)")


def _events_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _device_ms(fn, reps):
    """Device time of one call: the card sleeps first while the host queues
    the `reps` calls behind it, so the events time the kernels back to back,
    not the host's pace (a small row product's wrapper takes ~20-30 us on
    the host, more than its kernel)."""
    import torch

    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _ops_rows(nx, m):
    """Operations of the row product over m rows of nx values: a multiply
    and an add per term, nx terms per value."""
    return 2 * nx * m * nx


def _ops_collide(cfg, kname, halo=False):
    """Arithmetic of one collide form, counted from its function: per node
    and fluid direction ~4 (moments) + ~12 (feq, TRT) + ~20 (Guo); per
    scalar direction ~1 (moment) + ~12; ~60 for E, force and velocity.
    The x-Hartley forms add their row products: every interior RHS value,
    and for phi_hx every phi value once (NZ NY NX; on a slab shard, `halo`,
    also psi's two halo rows), whatever implements them."""
    g = cfg.grid
    p = cfg.physics
    nsc = ((2 if p.two_species else 1) if p.enable_ek else 0) + int(p.enable_thermal)
    ops = g.num_nodes * (36 * cfg.lattice.Q + 13 * nsc * cfg.scalar_lat.Q + 60)
    if kname != "collide_kernel":
        ops += _ops_rows(g.nx, (g.nz - 2) * g.ny)
    if kname == "collide_kernel.phi_hx":
        ops += _ops_rows(g.nx, g.nz * (g.ny + (2 if halo else 0)))
    return ops


def _design_bytes(kname, rhs, phi, halo_rows=0):
    """Bytes an x-Hartley form (composed) moves beyond its function's: each
    product writes and reads back its rows once more (the plain RHS; for
    phi_hx the decoded phi and a shard's halo rows)."""
    nb = lambda t: t.numel() * t.element_size()
    extra = 2 * nb(rhs)
    if "phi_hx" in kname:
        extra += 2 * nb(phi) + 2 * halo_rows * phi[:, 0].numel() * phi.element_size()
    return extra


def time_rows(rows, lift=None):
    """The row product on `rows` (NZ', NY, NX, f32) in both forms by CUDA
    events: the tensor-core form the wrapper takes (hartley_rows_tf32x3_kernel;
    fails if it took the other) and the FMA form (hartley_rows_kernel,
    forced), its plain version, and torch.matmul on the same (M, NX) rows
    and H (the library call; the lift, an add per row, left out); each
    one's max|d| / max|ref| against the f64 product of the same f32 values;
    the bytes of the bound (the rows read and written and H read once) and
    the operations of one product.  Fails if a form differs from the plain
    version by more than TOL."""
    import torch

    from ekpnp_torch.kernels import fused_step as fs
    from ekpnp_torch.ops.poisson import lifting_profile

    nx = rows.shape[-1]
    flat = rows.view(-1, nx)
    H = fs._cas(nx, rows)
    before = fs.launches[ROWS_TC]
    got = fs.hartley_rows(rows, lift=lift)
    if fs.launches[ROWS_TC] != before + 1:
        raise SystemExit(f"chip_smoke: the row product on {tuple(rows.shape)}"
                         f" did not take the tensor-core form")
    fma = fs.hartley_rows(rows, lift=lift, fma=True)
    want = fs.hartley_rows_reference(rows, lift=lift)
    mm = torch.matmul(flat, H).view(rows.shape)
    if lift is not None:
        mm = mm + lifting_profile(lift, rows.dtype, rows.device)
    ref64 = fs.hartley_rows_reference(rows.double(), lift=lift)
    dtype = str(rows.dtype).replace("torch.", "")
    res = dict(ms=_events_ms(lambda: fs.hartley_rows(rows, lift=lift), 10),
               ms_fma=_events_ms(
                   lambda: fs.hartley_rows(rows, lift=lift, fma=True), 10),
               plain_ms=_events_ms(
                   lambda: fs.hartley_rows_reference(rows, lift=lift), 10),
               library_ms=_events_ms(lambda: torch.matmul(flat, H), 10),
               device_ms={k: _device_ms(fn, 10) for k, fn in (
                   ("tf32x3", lambda: fs.hartley_rows(rows, lift=lift)),
                   ("fma", lambda: fs.hartley_rows(rows, lift=lift,
                                                   fma=True)),
                   ("matmul", lambda: torch.matmul(flat, H)))},
               rel_err=rel_err(got, want), rel_err_fma=rel_err(fma, want),
               abs_err=float((got - want).abs().max()),
               abs_err_fma=float((fma - want).abs().max()),
               err_vs_f64={k: rel_err(v.double(), ref64) for k, v in
                           (("tf32x3", got), ("fma", fma), ("matmul", mm),
                            ("plain", want))},
               bytes=(2 * rows.numel() * rows.element_size()
                      + H.numel() * H.element_size()),
               ops=_ops_rows(nx, flat.shape[0]), rows=flat.shape[0], nx=nx)
    del ref64, mm
    for k in ("rel_err", "rel_err_fma"):
        if res[k] > TOL[dtype]:
            raise SystemExit(f"chip_smoke: row product vs plain {k} "
                             f"{res[k]:.3e} on {tuple(rows.shape)}")
    return res


def _rows_keys(r):
    """The two forms' entries of time_rows' result: {kernel: (ms, rel err,
    abs err, operations, peak)}; the tensor-core form does three TF32
    products, bound against the TF32 rate."""
    return {ROWS_FMA: (r["ms_fma"], r["rel_err_fma"], r["abs_err_fma"],
                       r["ops"], PEAK["float32"]),
            ROWS_TC: (r["ms"], r["rel_err"], r["abs_err"], 3 * r["ops"],
                      PEAK_TF32)}


def _log_rows(label, r, bw):
    tb = r["bytes"] / bw * 1e3
    log(f"  row product, {label} ({r['rows']} rows x {r['nx']}): tensor-core "
        f"form {r['ms']:.4f} ms, FMA form {r['ms_fma']:.4f} ms, torch.matmul "
        f"{r['library_ms']:.4f} ms (device alone: " + ", ".join(
            f"{k} {v:.4f}" for k, v in r["device_ms"].items()) + "); bounds "
        f"TF32 x3 "
        f"{max(tb, 3 * r['ops'] / PEAK_TF32 * 1e3):.4f} / FP32 "
        f"{max(tb, r['ops'] / PEAK['float32'] * 1e3):.4f} (bytes {tb:.4f}); "
        f"max|d|/max|ref| vs the f64 product: " + ", ".join(
            f"{k} {v:.2e}" for k, v in r["err_vs_f64"].items()))


def _chunks(cfg, state, steps, every, run, label):
    """`run(cfg, state, n)` in chunks of `every` steps, a series point after
    each; returns (state, seconds per step of each chunk).  `state` may be
    a one-element list, which gives the state up: the caller then holds no
    reference to the donated first input (it would keep a population set
    alive through the run)."""
    import torch

    from ekpnp_torch.diagnostics import series_point

    if isinstance(state, list):
        state = state.pop()
    chunks, done = [], 0
    while done < steps:
        n = min(every, steps - done)
        t0 = time.perf_counter()
        state = run(cfg, state, n)
        torch.cuda.synchronize()
        chunks.append((time.perf_counter() - t0) / n)
        done += n
        um, umag, cur, mean_t, fin = (x.item() for x in series_point(cfg, state))
        log(f"  {label} step {done}: umax {um:.6g} |u|max {umag:.6g} "
            f"current {cur:.6g} <T> {mean_t:.6g} finite {fin}")
    return state, chunks


def _expect_launches(label, counts, form, steps, chunks, tc=False):
    """The run launched `form` and stream_bc_kernel once per chunk, the
    form's fused pass for every other step, the form's row products (with
    `tc`, all of the tensor-core form), and no other kernel form."""
    _want_launches(counts, label, **_route(form, steps, chunks, tc=tc))


def fused_vs_two_launch(cfg, state, steps):
    """max |d| over the fields between `steps` steps of the default
    multi_step (one chunk: a collide, fused passes, a stream) and as many
    two-launch steps (collide, stream) of the same route, step_fused_hx
    between one encode and one decode, from copies of `state`; fails
    unless 0."""
    from ekpnp_torch.kernels.step import multi_step, step_fused_hx
    from ekpnp_torch.ops.poisson import phi_from_psi_hx, psi_hx_from_phi

    a = multi_step(cfg, _clone(state), steps)
    b = _clone(state)
    b = b._replace(phi=psi_hx_from_phi(cfg, b.phi))
    for _ in range(steps):
        b = step_fused_hx(cfg, b)
    b = b._replace(phi=phi_from_psi_hx(cfg, b.phi))
    d = max(float((x - y).abs().max()) for x, y in zip(a[:5], b[:5])
            if x is not None)
    if d != 0:
        raise SystemExit(f"chip_smoke: {steps} fused-chunk steps differ from "
                         f"the two-launch steps by {d!r}")
    return d


def drive(label, cfg, make, steps, every, other_steps, bw):
    """One cell through the port's API: the default multi_step (the phi_hx
    route) for `steps` steps, then one chunk of `other_steps` with the
    other phi_hx setting (multi_step_rhs: hartley_x form, real phi between
    steps); counts zeroed just before each run and read just after.  Then
    20 steps of the fused chunk against 20 two-launch steps, and every
    collide form, the fused pass of every form, stream_bc, the row product
    (on the RHS rows; the decode on psi) and the solves are timed on the
    final state and held to their plain versions."""
    import torch

    from ekpnp_torch.diagnostics import check_finite, series_point
    from ekpnp_torch.kernels import fused_step as fs
    from ekpnp_torch.kernels.step import (multi_step, multi_step_rhs,
                                          phi_hx_capable)
    from ekpnp_torch.ops.poisson import (poisson_phi_from_rhs,
                                         poisson_psi_hx_from_rhs)
    from ekpnp_torch.parallel.fft import hartley_x_local

    if not phi_hx_capable(cfg):
        raise SystemExit(f"chip_smoke: {label}: not a phi_hx cell")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fs.reset_launches()
    t0 = time.perf_counter()
    start = [make()]
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    peak_init_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    state, chunks = _chunks(cfg, start, steps, every, multi_step, label)
    counts = dict(fs.launches)
    _expect_launches(label, counts, "collide_kernel.phi_hx", steps,
                     len(chunks), tc=_tc(cfg))
    fs.reset_launches()
    state, other = _chunks(cfg, state, other_steps, other_steps,
                           multi_step_rhs, label + " phi_hx off")
    counts_other = dict(fs.launches)
    _expect_launches(label + " phi_hx off", counts_other,
                     "collide_kernel.hartley_x", other_steps, len(other),
                     tc=_tc(cfg))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9  # the time loop's
    finite = check_finite(state)
    if not finite:
        raise SystemExit(f"chip_smoke: {label}: non-finite state")
    step_ms = chunks[-1] * 1e3
    step_ms_off = other[-1] * 1e3
    mlups = cfg.grid.num_nodes / (chunks[-1] * 1e6)
    chunk_d = fused_vs_two_launch(cfg, state, 20)
    log(f"  {label}: 20 steps, fused chunk vs two-launch steps: max |d| "
        f"{fmt_err(chunk_d)}")
    torch.cuda.empty_cache()

    # per-launch times (CUDA events), plain versions and the library x stage
    nb = lambda ts: sum(t.numel() * t.element_size() for t in ts if t is not None)
    ins = (state.f, state.h, state.hn, state.g, state.phi)
    H_bytes = cfg.grid.nx ** 2 * state.f.element_size()
    ms, plain_ms, lib_ms, errs, abs_errs, bytes_, ops = {}, {}, {}, {}, {}, {}, {}
    solve_ms, design_bytes, peak = {}, {}, {}
    for kname, kw in FORMS:
        x = _form_inputs(cfg, ins, kw)
        post = fs.collide(cfg, *x, **kw)
        ms[kname] = _events_ms(lambda: fs.collide(cfg, *x, post=post[:4], **kw), 10)
        ref = fs.collide_reference(cfg, *x, **kw)
        errs[kname] = max(rel_err(a, b) for a, b in zip(post, ref) if b is not None)
        abs_errs[kname] = max(float((a - b).abs().max())
                              for a, b in zip(post, ref) if b is not None)
        del ref
        plain_ms[kname] = _events_ms(lambda: fs.collide_reference(cfg, *x, **kw), 2)
        bytes_[kname] = nb(x) + nb(post) + (H_bytes if kname != "collide_kernel" else 0)
        ops[kname] = _ops_collide(cfg, kname)
        rhs = post[4]
        if kname in ROWS_PER_COLLIDE:
            design_bytes[kname] = bytes_[kname] + _design_bytes(kname, rhs, x[4])
        # the fused pass of the form on this post-collision set: the bytes
        # and operations of the collide's function
        fp = fused_name(kname)
        got = fs.fused_pass(cfg, *post[:4], x[4], **kw)
        ref = fs.fused_pass_reference(cfg, *post[:4], x[4], **kw)
        errs[fp] = max(rel_err(a, b) for a, b in zip(got, ref)
                       if b is not None)
        abs_errs[fp] = max(float((a - b).abs().max())
                           for a, b in zip(got, ref) if b is not None)
        del ref
        ms[fp] = _events_ms(lambda: fs.fused_pass(cfg, *post[:4], x[4],
                                                  out=got[:4], **kw), 10)
        del got
        bytes_[fp], ops[fp], lib_ms[fp] = bytes_[kname], ops[kname], None
        if kname in design_bytes:
            design_bytes[fp] = design_bytes[kname]
        plain_ms[fp] = _events_ms(
            lambda: fs.fused_pass_reference(cfg, *post[:4], x[4], **kw), 2)
        if kname == "collide_kernel":
            solve_ms["plain"] = _events_ms(lambda: poisson_phi_from_rhs(cfg, rhs), 10)
            lib_ms[kname] = None
            plain_rhs = rhs
        elif kname == "collide_kernel.hartley_x":
            solve_ms["rhs_hx"] = _events_ms(
                lambda: poisson_phi_from_rhs(cfg, rhs, rhs_hx=True), 10)
            solve_ms["psi_hx"] = _events_ms(
                lambda: poisson_psi_hx_from_rhs(cfg, rhs), 10)
            lib_ms[kname] = _events_ms(lambda: hartley_x_local(plain_rhs), 10)
            r = rows_rhs = time_rows(plain_rhs)  # the RHS rows, both forms
            for k, (t, e, ae, o, pk) in _rows_keys(r).items():
                ms[k], errs[k], abs_errs[k], ops[k], peak[k] = t, e, ae, o, pk
                plain_ms[k], lib_ms[k] = r["plain_ms"], r["library_ms"]
                bytes_[k] = r["bytes"]
        else:
            psi = x[4]
            lib_ms[kname] = _events_ms(lambda: hartley_x_local(psi), 10)
            decode = time_rows(psi, lift=cfg)  # and the decode of psi
        if kname == "collide_kernel":
            kout = fs.stream_bc(cfg, *post[:4])
            ms["stream_bc_kernel"] = _events_ms(
                lambda: fs.stream_bc(cfg, *post[:4], out=kout), 10)
            ref = fs.stream_bc_reference(cfg, *post[:4])
            errs["stream_bc_kernel"] = max(rel_err(a, b) for a, b in zip(kout, ref)
                                           if b is not None)
            abs_errs["stream_bc_kernel"] = max(float((a - b).abs().max())
                                               for a, b in zip(kout, ref) if b is not None)
            # its practical ceiling: device-to-device copies of the same
            # bytes (the set read once, written once; Tensor.copy_ a field)
            copy_ms = _events_ms(lambda: [a.copy_(b) for a, b in
                                          zip(kout, post[:4]) if b is not None],
                                 10)
            del ref, kout
            plain_ms["stream_bc_kernel"] = _events_ms(
                lambda: fs.stream_bc_reference(cfg, *post[:4]), 2)
            bytes_["stream_bc_kernel"] = 2 * nb(post[:4])
            ops["stream_bc_kernel"] = 0
            lib_ms["stream_bc_kernel"] = None
        del post, x
        torch.cuda.empty_cache()
    for k, e in errs.items():
        if e > TOL[cfg.run.dtype]:
            raise SystemExit(f"chip_smoke: {label}: {k} vs plain rel err {e:.3e}")

    bound, bound_design = {}, {}
    for k in ms:
        tb = bytes_[k] / bw * 1e3
        to = ops[k] / peak.get(k, PEAK[cfg.run.dtype]) * 1e3
        bound[k] = (max(tb, to), "bytes" if tb >= to else "operations")
        if k in design_bytes:  # the composed forms' own floor
            bound_design[k] = max(design_bytes[k] / bw * 1e3, to)
    two = {fused_name(k): ms[k] + ms["stream_bc_kernel"] for k, _ in FORMS}
    # one diagnostics event of the CLI (the plain PyTorch series point)
    series_ms = _events_ms(lambda: series_point(cfg, state), 3)
    res = dict(label=label, grid=list(cfg.grid.shape), dtype=cfg.run.dtype,
               scalars=cfg.scalar_lat.name, steps=steps, init_s=init_s,
               chunk_vs_two_launch=chunk_d, two_launch_ms=two,
               step_ms=step_ms, chunk_ms=[c * 1e3 for c in chunks], mlups=mlups,
               step_ms_phi_hx_off=step_ms_off, other_steps=other_steps,
               launches=counts, launches_phi_hx_off=counts_other,
               kernel_ms=ms, solve_ms=solve_ms, library_ms=lib_ms,
               plain_ms=plain_ms, bound_ms={k: v[0] for k, v in bound.items()},
               bound_by={k: v[1] for k, v in bound.items()},
               bound_design_ms=bound_design, rows_decode=decode,
               rows_rhs=rows_rhs,
               bytes=bytes_, ops=ops, rel_err=errs, abs_err=abs_errs,
               peak_gb=peak_gb, peak_init_gb=peak_init_gb, finite=finite,
               series_point_ms=series_ms, copy_ms=copy_ms)
    log(f"{label}: {mlups:.1f} MLUPS, {step_ms:.3f} ms/step (phi_hx route), "
        f"{step_ms_off:.3f} ms/step (phi_hx off: hartley_x form), init "
        f"{init_s:.2f} s, peak {peak_gb:.2f} GB in the time loop "
        f"({peak_init_gb:.2f} GB through the start state)")
    for k in ms:
        lib = f", library {lib_ms[k]:.3f}" if lib_ms.get(k) is not None else ""
        des = (f"; composed floor {bound_design[k]:.3f}"
               if k in bound_design else "")
        two_l = (f", the two launches it replaces {two[k]:.3f} ms"
                 if k in two else "")
        if k == "stream_bc_kernel":
            two_l = f", copy of the same bytes (Tensor.copy_) {copy_ms:.3f} ms"
        log(f"  {k}: {ms[k]:.3f} ms (bound {bound[k][0]:.3f}, {bound[k][1]}"
            f"{des}), plain {plain_ms[k]:.2f} ms{lib}{two_l}, rel err "
            f"{errs[k]:.2e}")
    _log_rows("the RHS rows", rows_rhs, bw)
    _log_rows("the psi decode, lifted", decode, bw)
    log("  solve: " + ", ".join(f"{k} {v:.3f} ms" for k, v in solve_ms.items())
        + f"; a series event (diagnostics.series_point) {series_ms:.3f} ms")
    return res, state


def drive_plain_rhs(label, cfg, state, steps, every):
    """The plain-RHS form's path: fft_method "fft" (the solve by torch.fft
    takes no x-Hartley RHS), default multi_step, counts zeroed just before;
    ms/step of the last chunk (the first one pays cuFFT's set-up)."""
    import torch

    from ekpnp_torch.diagnostics import check_finite
    from ekpnp_torch.kernels import fused_step as fs
    from ekpnp_torch.kernels.step import multi_step

    fs.reset_launches()
    state, chunks = _chunks(cfg, state, steps, every, multi_step, label)
    counts = dict(fs.launches)
    _expect_launches(label, counts, "collide_kernel", steps, len(chunks))
    if not check_finite(state):
        raise SystemExit(f"chip_smoke: {label}: non-finite state")
    torch.cuda.empty_cache()
    log(f"{label}: {chunks[-1] * 1e3:.3f} ms/step, launches {counts}")
    return dict(label=label, steps=steps, step_ms=chunks[-1] * 1e3,
                launches=counts)


def phase_main_path(bw):
    import dataclasses

    import torch

    import ekpnp_torch
    from ekpnp_torch.device import resolve_device
    from ekpnp_torch.init import initialize, state_from_macro
    from ekpnp_torch.state import Macro

    # The preset's PB relaxation factor (0.05, the reference's PB_omega)
    # diverges at NZ = 257 in both packages (the JAX package's pb_init gives
    # NaN there in f64 too); 0.02 converges within the 501 iterations.
    cfg = ekpnp_torch.preset("ek-pnp-thermal", pb_omega=0.02)
    start = {}

    def cold_start():
        state, _, res = initialize(cfg, device="cuda", with_residual=True)
        log(f"  ek-pnp-thermal PB init: {cfg.physics.pb_iters} iterations, "
            f"pb_omega {cfg.physics.pb_omega}, final relative update "
            f"{float(res):.3e}")
        # the sharded runs (phase 5b) start from a copy of this state
        start["state"] = _clone(state)
        return state

    full, state = drive("ek-pnp-thermal", cfg, cold_start, 100, 50, 50, bw)
    del state
    torch.cuda.empty_cache()

    # bench.py's headline: reference physics at 256x256x257, f32, D3Q7 scalars,
    # from the benchmark's uniform macroscopic state
    hcfg = ekpnp_torch.preset("reference", nx=256, ny=256, nz=257,
                              dtype="float32", fft_method="matmul",
                              scalar_lattice="D3Q7")

    def headline_state():
        kw = dict(dtype=torch.float32, device=resolve_device("cuda"))
        shape = hcfg.grid.shape
        macro = Macro(rho=torch.full(shape, 1000.0, **kw),
                      u=torch.zeros((3,) + shape, **kw),
                      charge=torch.full(shape, 0.01, **kw),
                      chargen=torch.full(shape, 0.01, **kw),
                      temp=torch.full(shape, 0.5, **kw))
        return state_from_macro(hcfg, macro, torch.zeros(shape, **kw),
                                torch.zeros((3,) + shape, **kw), 0.0)

    head, state = drive("headline-d3q7", hcfg, headline_state, 50, 50, 50, bw)
    fcfg = dataclasses.replace(hcfg, run=dataclasses.replace(hcfg.run,
                                                             fft_method="fft"))
    fft = drive_plain_rhs("headline-d3q7 fft", fcfg, state, 40, 20)
    del state
    torch.cuda.empty_cache()
    return full, head, fft, (cfg, start["state"])


def _clone(state):
    return state.__class__(*(None if a is None else a.clone() for a in state))

# ---------------------------------------------------------------------------
# the sharded time loop (ekpnp_torch/parallel), every shard on the one card
# ---------------------------------------------------------------------------

def _cuda_mesh(name):
    from ekpnp_torch.parallel.mesh import make_mesh

    n, pencil = MESHES[name] if name in MESHES else WIDE[name][:2]
    return make_mesh(["cuda"] * n, pencil=pencil)


def _shard_forms(cfg, mesh):
    """(kernel form, collide kwargs) of a sharded config: the plain RHS
    (.halo on a slab, .shard_x on a pencil; without EK the collide takes
    no halo); on a slab with EK and the Hartley solve also hartley_x and
    phi_hx (.halo)."""
    if not cfg.physics.enable_ek:
        return [("collide_kernel", dict(hartley_x=False))]
    if mesh.pencil:
        return [("collide_kernel.shard_x", dict(hartley_x=False))]
    forms = [("collide_kernel.halo", dict(hartley_x=False))]
    if cfg.run.fft_method != "fft":
        forms += [("collide_kernel.hartley_x.halo", dict(hartley_x=True)),
                  ("collide_kernel.phi_hx.halo", dict(phi_hx=True))]
    return forms


def _shard_inputs(cfg, mesh, state, kw):
    """Per shard the collide inputs (f, h, hn, g, phi) of a form and their
    PhiHalo: phi_hx takes psi_hx (encoded per shard) and its halo."""
    from ekpnp_torch.ops.poisson import psi_hx_from_phi
    from ekpnp_torch.parallel.halo import phi_halos
    from ekpnp_torch.parallel.mesh import shard

    phi = state.phi
    if phi is not None and kw.get("phi_hx"):
        phi = psi_hx_from_phi(cfg, phi, mesh)
    halos = phi_halos(mesh, phi) if phi is not None else [None] * mesh.size
    ins = [(*shard(state, i)[:4], None if phi is None else phi[i])
           for i in range(mesh.size)]
    return ins, halos


def _record(errs, label, got, want, names=("f", "h", "hn", "g", "rhs")):
    for fld, a, b in zip(names, got, want):
        if b is None:
            assert a is None, (label, fld)
            continue
        errs[(label, fld)] = max(errs.get((label, fld), 0.0), rel_err(a, b))


def _shard_steps(cfg, mesh, state, n):
    """n two-launch sharded steps (`step_halo`: a collide and a stream per
    step and shard) on the route make_halo_multi_step takes: phi_hx (one
    encode, the steps, one decode) where a slab shard can carry psi_hx,
    else real phi.  `state` is a sharded state, not donated."""
    from ekpnp_torch.kernels.step import phi_hx_capable
    from ekpnp_torch.ops.poisson import phi_from_psi_hx, psi_hx_from_phi
    from ekpnp_torch.parallel.halo import step_halo
    from ekpnp_torch.parallel.mesh import local_cfg

    hx = not mesh.pencil and phi_hx_capable(local_cfg(cfg, mesh))
    if hx:
        state = state._replace(phi=psi_hx_from_phi(cfg, state.phi, mesh))
    for _ in range(n):
        state = step_halo(cfg, mesh, state, phi_hx=hx)
    if hx:
        state = state._replace(phi=phi_from_psi_hx(cfg, state.phi, mesh))
    return state


def _shards_equal(a, b):
    """Whether two sharded states are equal bit for bit, shard by shard."""
    import torch

    for x, y in zip(a, b):
        if (x is None) != (y is None):
            return False
        if x is None:
            continue
        if torch.is_tensor(x):
            x, y = [x], [y]
        if not all(torch.equal(u, v) for u, v in zip(x, y)):
            return False
    return True


def phase_sharded_kernels_vs_plain():
    """3b: every sharded form against its plain version, per shard, on the
    meshes of MESHES: the collide forms, the stream, and the fused pass of
    every form on the collide's post-collision set with the exchanged edge
    rows (and a pencil's columns); then the sharded chunk against the
    single-device one, against as many two-launch sharded steps (bit for
    bit), and overlapped against serial."""
    import torch

    import ekpnp_torch
    from ekpnp_torch.kernels import fused_step as fs
    from ekpnp_torch.kernels.step import multi_step, multi_step_rhs
    from ekpnp_torch.parallel.halo import (make_halo_multi_step, post_edges,
                                           post_rows, step_halo)
    from ekpnp_torch.parallel.mesh import gather_state, local_cfg, shard_state

    worst = {}
    for dtype in ("float64", "float32"):
        for seed, (case, (name, ov)) in enumerate(CASES.items()):
            cfg = ekpnp_torch.preset(name, dtype=dtype, **ov)
            st = make_state(cfg, seed=seed, device="cuda")
            errs = {}
            for mname in MESHES:
                mesh = _cuda_mesh(mname)
                cfg_l = local_cfg(cfg, mesh)
                sh = shard_state(cfg, mesh, st)
                for _ in range(2):
                    for kname, kw in _shard_forms(cfg, mesh):
                        ins, halos = _shard_inputs(cfg, mesh, sh, kw)
                        posts = []
                        for x, h in zip(ins, halos):
                            k = fs.collide(cfg_l, *x, phi_halo=h, **kw)
                            _record(errs, kname, k, fs.collide_reference(
                                cfg_l, *x, phi_halo=h, **kw))
                            posts.append(k[:4])
                        # the pass of this form on the collide's set: the
                        # stream of this round and the collide of the next
                        for x, h, p, (r, c) in zip(ins, halos, posts,
                                                   post_edges(cfg_l, mesh,
                                                              posts)):
                            args = dict(rows=r, cols=c, phi_halo=h, **kw)
                            _record(errs, fused_name(kname, mesh),
                                    fs.fused_pass(cfg_l, *p, x[4], **args),
                                    fs.fused_pass_reference(cfg_l, *p, x[4],
                                                            **args))
                        if kw.get("hartley_x") is False:
                            for p, r in zip(posts, post_rows(cfg_l, mesh,
                                                             posts)):
                                _record(errs, "stream_bc_kernel.halo",
                                        fs.stream_bc(cfg_l, *p, rows=r),
                                        fs.stream_bc_reference(cfg_l, *p,
                                                               rows=r))
                    sh = step_halo(cfg, mesh, sh)
                # the whole chunk: against one device, against the
                # two-launch steps (bit for bit), and overlap vs serial
                single = multi_step_rhs if mesh.pencil else multi_step
                want = single(cfg, _clone(st), 3)
                runs = [make_halo_multi_step(cfg, mesh, 3, overlap=ov_)(
                    shard_state(cfg, mesh, st)) for ov_ in (True, False)]
                two = _shard_steps(cfg, mesh, shard_state(cfg, mesh, st), 3)
                if not _shards_equal(runs[0], two):
                    raise SystemExit(f"chip_smoke: {case} {dtype} {mname}: "
                                     f"the fused chunk != 3 two-launch steps")
                if not _shards_equal(runs[0], runs[1]):
                    raise SystemExit(f"chip_smoke: {case} {dtype} {mname}:"
                                     f" overlapped chunk != serial")
                _record(errs, f"chunk {mname}",
                        gather_state(mesh, runs[0])[:5], want[:5],
                        names=("f", "h", "hn", "g", "phi"))
            torch.cuda.synchronize()
            log(f"  sharded case {case:8s} {dtype}: " + " ".join(
                f"{lab.replace('_kernel', '')}"
                f":{f} {e:.1e}" for (lab, f), e in errs.items()
                if f in ("f", "rhs")))
            for (lab, fld), e in errs.items():
                if e > TOL[dtype]:
                    raise SystemExit(f"chip_smoke: sharded {case} {dtype} {lab}"
                                     f" {fld} rel err {e:.3e} > {TOL[dtype]}")
                worst[(dtype, lab)] = max(worst.get((dtype, lab), 0.0), e)
    log("sharded kernels vs plain (every collide form, stream and fused "
        "pass, slab 2 / slab 4 / pencil 2x2), chunks vs one device: within "
        "1e-12 (f64) / 1e-5 (f32); chunks = two-launch steps and overlapped "
        "= serial, bit for bit")
    for key, e in rows_pass_vs_plain().items():
        worst[key] = max(worst.get(key, 0.0), e)
    return worst


def rows_pass_vs_plain():
    """3b, the row-staged shard pass: ROWS_CASES at NX 256 (NY at least
    16) on ROWS_MESHES, f64 and f32, every pass form on every shard: the
    launch takes fused_pass_rows_kernel (counted), equals its plain
    version within TOL and the forced per-node fused_pass_halo_kernel bit
    for bit."""
    import torch

    import ekpnp_torch
    from ekpnp_torch.kernels import fused_step as fs
    from ekpnp_torch.parallel.halo import post_edges
    from ekpnp_torch.parallel.mesh import local_cfg, make_mesh, shard_state

    worst = {}
    for dtype in ("float64", "float32"):
        for seed, case in enumerate(ROWS_CASES):
            name, ov = CASES[case]
            cfg = ekpnp_torch.preset(name, dtype=dtype, **dict(
                ov, nx=256, ny=max(16, ov["ny"])))
            st = make_state(cfg, seed=40 + seed, device="cuda")
            for mname, (n, pencil) in ROWS_MESHES.items():
                mesh = make_mesh(["cuda"] * n, pencil=pencil)
                cfg_l = local_cfg(cfg, mesh)
                sh = shard_state(cfg, mesh, st)
                for kname, kw in _shard_forms(cfg, mesh):
                    ins, halos = _shard_inputs(cfg, mesh, sh, kw)
                    posts = [fs.collide(cfg_l, *x, phi_halo=h, **kw)[:4]
                             for x, h in zip(ins, halos)]
                    label = f"{case} {dtype} {mname} {fused_name(kname, mesh)}"
                    for x, h, p, (r, c) in zip(ins, halos, posts, post_edges(
                            cfg_l, mesh, posts)):
                        args = dict(rows=r, cols=c, phi_halo=h, **kw)
                        n0 = fs.launches[ROWS_PASS]
                        got = fs.fused_pass(cfg_l, *p, x[4], **args)
                        if fs.launches[ROWS_PASS] != n0 + 1:
                            raise SystemExit(f"chip_smoke: {label}: the pass "
                                             f"did not take {ROWS_PASS}")
                        pn = fs.fused_pass(cfg_l, *p, x[4], per_node=True,
                                           **args)
                        if not all(torch.equal(a, b) for a, b in zip(got, pn)
                                   if a is not None):
                            raise SystemExit(f"chip_smoke: {label}: the "
                                             f"row-staged pass != the "
                                             f"per-node pass")
                        e = max(rel_err(a, b) for a, b in zip(
                            got, fs.fused_pass_reference(cfg_l, *p, x[4],
                                                         **args))
                            if b is not None)
                        if e > TOL[dtype]:
                            raise SystemExit(f"chip_smoke: {label}: rel err "
                                             f"{e:.3e} > {TOL[dtype]}")
                        for k in (ROWS_PASS, fused_name(kname, mesh)):
                            worst[(dtype, k)] = max(worst.get((dtype, k), 0.0),
                                                    e)
                del sh
            del st
    torch.cuda.synchronize()
    log(f"(3b) the row-staged shard pass ({ROWS_PASS}), cases "
        f"{'/'.join(ROWS_CASES)} at NX 256 on {' / '.join(ROWS_MESHES)} "
        f"(tiles 128 and 64), every form and shard: = the per-node pass bit "
        f"for bit; vs plain max f64 {fmt_err(worst[('float64', ROWS_PASS)])}"
        f", f32 {fmt_err(worst[('float32', ROWS_PASS)])}")
    return worst


def phase_sharded_golden():
    """4b: the golden values through a slab-2 mesh (phi_hx route per
    shard: one chunk of 60 steps, a collide, 59 fused passes and a stream
    per shard)."""
    import ekpnp_torch
    from ekpnp_torch.init import initialize
    from ekpnp_torch.kernels import fused_step as fs
    from ekpnp_torch.parallel.mesh import (gather_state,
                                           make_sharded_multi_step,
                                           shard_state)

    cfg = ekpnp_torch.preset("reference", dtype="float64")
    mesh = _cuda_mesh("slab2")
    state = shard_state(cfg, mesh, initialize(cfg, device="cuda")[0])
    fs.reset_launches()
    state = make_sharded_multi_step(cfg, mesh, 60)(state)
    _want_launches(dict(fs.launches), "sharded golden run",
                   **_route("collide_kernel.phi_hx.halo", 120, 2,
                            "stream_bc_kernel.halo",
                            rows=_rows_path(cfg, mesh)))
    return _golden_devs(cfg, gather_state(mesh, state),
                        "golden through a slab-2 mesh (reference, f64, 60 "
                        "steps, phi_hx .halo route)")


def phase_empty_pieces():
    """3c: a mesh whose solve cuts an empty piece (ROADMAP fault 10):
    `reference` 4x8x9, f64, fft route (cuFFT), on slab 8, whose x stage
    cuts NX 4 over 8 shards (1/1/1/1/0/0/0/0): 2 sharded steps
    (make_halo_multi_step) equal 2 one-device steps at 1e-11
    (max|d| / max|ref| per field; the solve sums in another order)."""
    import ekpnp_torch
    from ekpnp_torch.kernels.step import multi_step
    from ekpnp_torch.parallel.halo import make_halo_multi_step
    from ekpnp_torch.parallel.mesh import gather_state, make_mesh, shard_state

    cfg = ekpnp_torch.preset("reference", nx=4, ny=8, nz=9, dtype="float64",
                             fft_method="fft")
    s0 = make_state(cfg, seed=70, device="cuda")
    want = multi_step(cfg, _clone(s0), 2)
    mesh = make_mesh(["cuda"] * 8)
    got = gather_state(mesh, make_halo_multi_step(cfg, mesh, 2)(
        shard_state(cfg, mesh, s0)))
    errs = {k: rel_err(getattr(got, k), getattr(want, k))
            for k in ("f", "h", "hn", "g", "phi")
            if getattr(want, k) is not None}
    if max(errs.values()) > 1e-11:
        raise SystemExit(f"chip_smoke: 4x8x9 slab 8 fft route: 2 sharded "
                         f"steps differ from one device: {errs}")
    log("(3c) reference 4x8x9 f64 on slab 8, fft route (cuFFT; empty x "
        "pieces): 2 sharded steps vs one device " + " ".join(
            f"{k} {fmt_err(e)}" for k, e in errs.items()))
    return errs


def _sharded_chunks(cfg, mesh, state, steps, every, label, **kw):
    """make_halo_multi_step in chunks of `every` steps, a series point after
    each; returns (state, seconds per step of each chunk)."""
    import torch

    from ekpnp_torch.diagnostics import series_point
    from ekpnp_torch.parallel.halo import make_halo_multi_step

    chunks, done = [], 0
    while done < steps:
        n = min(every, steps - done)
        t0 = time.perf_counter()
        state = make_halo_multi_step(cfg, mesh, n, **kw)(state)
        torch.cuda.synchronize()
        chunks.append((time.perf_counter() - t0) / n)
        done += n
        um, umag, cur, mean_t, fin = (x.item() for x in
                                      series_point(cfg, state, mesh))
        log(f"  {label} step {done}: umax {um:.6g} |u|max {umag:.6g} "
            f"current {cur:.6g} <T> {mean_t:.6g} finite {fin}")
        if not fin:
            raise SystemExit(f"chip_smoke: {label}: non-finite state")
    return state, chunks


def time_sharded(cfg, mesh, state, bw, route=None, also=None):
    """Per form on shard 0: CUDA-event time, bound, and the plain
    version's time and error (fails above TOL) of the collide form, the
    fused pass of the form (on the collide's set, with the exchanged edge
    rows and a pencil's columns) beside the two launches it replaces (the
    collide form and the stream), and the stream; on a slab the row product
    on shard 0's RHS rows; the exchange (phi halo + the pass's edges of
    every shard), the distributed solve of the route, and the pencil's
    column repair, all shards.  route: the one collide form to take (else
    every form of `_shard_forms`); the stream and the exchange run on the
    first form's set.  also: one more shard on which every form is held to
    its plain version (its error counts with shard 0's).  Where the shard
    passes take the row-staged kernel (`_rows_path`), each pass is also
    held to the forced per-node pass bit for bit (on `also` too) and the
    per-node pass timed beside it; the last pass form's numbers stand for
    fused_pass_rows_kernel."""
    import torch

    from ekpnp_torch.kernels import fused_step as fs
    from ekpnp_torch.ops.poisson import (poisson_phi_from_rhs,
                                         poisson_psi_hx_from_rhs)
    from ekpnp_torch.parallel.fft import hartley_x_local
    from ekpnp_torch.parallel.halo import (fix_x_columns, phi_halos,
                                           post_edges, post_rows)
    from ekpnp_torch.parallel.mesh import local_cfg

    cfg_l = local_cfg(cfg, mesh)
    nb = lambda ts: sum(t.numel() * t.element_size()
                        for t in ts if t is not None)
    res = dict(kernel_ms={}, plain_ms={}, library_ms={}, bound_ms={},
               bound_by={}, bound_design_ms={}, rel_err={}, abs_err={},
               other_ms={}, two_launch_ms={}, per_node_ms={})
    peak = PEAK[cfg.run.dtype]
    rows_path = _rows_path(cfg, mesh)

    def same_as_per_node(k, got, args):
        """the row-staged pass `got` against the forced per-node pass on
        the same inputs, bit for bit; returns the per-node outputs"""
        pn = fs.fused_pass(cfg_l, *args, per_node=True, **pk)
        if not all(torch.equal(a, b) for a, b in zip(got, pn)
                   if a is not None):
            raise SystemExit(f"chip_smoke: {k} on {cfg_l.grid.shape}: the "
                             f"row-staged pass != the per-node pass")
        return pn

    def bound(k, nbytes, ops, pk=None):
        tb, to = nbytes / bw * 1e3, ops / (pk or peak) * 1e3
        res["bound_ms"][k] = max(tb, to)
        res["bound_by"][k] = "bytes" if tb >= to else "operations"

    def check(k, got, want):
        pairs = [(a, b) for a, b in zip(got, want) if b is not None]
        res["rel_err"][k] = max(res["rel_err"].get(k, 0.0),
                                max(rel_err(a, b) for a, b in pairs))
        res["abs_err"][k] = max(res["abs_err"].get(k, 0.0), max(
            float((a - b).abs().max()) for a, b in pairs))
        if res["rel_err"][k] > TOL[cfg.run.dtype]:
            raise SystemExit(f"chip_smoke: sharded {k} vs plain rel err "
                             f"{res['rel_err'][k]:.3e}")

    passes = []
    forms = [(k, kw) for k, kw in _shard_forms(cfg, mesh)
             if route in (None, k)]
    if not forms:
        raise SystemExit(f"chip_smoke: no shard form {route} here")
    for kname, kw in forms:
        ins, halos = _shard_inputs(cfg, mesh, state, kw)
        x, h = ins[0], halos[0]
        posts = [fs.collide(cfg_l, *xi, phi_halo=hi, **kw)
                 for xi, hi in zip(ins, halos)]
        post = posts[0]
        res["kernel_ms"][kname] = _events_ms(
            lambda: fs.collide(cfg_l, *x, post=post[:4], phi_halo=h, **kw), 10)
        base = kname.replace(".halo", "").replace(".shard_x", "")
        ops = _ops_collide(cfg_l, base, halo=kname.endswith(".halo"))
        bound(kname, nb(x) + nb(h) + nb(post), ops)
        if base in ROWS_PER_COLLIDE:  # the composed forms' own floor
            res["bound_design_ms"][kname] = max(
                (nb(x) + nb(h) + nb(post)
                 + _design_bytes(kname, post[4], x[4], halo_rows=2)) / bw * 1e3,
                ops / peak * 1e3)
        res["library_ms"][kname] = (None if base == "collide_kernel" else
                                    _events_ms(lambda: hartley_x_local(
                                        x[4] if kw.get("phi_hx") else post[4]),
                                        10))
        check(kname, post, fs.collide_reference(cfg_l, *x, phi_halo=h, **kw))
        res["plain_ms"][kname] = _events_ms(
            lambda: fs.collide_reference(cfg_l, *x, phi_halo=h, **kw), 2)
        # the fused pass of the form on shard 0's post-collision set: the
        # bytes and operations of the collide's function and the edges
        fp = fused_name(kname, mesh)
        passes.append((fp, kname))
        rows, cols = post_edges(cfg_l, mesh, [p[:4] for p in posts])[0]
        pk = dict(rows=rows, cols=cols, phi_halo=h, **kw)
        got = fs.fused_pass(cfg_l, *post[:4], x[4], **pk)
        res["kernel_ms"][fp] = _events_ms(
            lambda: fs.fused_pass(cfg_l, *post[:4], x[4], out=got[:4], **pk),
            10)
        if rows_path:  # the per-node pass: the same bits, and its time
            pn = same_as_per_node(fp, got, (*post[:4], x[4]))
            res["per_node_ms"][fp] = _events_ms(
                lambda: fs.fused_pass(cfg_l, *post[:4], x[4], out=pn[:4],
                                      per_node=True, **pk), 10)
            del pn
        edges = [t for e in (rows, cols) if e for pair in e if pair
                 for t in pair]
        bound(fp, nb(x) + nb(h) + nb(post) + nb(edges), ops)
        if kname in res["bound_design_ms"]:
            res["bound_design_ms"][fp] = (res["bound_design_ms"][kname]
                                          + nb(edges) / bw * 1e3)
        res["library_ms"][fp] = None
        check(fp, got, fs.fused_pass_reference(cfg_l, *post[:4], x[4], **pk))
        res["plain_ms"][fp] = _events_ms(
            lambda: fs.fused_pass_reference(cfg_l, *post[:4], x[4], **pk), 2)
        del got, rows, cols, edges
        if also is not None:  # the collide and the pass on shard `also`
            xa, ha = ins[also], halos[also]
            check(kname, posts[also], fs.collide_reference(
                cfg_l, *xa, phi_halo=ha, **kw))
            rows, cols = post_edges(cfg_l, mesh, [p[:4] for p in posts])[also]
            pk = dict(rows=rows, cols=cols, phi_halo=ha, **kw)
            ga = fs.fused_pass(cfg_l, *posts[also][:4], xa[4], **pk)
            check(fp, ga, fs.fused_pass_reference(cfg_l, *posts[also][:4],
                                                  xa[4], **pk))
            if rows_path:
                same_as_per_node(fp, ga, (*posts[also][:4], xa[4]))
            del ga
            if not mesh.pencil and posts[also][4] is not None:
                ra = posts[also][4]
                for k, fma in ((ROWS_TC, False), (ROWS_FMA, True)):
                    check(k, [fs.hartley_rows(ra, fma=fma)],
                          [fs.hartley_rows_reference(ra)])
            del rows, cols
        if (not mesh.pencil and post[4] is not None
                and ROWS_FMA not in res["kernel_ms"]):
            # the row product, shard 0's RHS, both forms
            r = res["rows_rhs"] = time_rows(post[4])
            for k, (t, e, ae, o, pk) in _rows_keys(r).items():
                res["kernel_ms"][k], res["rel_err"][k] = t, e
                res["abs_err"][k] = ae
                res["plain_ms"][k] = r["plain_ms"]
                res["library_ms"][k] = r["library_ms"]
                bound(k, r["bytes"], o, pk)
        rhs = [p[4] for p in posts]
        if kw.get("phi_hx"):
            res["other_ms"]["solve psi_hx"] = _events_ms(
                lambda: poisson_psi_hx_from_rhs(cfg, rhs, mesh), 10)
        elif kw.get("hartley_x"):
            res["other_ms"]["solve rhs_hx"] = _events_ms(
                lambda: poisson_phi_from_rhs(cfg, rhs, mesh, rhs_hx=True), 10)
        elif rhs[0] is not None:
            res["other_ms"]["solve plain"] = _events_ms(
                lambda: poisson_phi_from_rhs(cfg, rhs, mesh), 10)
        if kname != forms[0][0]:
            del posts, post
            continue
        pops = [p[:4] for p in posts]
        rows = post_rows(cfg_l, mesh, pops)
        out = fs.stream_bc(cfg_l, *pops[0], rows=rows[0])
        k = "stream_bc_kernel.halo"
        res["kernel_ms"][k] = _events_ms(
            lambda: fs.stream_bc(cfg_l, *pops[0], out=out, rows=rows[0]), 10)
        bound(k, 2 * nb(pops[0]) + sum(nb(r) for r in rows[0] if r), 0)
        res["library_ms"][k] = None
        check(k, out, fs.stream_bc_reference(cfg_l, *pops[0], rows=rows[0]))
        if also is not None:
            check(k, fs.stream_bc(cfg_l, *pops[also], rows=rows[also]),
                  fs.stream_bc_reference(cfg_l, *pops[also], rows=rows[also]))
        res["plain_ms"][k] = _events_ms(
            lambda: fs.stream_bc_reference(cfg_l, *pops[0], rows=rows[0]), 2)
        phi = state.phi
        res["other_ms"]["exchange"] = _events_ms(
            lambda: (phi_halos(mesh, phi) if phi is not None else None,
                     post_edges(cfg_l, mesh, pops)), 10)
        edges = post_edges(cfg_l, mesh, pops)
        res["exchange_bytes"] = (
            sum(nb(hh) for hh in halos if hh is not None)
            + sum(nb([t]) for e in edges for part in e if part
                  for pair in part if pair for t in pair))
        if mesh.pencil:
            outs = [out] + [fs.stream_bc(cfg_l, *p, rows=r)
                            for p, r in zip(pops[1:], rows[1:])]
            res["other_ms"]["column fix"] = _events_ms(
                lambda: fix_x_columns(cfg_l, mesh, outs), 10)
            del outs
        del posts, post, pops, rows, out, edges
    for fp, kname in passes:  # the collide form and the stream it replaces
        res["two_launch_ms"][fp] = (res["kernel_ms"][kname]
                                    + res["kernel_ms"]["stream_bc_kernel.halo"])
    if rows_path:  # the row-staged kernel: the numbers of the last pass form
        fp = passes[-1][0]
        for part in res.values():
            if isinstance(part, dict) and fp in part:
                part[ROWS_PASS] = part[fp]
    torch.cuda.empty_cache()
    return res


def _log_sharded(label, res, ms_step, bw):
    for k, v in res["kernel_ms"].items():
        pl = (f", plain {res['plain_ms'][k]:.2f} ms, rel err "
              f"{res['rel_err'][k]:.2e}" if k in res["plain_ms"] else "")
        lib = (f", library {res['library_ms'][k]:.3f}"
               if res["library_ms"].get(k) is not None else "")
        des = (f"; composed floor {res['bound_design_ms'][k]:.3f}"
               if k in res["bound_design_ms"] else "")
        two = (f", the two launches it replaces "
               f"{res['two_launch_ms'][k]:.3f} ms"
               if k in res["two_launch_ms"] else "")
        if k in res["per_node_ms"]:
            two += (f", the per-node pass {res['per_node_ms'][k]:.3f} ms "
                    f"(same bits)")
        log(f"  {label} {k} (shard 0): {v:.3f} ms (bound "
            f"{res['bound_ms'][k]:.3f}, {res['bound_by'][k]}{des}){pl}{lib}"
            f"{two}")
    if "rows_rhs" in res:
        _log_rows(f"{label} shard 0's RHS rows", res["rows_rhs"], bw)
    log(f"  {label} all shards: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in res["other_ms"].items())
        + f"; exchange {res.get('exchange_bytes', 0) / 1e6:.1f} MB; "
        f"{ms_step:.3f} ms/step")


def phase_sharded_main(bw, start):
    """5b, ek-pnp-thermal: slab 4 and pencil 2x2 from phase 5's start
    state, one chunk of 20 steps each (per shard a collide, 19 fused passes
    and a stream), held to the single-device run and, bit for bit, to 20
    two-launch sharded steps; the slab's other routes."""
    import dataclasses

    import torch

    from ekpnp_torch.kernels import fused_step as fs
    from ekpnp_torch.kernels.step import multi_step
    from ekpnp_torch.parallel.mesh import gather_state, shard_state

    cfg, s0 = start
    steps = 20
    ref = multi_step(cfg, _clone(s0), steps)
    out = {}
    for mname, form in (("slab4", "collide_kernel.phi_hx.halo"),
                        ("pencil2x2", "collide_kernel.shard_x")):
        label = f"ek-pnp-thermal {mname}"
        mesh = _cuda_mesh(mname)
        sh = shard_state(cfg, mesh, s0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fs.reset_launches()
        sh, chunks = _sharded_chunks(cfg, mesh, sh, steps, steps, label)
        runs = [dict(fs.launches)]
        _want_launches(runs[0], label, **_route(form, steps * 4,
                                                len(chunks) * 4,
                                                "stream_bc_kernel.halo",
                                                tc=_tc(cfg), rows=True))
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        two = _shard_steps(cfg, mesh, shard_state(cfg, mesh, s0), steps)
        if not _shards_equal(sh, two):
            raise SystemExit(f"chip_smoke: {label}: {steps} fused-chunk "
                             f"steps differ from {steps} two-launch steps")
        del two
        log(f"{label}: {steps} fused-chunk steps vs {steps} two-launch "
            f"sharded steps: max |d| 0")
        got = gather_state(mesh, sh)
        errs = {k: rel_err(getattr(got, k), getattr(ref, k))
                for k in ("f", "h", "hn", "g", "phi")
                if getattr(ref, k) is not None}
        del got
        log(f"{label}: {steps} steps vs one device: " + " ".join(
            f"{k} {e:.1e}" for k, e in errs.items()))
        if max(errs.values()) > F32_SHARDED:
            raise SystemExit(f"chip_smoke: {label}: sharded run differs from "
                             f"the single-device run: {errs}")
        other = {}
        if not mesh.pencil:
            for sub, kw, scfg, sform in (
                    ("phi_hx off", dict(phi_hx=False), cfg,
                     "collide_kernel.hartley_x.halo"),
                    ("fft_method fft", {}, dataclasses.replace(
                        cfg, run=dataclasses.replace(cfg.run,
                                                     fft_method="fft")),
                     "collide_kernel.halo")):
                fs.reset_launches()
                sh, c = _sharded_chunks(scfg, mesh, sh, 10, 10,
                                        f"{label} {sub}", **kw)
                runs.append(dict(fs.launches))
                _want_launches(runs[-1], f"{label} {sub}",
                               **_route(sform, 40, len(c) * 4,
                                        "stream_bc_kernel.halo",
                                        tc=_tc(cfg), rows=True))
                other[sub] = c[-1] * 1e3
        res = time_sharded(cfg, mesh, sh, bw)
        ms_step = chunks[-1] * 1e3
        _log_sharded(label, res, ms_step, bw)
        log(f"{label}: {cfg.grid.num_nodes / (chunks[-1] * 1e6):.1f} MLUPS, "
            f"{ms_step:.3f} ms/step ({', '.join(f'{k} {v:.3f}' for k, v in other.items())}), "
            f"peak {peak_gb:.2f} GB")
        out[mname] = dict(res, label=label, steps=steps, step_ms=ms_step,
                          other_route_ms=other, launches=runs,
                          vs_single_device=errs, vs_two_launch=0.0,
                          peak_gb=peak_gb,
                          mlups=cfg.grid.num_nodes / (chunks[-1] * 1e6))
        del sh
        torch.cuda.empty_cache()
    return out


def phase_wide_meshes(bw):
    """5c: ek-pnp-thermal at full width on the meshes of WIDE, every shard
    on the one card, each from a make_state seeded state of its size (one
    for both 256-wide meshes): 20 one-device steps on the mesh's route
    (multi_step_rhs beside a pencil, multi_step beside the slab), then one
    chunk of 20 sharded steps from the same state, one after the other
    (held together they would take ~57 GB): the chunk within F32_SHARDED
    of the one-device steps and equal to 20 two-launch sharded steps bit
    for bit; per chunk and shard one collide, a pass for every other step
    and one stream of the route's forms, none of another; the route's
    forms timed on shard 0 and held to their plain versions there and on
    the last shard, the exchange and the solve timed; ms/step from a
    second chunk of 20 steps (its launches counted too)."""
    import torch

    import ekpnp_torch
    from ekpnp_torch.kernels import fused_step as fs
    from ekpnp_torch.kernels.step import multi_step, multi_step_rhs
    from ekpnp_torch.parallel.mesh import gather_state, shard_state

    steps = 20
    out, start = {}, {}
    for seed, (mname, (n, pencil, grid, form)) in enumerate(WIDE.items()):
        cfg = ekpnp_torch.preset("ek-pnp-thermal", pb_omega=0.02, **grid)
        label = f"ek-pnp-thermal {'x'.join(map(str, cfg.grid.shape[::-1]))} {mname}"
        key = cfg.grid.shape
        if key not in start:
            start.clear()
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            start[key] = make_state(cfg, seed=60 + seed, device="cuda")
            torch.cuda.synchronize()
            log(f"  {label}: make_state {time.perf_counter() - t0:.1f} s")
        s0 = start[key]
        single = multi_step_rhs if pencil else multi_step
        ref = single(cfg, _clone(s0), steps)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()  # the reference's second population set
        mesh = _cuda_mesh(mname)
        sh = shard_state(cfg, mesh, s0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fs.reset_launches()
        sh, chunks = _sharded_chunks(cfg, mesh, sh, steps, steps, label)
        counts = dict(fs.launches)
        _want_launches(counts, label, **_route(form, steps * n, len(chunks) * n,
                                               "stream_bc_kernel.halo",
                                               tc=_tc(cfg), rows=True))
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        two = _shard_steps(cfg, mesh, shard_state(cfg, mesh, s0), steps)
        if not _shards_equal(sh, two):
            raise SystemExit(f"chip_smoke: {label}: {steps} fused-chunk "
                             f"steps differ from {steps} two-launch steps")
        del two
        got = gather_state(mesh, sh)
        errs = {k: rel_err(getattr(got, k), getattr(ref, k))
                for k in ("f", "h", "hn", "g", "phi")
                if getattr(ref, k) is not None}
        del got, ref
        torch.cuda.empty_cache()
        log(f"{label}: {steps} fused-chunk steps = {steps} two-launch sharded "
            f"steps bit for bit; vs one device: " + " ".join(
                f"{k} {e:.1e}" for k, e in errs.items()))
        if max(errs.values()) > F32_SHARDED:
            raise SystemExit(f"chip_smoke: {label}: sharded run differs from "
                             f"the single-device run: {errs}")
        # a second chunk, timed warm (the first pays the mesh's first
        # allocations and solve shapes), its launches counted as well
        fs.reset_launches()
        sh, again = _sharded_chunks(cfg, mesh, sh, steps, steps,
                                    label + " again")
        counts2 = dict(fs.launches)
        _want_launches(counts2, label + " again", **_route(
            form, steps * n, len(again) * n, "stream_bc_kernel.halo",
            tc=_tc(cfg), rows=True))
        res = time_sharded(cfg, mesh, sh, bw, route=form, also=n - 1)
        ms_step = again[-1] * 1e3
        mlups = cfg.grid.num_nodes / (again[-1] * 1e6)
        _log_sharded(label, res, ms_step, bw)
        log(f"{label}: {mlups:.1f} MLUPS, {ms_step:.3f} ms/step (first "
            f"chunk {chunks[-1] * 1e3:.3f}), peak {peak_gb:.2f} GB, launches "
            f"{({k: v for k, v in counts.items() if v})} a chunk")
        out[mname] = dict(res, label=label, grid=list(cfg.grid.shape),
                          mesh=list(mesh.grid), steps=steps, step_ms=ms_step,
                          step_ms_first=chunks[-1] * 1e3, mlups=mlups,
                          launches=[counts, counts2],
                          vs_single_device=errs, vs_two_launch=0.0,
                          peak_gb=peak_gb)
        del sh
        torch.cuda.empty_cache()
    start.clear()
    torch.cuda.empty_cache()
    return out


def phase_pod(bw):
    """5b, the pod preset: 50 steps on slab 4, then (re-sharded) 50 on
    pencil 2x2, each in two chunks of 25."""
    import torch

    import ekpnp_torch
    from ekpnp_torch.init import initialize
    from ekpnp_torch.kernels import fused_step as fs
    from ekpnp_torch.parallel.mesh import gather_state, shard_state

    cfg = ekpnp_torch.preset("pod", pb_omega=0.02)
    t0 = time.perf_counter()
    state, _, res = initialize(cfg, device="cuda", with_residual=True)
    torch.cuda.synchronize()
    log(f"  pod PB init: {time.perf_counter() - t0:.2f} s, final relative "
        f"update {float(res):.3e}")
    out = {}
    for mname, form in (("slab4", "collide_kernel.phi_hx.halo"),
                        ("pencil2x2", "collide_kernel.shard_x")):
        label = f"pod {mname}"
        mesh = _cuda_mesh(mname)
        sh = shard_state(cfg, mesh, state)
        del state
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fs.reset_launches()
        sh, chunks = _sharded_chunks(cfg, mesh, sh, 50, 25, label)
        counts = dict(fs.launches)
        _want_launches(counts, label, **_route(form, 200, len(chunks) * 4,
                                               "stream_bc_kernel.halo",
                                               tc=_tc(cfg), rows=True))
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.empty_cache()
        res = time_sharded(cfg, mesh, sh, bw)
        ms_step = chunks[-1] * 1e3
        mlups = cfg.grid.num_nodes / (chunks[-1] * 1e6)
        _log_sharded(label, res, ms_step, bw)
        log(f"{label}: {mlups:.1f} MLUPS, {ms_step:.3f} ms/step, peak "
            f"{peak_gb:.2f} GB")
        out[mname] = dict(res, label=label, step_ms=ms_step, mlups=mlups,
                          chunk_ms=[c * 1e3 for c in chunks], launches=counts,
                          peak_gb=peak_gb)
        state = gather_state(mesh, sh)
        del sh
        torch.cuda.empty_cache()
    del state
    torch.cuda.empty_cache()
    return out


def phase_sharded_cli():
    """6b: the CLI on a slab-4 mesh on the card, then `merge`."""
    import math

    out = os.path.join("smoke_out", "cli_mesh")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    procs = [subprocess.run(
        [sys.executable, "-m", "ekpnp_torch", *args], cwd=here, env=env,
        capture_output=True, text=True, timeout=300) for args in (
            ["run", "reference", "--steps", "10", "--mesh", "slab",
             "--mesh-devices", "4", "--outdir", out],
            ["merge", "reference", out])]
    secs = time.perf_counter() - t0
    for p in procs:
        if p.returncode != 0:
            raise SystemExit(f"chip_smoke: CLI mesh run rc {p.returncode}:\n"
                             f"{p.stdout[-2000:]}\n{p.stderr[-2000:]}")
    if ("Iteration: 10" not in procs[0].stdout
            or "merged" not in procs[1].stdout):
        raise SystemExit(f"chip_smoke: CLI mesh run: {procs[0].stdout[-2000:]}"
                         f"\n{procs[1].stdout}")
    with open(os.path.join(out, "series.csv")) as fh:
        last = fh.read().splitlines()[-1].split(",")
    if not all(math.isfinite(float(v)) for v in last):
        raise SystemExit(f"chip_smoke: CLI mesh run: non-finite {last}")
    zones = open(os.path.join(out, "data.dat")).read().count("ZONE T=")
    log(f"CLI `run reference --steps 10 --mesh slab --mesh-devices 4` + "
        f"`merge`: rc 0 in {secs:.1f} s, {zones} merged zones, last series "
        f"row {last}")
    return dict(seconds=secs, last_row=last, zones=zones)


def phase_cli():
    """The CLI on the card with the perturbed first step (plain step on the
    card's tensors, then the kernel path): exit 0, finite series."""
    import math

    out = os.path.join("smoke_out", "cli_perturb")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "ekpnp_torch", "run", "reference", "--steps",
         "10", "--set", "perturb_first_step=true", "--outdir", out],
        cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
        capture_output=True, text=True, timeout=300)
    secs = time.perf_counter() - t0
    if proc.returncode != 0 or "Iteration: 10" not in proc.stdout:
        raise SystemExit(f"chip_smoke: CLI perturbed run rc {proc.returncode}:"
                         f"\n{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
    with open(os.path.join(out, "series.csv")) as fh:
        last = fh.read().splitlines()[-1].split(",")
    if not all(math.isfinite(float(v)) for v in last):
        raise SystemExit(f"chip_smoke: CLI perturbed run: non-finite {last}")
    log(f"CLI `run reference --steps 10 --set perturb_first_step=true`: rc 0 "
        f"in {secs:.1f} s, last series row {last}")
    return dict(seconds=secs, last_row=last)


def _group_run(argv, timeout, label):
    """argv in a process group of its own (a launcher and its workers), one
    torch thread each, its output captured; the whole group is killed at
    the timeout or once it has ended.  Fails the smoke unless it exits 0
    in time."""
    import contextlib
    import signal

    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(argv, cwd=os.path.dirname(os.path.abspath(
        __file__)), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        out = None
    finally:
        with contextlib.suppress(ProcessLookupError):
            os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
    if out is None:
        raise SystemExit(f"chip_smoke: {label}: no end within {timeout} s")
    if proc.returncode != 0:
        raise SystemExit(f"chip_smoke: {label}: rc {proc.returncode}:\n"
                         f"{out[-3000:]}")
    return out


def phase_distributed():
    """6c: `run --distributed` (one NCCL process per card) beside the same
    run without it, bit for bit: at full size the series, the last dump's
    fields and the route's launches; at reference size with
    --checkpoint-full also state_end.ckpt and the merged data_end.dat."""
    import numpy as np
    import torch

    import ekpnp_torch
    from ekpnp_torch.io.checkpoint import load_sharded
    from ekpnp_torch.io.fields import _assemble, list_dump_dirs
    from ekpnp_torch.kernels.fused_step import KERNELS

    count = torch.cuda.device_count()
    worlds = [1] + ([min(4, count)] if count >= 2 else [])
    log(f"(6c) run --distributed: worlds of {worlds} NCCL process(es), "
        f"{count} card(s) visible")
    sizes = {  # preset, flags, overrides, precision, nsave, print_current,
        # steps
        "full": ("ek-pnp-thermal", [], ["pb_omega=0.02"], "f32", 20, 10, 20),
        "small": ("reference", ["--checkpoint-full"], [], "f64", 5, 5, 10)}
    root = os.path.join("smoke_out", "distributed")
    res = dict(worlds=worlds, launches=[], seconds={})
    for size, (preset, flags, sets, prec, nsave, ncur, steps) in sizes.items():
        cfg = ekpnp_torch.preset(preset, dtype={"f32": "float32",
                                                "f64": "float64"}[prec])

        def cli(tag, launcher, extra, per):
            """The run, its rank 0's launches held to the route's for
            `per` shards a process."""
            out = os.path.join(root, f"{size}_{tag}")
            label = f"distributed {size}, {tag}"
            t0 = time.perf_counter()
            text = _group_run(
                [*launcher, "-m", "ekpnp_torch", "run", preset, *flags,
                 "--set", *sets, f"nsave={nsave}", f"print_current={ncur}",
                 "--steps", str(steps), "--precision", prec, "--mesh", "slab",
                 "--mesh-devices", "4", "--outdir", out, *extra], 600, label)
            res["seconds"][f"{size}_{tag}"] = time.perf_counter() - t0
            got = json.loads(text.split("kernel launches:")[1].splitlines()[0])
            counts = {k: got.get(k, 0) for k in KERNELS}
            _want_launches(counts, label, **_route(
                "collide_kernel.phi_hx.halo", (steps - 1) * per,
                _cli_chunks(steps, nsave, ncur) * per,
                "stream_bc_kernel.halo", tc=prec == "f32",
                rows=size == "full"))
            res["launches"].append(counts)
            return out, text

        ref, _ = cli("one", [sys.executable], [], 4)
        last = lambda d: _assemble(list_dump_dirs(d)[-1], cfg)
        want = last(ref)
        for w in worlds:
            out, text = cli(
                f"world{w}", [sys.executable, "-m", "torch.distributed.run",
                              "--standalone", "--nproc-per-node", str(w)],
                ["--distributed"], 4 // w)
            label = f"distributed {size}, world {w}"
            if f"in each of {w} processes (nccl)" not in text:
                raise SystemExit(f"chip_smoke: {label}: not over NCCL:\n"
                                 f"{text[-2000:]}")
            for name in ("series.csv", "umax.dat"):
                a, b = (open(os.path.join(d, name), "rb").read()
                        for d in (out, ref))
                if a != b or not a:
                    raise SystemExit(f"chip_smoke: {label}: {name} differs "
                                     f"from the one-process run")
            got = last(out)
            for k, x, y in [*zip(want[0]._fields, got[0], want[0]),
                            ("phi", got[1], want[1]), ("E", got[2], want[2]),
                            ("t", got[3], want[3])]:
                if not np.array_equal(x, y):
                    raise SystemExit(f"chip_smoke: {label}: dumped {k} "
                                     f"differs")
            if size == "small":
                ends = []
                for d in (out, ref):
                    _group_run([sys.executable, "-m", "ekpnp_torch", "merge",
                                "reference", "--precision", prec, d], 300,
                               f"merge {d}")
                    ends.append(open(os.path.join(d, "data_end.dat"),
                                     "rb").read())
                a, b = (load_sharded(os.path.join(d, "state_end.ckpt"), cfg,
                                     device="cpu") for d in (out, ref))
                same = all((x is None and y is None) or torch.equal(x, y)
                           for x, y in zip(a, b))
                if ends[0] != ends[1] or not same:
                    raise SystemExit(f"chip_smoke: {label}: merged "
                                     f"data_end.dat equal {ends[0] == ends[1]}"
                                     f", state_end.ckpt equal {same}")
            secs = res["seconds"]
            log(f"  {label}: series, last dump"
                + (", state_end.ckpt, merged data_end.dat" if size == "small"
                   else "")
                + f" bit for bit against one process; "
                f"{secs[f'{size}_world{w}']:.1f} s (one process "
                f"{secs[f'{size}_one']:.1f} s); rank 0's launches "
                f"{ {k: v for k, v in res['launches'][-1].items() if v} }")
    return res


# ---------------------------------------------------------------------------
# the production run loop: the CLI, resume, the benchmark entry, step_diff
# ---------------------------------------------------------------------------

def _cli(argv):
    """`python -m ekpnp_torch <argv>` in this process, its output captured:
    (rc, stdout + stderr).  The timed loop's launch counts are zeroed at
    its start (run.py) and read after it from fused_step.launches."""
    import contextlib
    import io

    from ekpnp_torch.run import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(buf):
        rc = cli_main(argv)
    return rc, buf.getvalue()


def _cli_chunks(nsteps, nsave, ncur, done=1):
    """The number of chunks of a CLI run's timed loop (run.py's cadence)."""
    from ekpnp_torch.run import _next_multiple

    n = 0
    while done < nsteps:
        done = min(_next_multiple(done, nsave, 0),
                   _next_multiple(done, ncur, 0), nsteps)
        n += 1
    return n


def _series_rows(path):
    import csv

    with open(path) as fh:
        return {int(r["step"]): r for r in csv.DictReader(fh)}


def _check_rows_finite(label, rows):
    import math

    for step, r in rows.items():
        if not all(math.isfinite(float(v)) for v in r.values()):
            raise SystemExit(f"chip_smoke: {label}: non-finite series row "
                             f"{step}: {r}")


def phase_anchor():
    """(a) The 1000-step reference experiment through the CLI on the card,
    f64, perturbed first step: the JAX package's pinned series tail at
    rtol 1e-8, 3 zones, the six artifacts; the timed loop's launches are
    the phi_hx route's."""
    from ekpnp_torch.kernels import fused_step as fs

    out = os.path.join("smoke_out", "anchor")
    t0 = time.perf_counter()
    rc, text = _cli(["run", "reference", "--steps", "1000", "--precision",
                     "f64", "--checkpoint-full", "--set",
                     "perturb_first_step=True", "--outdir", out])
    secs = time.perf_counter() - t0
    counts = dict(fs.launches)
    if rc != 0:
        raise SystemExit(f"chip_smoke: anchor run rc {rc}:\n{text[-3000:]}")
    for name in ("data.dat", "umax.dat", "series.csv", "data_end.npz",
                 "data_end.dat", "state_end.npz"):
        if not os.path.getsize(os.path.join(out, name)):
            raise SystemExit(f"chip_smoke: anchor run: empty {name}")
    with open(os.path.join(out, "data.dat")) as fh:
        zones = sum(1 for line in fh if line.startswith("ZONE"))
    if zones != 3:
        raise SystemExit(f"chip_smoke: anchor run: {zones} zones, want 3")
    rows = _series_rows(os.path.join(out, "series.csv"))
    devs = {}
    for step, want in PINNED_TAIL.items():
        got = [float(rows[step][k]) for k in ("umax_uz", "umax_mag", "current")]
        devs[step] = max(abs(g / w - 1.0) for g, w in zip(got, want))
        if devs[step] > 1e-8:
            raise SystemExit(f"chip_smoke: anchor run: step {step} {got}, "
                             f"want {want} (rel {devs[step]:.3e})")
    _want_launches(counts, "anchor run", **_route(
        "collide_kernel.phi_hx", 999, _cli_chunks(1000, 500, 50)))
    mlups = float(text.split("speed:")[1].split("(")[0])
    log(f"(a) anchor: `run reference --steps 1000 --precision f64 "
        f"--checkpoint-full --set perturb_first_step=True`: rc 0 in "
        f"{secs:.1f} s, {zones} zones, steps 900/950/1000 max rel dev "
        f"{max(devs.values()):.2e} (rtol 1e-8), {mlups} MLUPS")
    return dict(seconds=secs, rel_dev=devs, launches=counts, mlups=mlups)


def _cli_full(nsave):
    """`run ek-pnp-thermal --steps 300 --set pb_omega=0.02 nsave=<nsave>
    print_current=50` in its own process (f32, the phi_hx route), read and
    deleted: rc 0, a zone at 0, every in-loop dump and the end, a finite
    series, the route's launches in the timed loop."""
    import shutil

    from ekpnp_torch.kernels.fused_step import KERNELS

    out = os.path.join("smoke_out", "cli_full")
    free_gb = shutil.disk_usage(".").free / 1e9
    env = dict(os.environ, OMP_NUM_THREADS="1")
    label = f"full-size CLI run (nsave {nsave})"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "ekpnp_torch", "run", "ek-pnp-thermal",
         "--steps", "300", "--set", "pb_omega=0.02", f"nsave={nsave}",
         "print_current=50", "--outdir", out],
        cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
        capture_output=True, text=True, timeout=900)
    secs = time.perf_counter() - t0
    try:
        if proc.returncode != 0:
            raise SystemExit(f"chip_smoke: {label} rc {proc.returncode}:\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        zones = int(subprocess.run(
            ["grep", "-c", "^ZONE", os.path.join(out, "data.dat")],
            capture_output=True, text=True, timeout=300).stdout.strip() or 0)
        if zones != 2 + len(range(nsave, 300, nsave)):
            raise SystemExit(f"chip_smoke: {label}: {zones} zones")
        rows = _series_rows(os.path.join(out, "series.csv"))
        if sorted(rows) != [50, 100, 150, 200, 250, 300]:
            raise SystemExit(f"chip_smoke: {label}: rows {sorted(rows)}")
        _check_rows_finite(label, rows)
        text = proc.stdout
        counts = {k: 0 for k in KERNELS}
        counts.update(json.loads(text.split("kernel launches:")[1]
                                 .splitlines()[0]))
        _want_launches(counts, label, **_route(
            "collide_kernel.phi_hx", 299, _cli_chunks(300, nsave, 50),
            tc=True))
        res = dict(
            seconds=secs, zones=zones, launches=counts, free_gb=free_gb,
            mlups=float(text.split("speed:")[1].split("(")[0]),
            runtime_s=float(text.split("clock runtime:")[1].split("(")[0]),
            writer=text.split("writer thread:")[1].splitlines()[0].strip(),
            file_gb={n: os.path.getsize(os.path.join(out, n)) / 1e9
                     for n in ("data.dat", "data_end.dat", "data_end.npz")})
    finally:
        shutil.rmtree(out, ignore_errors=True)
    log(f"  {label}: rc 0 in {secs:.1f} s, {zones} zones, {res['mlups']} "
        f"MLUPS ({res['runtime_s']} s on the clock); writer thread: "
        f"{res['writer']}; files GB {res['file_gb']}, disk free before "
        f"{free_gb:.0f} GB")
    return res


def phase_cli_full(loop_mlups):
    """(b) The full-size CLI run: `run ek-pnp-thermal --steps 300 --set
    pb_omega=0.02 nsave=150 print_current=50` (one dump inside the loop on
    the writer thread, 3 zones of 256x256x257), after the same run with
    nsave=300 (no dump inside the loop): each MLUPS printed beside phase
    5's loop MLUPS.  The output (about 10 GB of text a run) is deleted once
    read."""
    quiet = _cli_full(300)
    res = _cli_full(150)
    log(f"(b) full-size CLI `run ek-pnp-thermal --steps 300 --set "
        f"pb_omega=0.02 nsave=150 print_current=50`: {res['mlups']} MLUPS "
        f"with one dump in the loop, {quiet['mlups']} with none (nsave=300), "
        f"against the loop's {loop_mlups:.1f} MLUPS (phase 5, no series "
        f"events)")
    res.update(loop_mlups=loop_mlups, no_dump=quiet)
    return res


def _full_npz(path):
    import numpy as np

    with np.load(path) as d:
        return {k: d[k] for k in d.files}


def phase_resume():
    """(c) Resume on the card, reference size, fft_method "fft" (chunks
    equal their steps bit for bit): f32 and f64, run(6) against run(3) +
    --checkpoint-full + --resume state_end.npz + run(3), exactly; f64, a
    slab-4 state_end.ckpt resumed on pencil 2x2 against run(6) at rtol
    1e-10 (the distributed solve's roundoff), the slab run with a
    sharded dump inside its loop."""
    import numpy as np

    import ekpnp_torch
    from ekpnp_torch.io import checkpoint as ckpt

    root = os.path.join("smoke_out", "resume")

    def run(tag, prec, steps, *extra, nsave=3, ncur=3):
        out = os.path.join(root, tag)
        rc, text = _cli(["run", "reference", "--steps", str(steps),
                         "--precision", prec, "--outdir", out, "--set",
                         "fft_method=fft", f"nsave={nsave}",
                         f"print_current={ncur}", "--checkpoint-full",
                         *extra])
        if rc != 0:
            raise SystemExit(f"chip_smoke: resume {tag}: rc {rc}:\n"
                             f"{text[-3000:]}")
        return out

    t0 = time.perf_counter()
    res = {}
    prof = os.path.join(root, "profile")
    for prec in ("f32", "f64"):
        six = run(f"{prec}_six", prec, 6,
                  *(["--profile", prof] if prec == "f64" else []))
        three = run(f"{prec}_three", prec, 3)
        back = run(f"{prec}_resumed", prec, 3, "--resume",
                   os.path.join(three, "state_end.npz"))
        a = _full_npz(os.path.join(six, "state_end.npz"))
        b = _full_npz(os.path.join(back, "state_end.npz"))
        d = max(float(np.abs(a[k].astype(np.float64) - b[k]).max())
                for k in a if k not in ("grid", "lattice_q"))
        if sorted(a) != sorted(b) or d != 0:
            raise SystemExit(f"chip_smoke: resume {prec}: resumed run differs "
                             f"from the uninterrupted one by {d!r}")
        res[prec] = d
    # a dump at step 2 and a series event every step: the writer thread
    # copies a sharded snapshot from the card
    slab = run("f64_three_slab4", "f64", 3, "--mesh", "slab",
               "--mesh-devices", "4", nsave=2, ncur=1)
    if not os.path.exists(os.path.join(slab, "fields_000002.shards",
                                       "shard_0.npz")):
        raise SystemExit("chip_smoke: the slab-4 run wrote no dump at step 2")
    pencil = run("f64_resumed_pencil2x2", "f64", 3, "--mesh", "pencil",
                 "--mesh-devices", "4", "--resume",
                 os.path.join(slab, "state_end.ckpt"))
    cfg = ekpnp_torch.preset("reference", dtype="float64")
    got = ckpt.load_sharded(os.path.join(pencil, "state_end.ckpt"), cfg,
                            device="cpu")
    want = _full_npz(os.path.join(root, "f64_six", "state_end.npz"))
    rel = 0.0
    for k, key in (("f", "f_pop"), ("h", "h_pop"), ("hn", "hn_pop"),
                   ("g", "g_pop"), ("phi", "phi"), ("t", "t")):
        w = want[key]
        e = float(np.abs(getattr(got, k).numpy() - w).max()
                  / max(float(np.abs(w).max()), 1e-300))
        rel = max(rel, e)
    if rel > 1e-10:
        raise SystemExit(f"chip_smoke: sharded resume slab 4 -> pencil 2x2: "
                         f"rel {rel:.3e} against the one-device run")
    res["slab4_to_pencil2x2_rel"] = rel
    with open(os.path.join(prof, "trace.json")) as fh:
        events = json.load(fh)["traceEvents"]
    res["profile_kernel_events"] = sum(1 for e in events
                                       if e.get("cat") == "kernel")
    secs = time.perf_counter() - t0
    log(f"(c) resume (reference, fft route, --checkpoint-full + --resume): "
        f"f32 and f64 max |d| {res['f32']!r} / {res['f64']!r} against the "
        f"uninterrupted run; slab 4 -> pencil 2x2 f64 rel {rel:.2e}; "
        f"--profile trace: {res['profile_kernel_events']} device kernel "
        f"events; {secs:.1f} s")
    res["seconds"] = secs
    return res


def phase_bench(head, full):
    """(d) `python -m ekpnp_torch bench` with its defaults, then one line
    each of --mode poisson, pbinit and fluid: one JSON line each at 256^3;
    the headline within 10 % of phase 5's D3Q7 default-route MLUPS, its
    all-D3Q27 companion within 10 % of phase 5's all-D3Q27 route."""
    from ekpnp_torch.kernels.fused_step import KERNELS

    env = dict(os.environ, OMP_NUM_THREADS="1")
    lines, secs = {}, {}
    for mode in ("coupled", "poisson", "pbinit", "fluid"):
        args = [] if mode == "coupled" else ["--mode", mode]
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "ekpnp_torch", "bench", *args],
            cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
            capture_output=True, text=True, timeout=900)
        secs[mode] = time.perf_counter() - t0
        js = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
        if proc.returncode != 0 or len(js) != 1:
            raise SystemExit(f"chip_smoke: bench {mode}: rc {proc.returncode}, "
                             f"{len(js)} JSON lines:\n{proc.stdout[-2000:]}\n"
                             f"{proc.stderr[-2000:]}")
        lines[mode] = json.loads(js[0])
        if "at 256^3" not in lines[mode]["metric"]:
            raise SystemExit(f"chip_smoke: bench {mode}: not at 256^3: "
                             f"{lines[mode]['metric']}")
        log(f"(d) bench {mode} ({secs[mode]:.1f} s): {js[0]}")
    c = lines["coupled"]
    for key, got, want in (("value", c["value"], head["mlups"]),
                           ("ref_parity_all_d3q27_mlups",
                            c["ref_parity_all_d3q27_mlups"], full["mlups"])):
        if abs(got / want - 1.0) > 0.10:
            raise SystemExit(f"chip_smoke: bench {key} {got} MLUPS is not "
                             f"within 10 % of phase 5's {want:.1f}")
    launches = {}
    for mode in ("coupled", "fluid"):
        launches[mode] = {k: 0 for k in KERNELS}
        launches[mode].update(lines[mode]["launches"])
    if not launches["coupled"]["fused_pass_kernel.phi_hx"]:
        raise SystemExit(f"chip_smoke: bench: the timed windows launched no "
                         f"fused pass: {launches['coupled']}")
    rows = launches["coupled"]
    if not rows[ROWS_FMA] or rows[ROWS_TC] != rows[ROWS_FMA]:
        raise SystemExit(f"chip_smoke: bench: row products {rows[ROWS_FMA]}, "
                         f"of the tensor-core form {rows[ROWS_TC]}")
    log(f"(d) bench headline {c['value']} MLUPS vs phase 5 D3Q7 "
        f"{head['mlups']:.1f}; parity {c['ref_parity_all_d3q27_mlups']} vs "
        f"phase 5 all-D3Q27 {full['mlups']:.1f}")
    return dict(lines=lines, seconds=secs, launches=launches)


def phase_step_diff():
    """(e) step_diff on the card, f64, 8x4x9, 3 steps: the forward pass
    launches the kernels, and the gradient of kinetic energy + charge
    second moment wrt the start charge equals the CPU's plain gradient
    (autograd through ekpnp_torch.step.step) at rtol 1e-10."""
    import numpy as np
    import torch

    import ekpnp_torch
    from ekpnp_torch.init import state_from_macro
    from ekpnp_torch.kernels import fused_step as fs
    from ekpnp_torch.kernels.step import step_diff
    from ekpnp_torch.ops.collide import compute_macro
    from ekpnp_torch.state import Macro
    from ekpnp_torch.step import step as plain_step

    cfg = ekpnp_torch.preset("reference", nx=8, ny=4, nz=9, dtype="float64",
                             fft_method="matmul")
    shape = cfg.grid.shape
    c0 = 0.01 + 1e-3 * np.random.default_rng(0).standard_normal(shape)

    def grad(device, step):
        kw = dict(dtype=torch.float64, device=device)
        x = torch.tensor(c0, requires_grad=True, **kw)
        macro = Macro(rho=torch.full(shape, 1000.0, **kw),
                      u=torch.zeros((3,) + shape, **kw), charge=x,
                      chargen=torch.full(shape, 0.01, **kw),
                      temp=torch.full(shape, 0.5, **kw))
        st = state_from_macro(cfg, macro, torch.zeros(shape, **kw),
                              torch.zeros((3,) + shape, **kw), 0.0)
        for _ in range(3):
            st = step(cfg, st)
        out, _ = compute_macro(cfg, st)
        loss = torch.sum(out.u ** 2) * 1e6 + torch.sum(out.charge ** 2)
        (g,) = torch.autograd.grad(loss, x)
        return loss.item(), g.cpu().numpy()

    fs.reset_launches()
    val, g = grad("cuda", step_diff)
    torch.cuda.synchronize()
    counts = dict(fs.launches)
    if not counts["collide_kernel.hartley_x"] or not counts["stream_bc_kernel"]:
        raise SystemExit(f"chip_smoke: step_diff launched no kernel: {counts}")
    val_p, g_p = grad("cpu", lambda c, s: plain_step(c, s)[0])
    rel = float(np.abs(g - g_p).max() / np.abs(g_p).max())
    if rel > 1e-10 or abs(val / val_p - 1.0) > 1e-10:
        raise SystemExit(f"chip_smoke: step_diff gradient rel {rel:.3e}, "
                         f"loss {val!r} vs {val_p!r}")
    log(f"(e) step_diff (f64, 8x4x9, 3 steps): gradient vs the CPU's plain "
        f"gradient max rel {rel:.2e}, launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    return dict(rel=rel, launches=counts)


def main():
    t_start = time.perf_counter()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    from ekpnp_torch.device import torch_setup
    from ekpnp_torch.kernels.fused_step import KERNELS

    card, bw = phase_card()
    torch_setup()
    report = dict(card=card, hbm_bw=bw, phase_s={})

    def run(phase, fn, *args):
        """fn(*args), its seconds logged."""
        t0 = time.perf_counter()
        out = fn(*args)
        report["phase_s"][phase] = time.perf_counter() - t0
        log(f"[phase {phase}: {report['phase_s'][phase]:.1f} s]")
        return out

    report["build"] = run("build", phase_build)
    worst = run("kernels", phase_kernels_vs_plain)
    report["worst_rel"] = [[*k, v] for k, v in worst.items()]
    report["golden_rel_dev"] = run("golden", phase_golden)
    worst_sh = run("sharded_kernels", phase_sharded_kernels_vs_plain)
    report["sharded_worst_rel"] = [[*k, v] for k, v in worst_sh.items()]
    report["sharded_golden_rel_dev"] = run("sharded_golden",
                                           phase_sharded_golden)
    report["empty_pieces"] = run("empty_pieces", phase_empty_pieces)
    full, head, fft, start = run("main", phase_main_path, bw)
    report["runs"] = [full, head, fft]
    report["sharded"] = run("sharded_main", phase_sharded_main, bw, start)
    del start
    report["wide"] = run("wide_meshes", phase_wide_meshes, bw)
    report["pod"] = run("pod", phase_pod, bw)
    report["cli"] = run("cli", phase_cli)
    report["sharded_cli"] = run("sharded_cli", phase_sharded_cli)
    report["distributed"] = run("distributed", phase_distributed)
    report["anchor"] = run("a_anchor", phase_anchor)
    report["cli_full"] = run("b_cli_full", phase_cli_full, full["mlups"])
    report["resume"] = run("c_resume", phase_resume)
    report["bench"] = run("d_bench", phase_bench, head, full)
    report["step_diff"] = run("e_step_diff", phase_step_diff)
    report["seconds"] = time.perf_counter() - t_start
    os.makedirs("smoke_out", exist_ok=True)
    sharded, pod = report["sharded"], report["pod"]
    runs = [c for r in (full, head) for c in
            (r["launches"], r["launches_phi_hx_off"])] + [fft["launches"]]
    runs += [c for m in sharded.values() for c in m["launches"]]
    runs += [m["launches"] for m in pod.values()]
    runs += [c for m in report["wide"].values() for c in m["launches"]]
    runs += report["distributed"]["launches"]
    runs += [report["anchor"]["launches"], report["cli_full"]["launches"],
             report["cli_full"]["no_dump"]["launches"],
             *report["bench"]["launches"].values(),
             report["step_diff"]["launches"]]
    kernels = []
    for k in KERNELS:
        row = {"name": k, "route": "cuda", "source": SOURCE,
               "replaces": REPLACES[k], "launches": sum(c[k] for c in runs)}
        if k in full["kernel_ms"]:  # single device: ek-pnp-thermal, D3Q7
            row.update(
                max_abs_err=max(full["abs_err"][k], head["abs_err"][k]),
                ms=full["kernel_ms"][k], plain_ms=full["plain_ms"][k],
                bound_ms=full["bound_ms"][k], bound_by=full["bound_by"][k],
                library_ms=full["library_ms"][k],
                max_err_f64=worst.get(("float64", k)),  # none: tf32x3
                max_err_f32=worst[("float32", k)],
                ms_d3q7=head["kernel_ms"][k],
                plain_ms_d3q7=head["plain_ms"][k],
                bound_ms_d3q7=head["bound_ms"][k],
                library_ms_d3q7=head["library_ms"][k])
            if k in full["bound_design_ms"]:  # the composed design's bytes
                row.update(bound_ms_design=full["bound_design_ms"][k],
                           bound_ms_design_d3q7=head["bound_design_ms"][k])
            if k in full["two_launch_ms"]:  # a fused pass
                row.update(two_launch_ms=full["two_launch_ms"][k],
                           two_launch_ms_d3q7=head["two_launch_ms"][k])
            if k == "stream_bc_kernel":  # its ceiling: a copy of its bytes
                row.update(copy_ms=full["copy_ms"],
                           copy_ms_d3q7=head["copy_ms"])
            if k in (ROWS_FMA, ROWS_TC):  # the RHS rows; decode, pod
                dec, pod_s = full["rows_decode"], pod["slab4"]
                form = "tf32x3" if k == ROWS_TC else "fma"
                row.update(ms_decode=dec["ms" if k == ROWS_TC else "ms_fma"],
                           library_ms_decode=dec["library_ms"],
                           plain_ms_decode=dec["plain_ms"],
                           device_ms=full["rows_rhs"]["device_ms"][form],
                           device_library_ms=full["rows_rhs"]["device_ms"][
                               "matmul"],
                           err_vs_f64=full["rows_rhs"]["err_vs_f64"][form],
                           library_err_vs_f64=full["rows_rhs"]["err_vs_f64"][
                               "matmul"],
                           ms_pod=pod_s["kernel_ms"][k],
                           library_ms_pod=pod_s["library_ms"][k],
                           bound_ms_pod=pod_s["bound_ms"][k])
                if "slab8" in report["wide"]:  # slab 8's shard 0 RHS rows
                    s8 = report["wide"]["slab8"]["rows_rhs"]
                    row.update(device_ms_slab8=s8["device_ms"][form],
                               device_library_ms_slab8=s8["device_ms"][
                                   "matmul"])
        else:  # sharded: ek-pnp-thermal shard 0, slab 4 or pencil 2x2
            mname = "pencil2x2" if "shard_x" in k else "slab4"
            cell = sharded[mname]
            row.update(
                max_abs_err=max(cell["abs_err"][k], pod[mname]["abs_err"][k]),
                ms=cell["kernel_ms"][k],
                plain_ms=cell["plain_ms"][k], bound_ms=cell["bound_ms"][k],
                bound_by=cell["bound_by"][k],
                library_ms=cell["library_ms"][k],
                max_err_f64=worst_sh[("float64", k)],
                max_err_f32=worst_sh[("float32", k)],
                shard=cell["label"], ms_pod=pod[mname]["kernel_ms"][k],
                plain_ms_pod=pod[mname]["plain_ms"][k],
                bound_ms_pod=pod[mname]["bound_ms"][k],
                rel_err_pod=pod[mname]["rel_err"][k])
            if k in cell["bound_design_ms"]:
                row.update(bound_ms_design=cell["bound_design_ms"][k],
                           bound_ms_design_pod=pod[mname]["bound_design_ms"][k])
            if k in cell["two_launch_ms"]:  # a shard's fused pass
                row.update(two_launch_ms=cell["two_launch_ms"][k],
                           two_launch_ms_pod=pod[mname]["two_launch_ms"][k])
            if k in cell["per_node_ms"]:  # the same pass, per-node kernel
                row.update(per_node_ms=cell["per_node_ms"][k],
                           per_node_ms_pod=pod[mname]["per_node_ms"][k])
        # phase 5c: shard 0 of each wider mesh whose route takes the form
        wide = {m: c for m, c in report["wide"].items() if k in c["kernel_ms"]}
        if wide:
            pn = {m: c["per_node_ms"][k] for m, c in wide.items()
                  if k in c["per_node_ms"]}
            if pn:
                row.update(per_node_ms_wide=pn)
            row.update(ms_wide={m: c["kernel_ms"][k] for m, c in wide.items()},
                       bound_ms_wide={m: c["bound_ms"][k]
                                      for m, c in wide.items()},
                       plain_ms_wide={m: c["plain_ms"][k]
                                      for m, c in wide.items()},
                       max_abs_err=max([row["max_abs_err"]] + [
                           c["abs_err"][k] for c in wide.values()]))
        kernels.append(row)
    report["kernels"] = kernels
    with open(os.path.join("smoke_out", "chip_smoke.json"), "w") as fh:
        json.dump(report, fh, indent=1, default=str)
    log(f"total {report['seconds']:.1f} s")
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
