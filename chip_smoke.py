#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`ekpnp_torch`) on one NVIDIA H100.

    python3 chip_smoke.py          # needs one CUDA device; run from the repo root

It drives the port only (no JAX, nothing of `ekpnp`) and fails, without
printing the final line, if any phase fails:

  1. card: name and power limit (nvidia-smi), torch and CUDA versions;
  2. build the fused step kernels from csrc/fused_step.cu (nvcc, sm_90a);
  3. kernels vs their plain PyTorch versions on the card, physics cases
     A-J and the reference's own 50x8x51, f64 and f32, 3 steps each:
     max|d|/max|ref| per field <= 1e-12 (f64) / 1e-5 (f32);
  4. golden: `reference`, f64, initialize + 60 steps through the kernels,
     the golden values of tests/test_golden.py at rtol 1e-9;
  5. main path at full size through the port's API: `ek-pnp-thermal`
     (256x256x257, f32, every field D3Q27): PB init (501 iterations, with
     pb_omega 0.02: the preset's 0.05 diverges at this NZ) + 100
     steps with a series point every 50; then the bench headline
     (256x256x257, f32, D3Q7 scalars) for 50 steps.  Launch counts are
     zeroed before each run and must equal the steps; the state must stay
     finite; each kernel is held to its plain version on that run's state;
  6. one JSON line describing each CUDA kernel;
  7. the final line {"ok": true, "device": {...}}.
Details go to smoke_out/chip_smoke.json.
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
REPLACES = "ekpnp/pallas/fused_step.py:1321"  # pl.pallas_call of build_fused_step
SOURCE = "ekpnp_torch/csrc/fused_step.cu"
# device-memory rate by card name (NVIDIA data sheets)
HBM_BW = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12), ("H200", 4.8e12),
          ("H100", 3.35e12))
PEAK = {"float32": 67e12, "float64": 34e12}  # H100 SXM, outside tensor cores


def log(*a):
    print(*a, flush=True)


def rel_err(a, b):
    """max|a - b| / max|b| (0 where both are all zero)."""
    d = float((a - b).abs().max())
    r = float(b.abs().max())
    return d / r if r > 0 else d


def make_state(cfg, seed, device):
    """Equilibrium populations of a seeded macroscopic state plus 1e-3
    relative noise, and phi near `voltage` (numpy, then onto the card)."""
    import numpy as np
    import torch

    from ekpnp_torch.convert import state_from_numpy
    from ekpnp_torch.init import state_from_macro
    from ekpnp_torch.ops.poisson import efield
    from ekpnp_torch.state import Macro

    rng = np.random.default_rng(seed)
    p = cfg.physics
    shape = cfg.grid.shape
    jit = lambda v, rel: v * (1.0 + rel * rng.standard_normal(shape))
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)
    z = np.arange(cfg.grid.nz)[:, None, None] / (cfg.grid.nz - 1)
    macro = Macro(rho=t(jit(p.rho0, 1e-4)),
                  u=t(1e-2 * rng.standard_normal((3,) + shape)),
                  charge=t(jit(p.charge0, 0.05)), chargen=t(jit(p.charge0n, 0.05)),
                  temp=t(p.TH * (1.0 - z) + 0.01 * rng.standard_normal(shape)))
    phi = t(jit(p.voltage, 0.05))
    st = state_from_macro(cfg, macro, phi, efield(cfg, phi), 0.0)
    arrays = {"t": 0.0}
    for k in ("f", "h", "hn", "g"):
        a = getattr(st, k).numpy() if getattr(st, k) is not None else None
        active = {"f": True, "h": p.enable_ek, "hn": p.enable_ek and p.two_species,
                  "g": p.enable_thermal}[k]
        arrays[k] = (a * (1.0 + 1e-3 * rng.standard_normal(a.shape))
                     if active else None)
    arrays["phi"] = phi.numpy() if p.enable_ek else None
    return state_from_numpy(cfg, arrays, device=device)


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
    log(f"build: {info['seconds']:.1f} s nvcc, {secs:.1f} s build+load; "
        f"{len(regs)} kernel instantiations, registers max {max(regs or [0])}, "
        f"spill stores max {max(spills or [0])} B")
    return {"nvcc_s": info["seconds"], "load_s": secs,
            "registers_max": max(regs or [0]), "spill_max": max(spills or [0]),
            "ptxas": info["log"]}


def phase_kernels_vs_plain():
    import torch

    import ekpnp_torch
    from ekpnp_torch.kernels import fused_step as fs
    from ekpnp_torch.ops.poisson import poisson_phi_from_rhs

    worst = {}  # (dtype, kernel) -> max rel err
    for dtype in ("float64", "float32"):
        for seed, (case, (name, ov)) in enumerate(CASES.items()):
            cfg = ekpnp_torch.preset(name, dtype=dtype, **ov)
            st = make_state(cfg, seed=seed, device="cuda")
            errs = {}
            for _ in range(3):
                ins = (st.f, st.h, st.hn, st.g, st.phi)
                kp = fs.collide(cfg, *ins)
                rp = fs.collide_reference(cfg, *ins)
                ko = fs.stream_bc(cfg, *kp[:4])
                ro = fs.stream_bc_reference(cfg, *kp[:4])
                whole = fs.fused_step_reference(cfg, *ins)
                for lab, ks, rs in (("collide", kp, rp), ("stream_bc", ko, ro),
                                    ("step", (*ko, kp[4]), whole)):
                    for fld, a, b in zip(("f", "h", "hn", "g", "rhs"), ks, rs):
                        if b is None:
                            assert a is None, (case, lab, fld)
                            continue
                        e = rel_err(a, b)
                        errs[(lab, fld)] = max(errs.get((lab, fld), 0.0), e)
                phi = poisson_phi_from_rhs(cfg, kp[4]) if kp[4] is not None else None
                st = st._replace(f=ko[0], h=ko[1], hn=ko[2], g=ko[3], phi=phi)
            torch.cuda.synchronize()
            step_errs = {f: e for (lab, f), e in errs.items() if lab == "step"}
            log(f"  case {case:8s} {dtype}: " + " ".join(
                f"{f} {e:.2e}" for f, e in step_errs.items()))
            for (lab, fld), e in errs.items():
                if e > TOL[dtype]:
                    raise SystemExit(f"chip_smoke: {case} {dtype} {lab} {fld} "
                                     f"rel err {e:.3e} > {TOL[dtype]}")
                if lab != "step":
                    key = (dtype, lab + "_kernel")
                    worst[key] = max(worst.get(key, 0.0), e)
    log("kernels vs plain: all cases within 1e-12 (f64) / 1e-5 (f32)")
    return worst


def phase_golden():
    import torch

    import ekpnp_torch
    from ekpnp_torch.diagnostics import ionic_current, umax
    from ekpnp_torch.init import initialize
    from ekpnp_torch.kernels import fused_step as fs
    from ekpnp_torch.kernels.step import multi_step
    from ekpnp_torch.ops.collide import compute_macro
    from ekpnp_torch.ops.poisson import efield

    cfg = ekpnp_torch.preset("reference", dtype="float64")
    before = fs.launches["collide_kernel"]
    state, _ = initialize(cfg, device="cuda")
    state = multi_step(cfg, state, 60)
    if fs.launches["collide_kernel"] - before != 60:
        raise SystemExit("chip_smoke: golden run did not go through the kernels")
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
    worst = 0.0
    for k, want in GOLDEN.items():
        e = abs(float(got[k]) / want - 1.0)
        worst = max(worst, e)
        if e > 1e-9:
            raise SystemExit(f"chip_smoke: golden {k} = {float(got[k])!r}, "
                             f"want {want!r} (rel {e:.3e})")
    log(f"golden (reference, f64, 60 kernel steps): max rel dev {worst:.2e}")
    return worst


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


def _ops_collide(cfg):
    """Arithmetic of collide_kernel per node, counted from its source:
    per fluid direction ~4 (moments) + ~12 (feq, TRT) + ~20 (Guo); per
    scalar direction ~1 (moment) + ~12; ~60 for E, force and velocity."""
    p = cfg.physics
    nsc = ((2 if p.two_species else 1) if p.enable_ek else 0) + int(p.enable_thermal)
    return cfg.grid.num_nodes * (36 * cfg.lattice.Q + 13 * nsc * cfg.scalar_lat.Q + 60)


def drive(label, cfg, make, steps, every, bw):
    """One main-path run through the port's API, counts zeroed just before."""
    import torch

    from ekpnp_torch.diagnostics import check_finite, series_point
    from ekpnp_torch.kernels import fused_step as fs
    from ekpnp_torch.kernels.step import multi_step
    from ekpnp_torch.ops.poisson import poisson_phi_from_rhs

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fs.reset_launches()
    t0 = time.perf_counter()
    state = make()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    chunks, done = [], 0
    while done < steps:
        n = min(every, steps - done)
        t0 = time.perf_counter()
        state = multi_step(cfg, state, n)
        torch.cuda.synchronize()
        chunks.append((time.perf_counter() - t0) / n)
        done += n
        um, umag, cur, mean_t, fin = (x.item() for x in series_point(cfg, state))
        log(f"  {label} step {done}: umax {um:.6g} |u|max {umag:.6g} "
            f"current {cur:.6g} <T> {mean_t:.6g} finite {fin}")
    counts = dict(fs.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    finite = check_finite(state)
    if not finite:
        raise SystemExit(f"chip_smoke: {label}: non-finite state")
    if any(counts[k] != steps for k in fs.KERNELS):
        raise SystemExit(f"chip_smoke: {label}: launches {counts} != {steps} "
                         f"steps each: the main path bypassed a kernel")
    step_ms = chunks[-1] * 1e3
    mlups = cfg.grid.num_nodes / (chunks[-1] * 1e6)

    # per-launch times (CUDA events) and the plain versions, on this state
    ins = (state.f, state.h, state.hn, state.g, state.phi)
    post = fs.collide(cfg, *ins)
    out = fs.stream_bc(cfg, *post[:4])
    ms = {"collide_kernel": _events_ms(lambda: fs.collide(cfg, *ins, post=post[:4]), 10),
          "stream_bc_kernel": _events_ms(lambda: fs.stream_bc(cfg, *post[:4], out=out), 10)}
    solve_ms = (_events_ms(lambda: poisson_phi_from_rhs(cfg, post[4]), 10)
                if post[4] is not None else 0.0)
    del out
    errs, abs_errs, plain_ms = {}, {}, {}
    ref = fs.collide_reference(cfg, *ins)
    errs["collide_kernel"] = max(rel_err(a, b) for a, b in zip(post, ref) if b is not None)
    abs_errs["collide_kernel"] = max(float((a - b).abs().max())
                                     for a, b in zip(post[:4], ref[:4]) if b is not None)
    rhs_abs = float((post[4] - ref[4]).abs().max()) if ref[4] is not None else 0.0
    del ref
    plain_ms["collide_kernel"] = _events_ms(lambda: fs.collide_reference(cfg, *ins), 2)
    kout = fs.stream_bc(cfg, *post[:4])
    ref = fs.stream_bc_reference(cfg, *post[:4])
    errs["stream_bc_kernel"] = max(rel_err(a, b) for a, b in zip(kout, ref) if b is not None)
    abs_errs["stream_bc_kernel"] = max(float((a - b).abs().max())
                                       for a, b in zip(kout, ref) if b is not None)
    del ref, kout
    plain_ms["stream_bc_kernel"] = _events_ms(lambda: fs.stream_bc_reference(cfg, *post[:4]), 2)
    for k, e in errs.items():
        if e > TOL[cfg.run.dtype]:
            raise SystemExit(f"chip_smoke: {label}: {k} vs plain rel err {e:.3e}")

    nb = lambda ts: sum(t.numel() * t.element_size() for t in ts if t is not None)
    bytes_ = {"collide_kernel": nb(ins) + nb(post),
              "stream_bc_kernel": 2 * nb(post[:4])}
    ops = {"collide_kernel": _ops_collide(cfg), "stream_bc_kernel": 0}
    bound = {}
    for k in fs.KERNELS:
        tb, to = bytes_[k] / bw * 1e3, ops[k] / PEAK[cfg.run.dtype] * 1e3
        bound[k] = (max(tb, to), "bytes" if tb >= to else "operations")
    res = dict(label=label, grid=list(cfg.grid.shape), dtype=cfg.run.dtype,
               scalars=cfg.scalar_lat.name, steps=steps, init_s=init_s,
               step_ms=step_ms, chunk_ms=[c * 1e3 for c in chunks], mlups=mlups,
               launches=counts, kernel_ms=ms, solve_ms=solve_ms,
               plain_ms=plain_ms, bound_ms={k: v[0] for k, v in bound.items()},
               bound_by={k: v[1] for k, v in bound.items()},
               bytes=bytes_, ops=ops, rel_err=errs, abs_err=abs_errs,
               rhs_abs_err=rhs_abs, peak_gb=peak_gb, finite=finite)
    log(f"{label}: {mlups:.1f} MLUPS, {step_ms:.3f} ms/step, init {init_s:.2f} s, "
        f"collide {ms['collide_kernel']:.3f} ms (bound {bound['collide_kernel'][0]:.3f}), "
        f"stream_bc {ms['stream_bc_kernel']:.3f} ms (bound "
        f"{bound['stream_bc_kernel'][0]:.3f}), solve {solve_ms:.3f} ms, "
        f"launches {counts}, finite {finite}, peak {peak_gb:.2f} GB")
    log(f"  plain: collide {plain_ms['collide_kernel']:.2f} ms, stream_bc "
        f"{plain_ms['stream_bc_kernel']:.2f} ms; kernel vs plain rel err "
        f"{errs['collide_kernel']:.2e} / {errs['stream_bc_kernel']:.2e}")
    return res


def phase_main_path(bw):
    import torch

    import ekpnp_torch
    from ekpnp_torch.device import resolve_device
    from ekpnp_torch.init import initialize, state_from_macro
    from ekpnp_torch.state import Macro

    # The preset's PB relaxation factor (0.05, the reference's PB_omega)
    # diverges at NZ = 257 in both packages (the JAX package's pb_init gives
    # NaN there in f64 too); 0.02 converges within the 501 iterations.
    cfg = ekpnp_torch.preset("ek-pnp-thermal", pb_omega=0.02)

    def cold_start():
        state, _, res = initialize(cfg, device="cuda", with_residual=True)
        log(f"  ek-pnp-thermal PB init: {cfg.physics.pb_iters} iterations, "
            f"pb_omega {cfg.physics.pb_omega}, final relative update "
            f"{float(res):.3e}")
        return state

    full = drive("ek-pnp-thermal", cfg, cold_start, 100, 50, bw)
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

    head = drive("headline-d3q7", hcfg, headline_state, 50, 50, bw)
    torch.cuda.empty_cache()
    return full, head


def main():
    t_start = time.perf_counter()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    from ekpnp_torch.device import torch_setup
    from ekpnp_torch.kernels.fused_step import KERNELS

    card, bw = phase_card()

    torch_setup()
    build = phase_build()
    worst = phase_kernels_vs_plain()
    golden = phase_golden()
    full, head = phase_main_path(bw)

    kernels = []
    for k in KERNELS:
        kernels.append({
            "name": k, "route": "cuda", "source": SOURCE, "replaces": REPLACES,
            "launches": full["launches"][k] + head["launches"][k],
            "max_abs_err": max(full["abs_err"][k], head["abs_err"][k]),
            "ms": full["kernel_ms"][k], "plain_ms": full["plain_ms"][k],
            "bound_ms": full["bound_ms"][k], "bound_by": full["bound_by"][k],
            "library_ms": None,
            "max_err_f64": worst[("float64", k)],
            "max_err_f32": worst[("float32", k)],
            "ms_d3q7": head["kernel_ms"][k], "plain_ms_d3q7": head["plain_ms"][k],
            "bound_ms_d3q7": head["bound_ms"][k],
        })
    report = dict(card=card, hbm_bw=bw, build=build, golden_max_rel=golden,
                  worst_rel=[[*k, v] for k, v in worst.items()],
                  runs=[full, head], kernels=kernels,
                  seconds=time.perf_counter() - t_start)
    os.makedirs("smoke_out", exist_ok=True)
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
