"""Benchmark of the port (port of ekpnp/benchmark.py); prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "MLUPS", "vs_baseline": N, ...}

    python -m ekpnp_torch bench [--mode coupled|fluid|poisson|pbinit]
                                [--size N] [--steps N] [--reps N]
                                [--dtype float32|float64]
                                [--scalar-lattice D3Q7|same]
                                [--no-parity-run] [--device cuda|cpu]

coupled (default): the full coupled EK-PNP-thermal step of the port's
time loop (kernels/step.py multi_step: the CUDA kernels on the card), at
256^3 (grid 256x256x257) in f32 from a uniform macroscopic state, D3Q7
scalars; the size steps down (192, 128, 96, 64) only on an out-of-memory
error.  fluid: the fluid alone.  poisson: the spectral solve alone
(ms/step).  pbinit: the 501-iteration PB cold start (s).

The judged value is the median of --reps timed windows of --steps steps
each, with "spread" ((max - min) / median) and "windows"; coupled mode
adds "poisson_ms", the solve alone, and on the card "launches", the kernel
launches of the timed windows.  The coupled D3Q7 line also carries
the reference-parity companion (every field on D3Q27), measured in a
subprocess after the headline state is released (`--scalar-lattice same
--no-parity-run`), as "ref_parity_*".

vs_baseline = MLUPS / (device-memory rate / bytes per node), with the
JAX package's bytes per node (kept so that the two lines compare):
  coupled  (Q_f + 3 Q_s) x 2 x itemsize + 48 + 128
  fluid    Q_f x 2 x itemsize
That is 1040 B all-D3Q27 and 560 B with D3Q7 scalars in f32.  The rate
comes from the card's name (`_hbm_bandwidth`; EKPNP_HBM_BW overrides it);
an unknown card raises.  On the CPU vs_baseline is null: a CPU has no such
rate.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

# device-memory rate by card name (NVIDIA data sheets): the first tag the
# name holds wins
_HBM_BW = ((("H100", "PCIe"), 2.0e12), (("H100", "NVL"), 3.9e12),
           (("H100", "HBM3"), 3.35e12))


def _hbm_bandwidth(name: str) -> float:
    """Peak device-memory rate [B/s] of the card `name`
    (torch.cuda.get_device_name); EKPNP_HBM_BW wins.  Raises for a card
    it does not know."""
    env = os.environ.get("EKPNP_HBM_BW")
    if env:
        return float(env)
    for tags, bw in _HBM_BW:
        if all(t in name for t in tags):
            return bw
    raise ValueError(f"unknown card {name!r}: its device-memory rate is not "
                     f"known (set EKPNP_HBM_BW in B/s)")


def _median(xs):
    xs = sorted(xs)
    n = len(xs)
    return xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])


def _is_oom(e: Exception) -> bool:
    import torch

    return isinstance(e, torch.cuda.OutOfMemoryError) or \
        "out of memory" in str(e).lower()


def main(argv=None):
    ap = argparse.ArgumentParser(prog="ekpnp_torch bench")
    ap.add_argument("--size", type=int, default=0,
                    help="cubic grid edge (0: 256, stepping down on OOM)")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--reps", type=int, default=9,
                    help="timed windows; the value is their median")
    ap.add_argument("--mode", choices=["coupled", "fluid", "poisson", "pbinit"],
                    default="coupled")
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--scalar-lattice", default="D3Q7",
                    help="lattice of the scalar fields: D3Q7 (default) | "
                    "same (reference parity: every field on D3Q27)")
    ap.add_argument("--no-parity-run", action="store_true",
                    help="skip the all-D3Q27 companion measurement")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    import torch

    from .config import preset
    from .device import resolve_device, torch_dtype
    from .init import initialize, state_from_macro
    from .kernels import fused_step as fs
    from .kernels.step import multi_step
    from .ops.poisson import poisson_phi_from_rhs
    from .state import Macro

    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    backend = "cuda" if cuda else "cpu"
    name = torch.cuda.get_device_name(dev) if cuda else "cpu"
    hbm_bw = _hbm_bandwidth(name) if cuda else None
    dtype = torch_dtype(args.dtype)
    itemsize = torch.empty((), dtype=dtype).element_size()
    sizes = [args.size] if args.size else [256, 192, 128, 96, 64]
    fft_method = "matmul" if cuda else "auto"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def release():
        if cuda:
            torch.cuda.empty_cache()

    def ref_cfg(n, **kw):
        return preset("reference", nx=n, ny=n, nz=n + 1, dtype=args.dtype,
                      fft_method=fft_method, **kw)

    def emit(out):
        out["device"] = name
        print(json.dumps(out), flush=True)
        return 0

    if args.mode == "poisson":
        for n in sizes:
            try:
                cfg = ref_cfg(n)
                rhs = torch.ones((cfg.grid.nz - 2,) + cfg.grid.shape[1:],
                                 dtype=dtype, device=dev)
                poisson_phi_from_rhs(cfg, rhs)
                sync()
                t0 = time.perf_counter()
                for _ in range(args.steps):
                    poisson_phi_from_rhs(cfg, rhs)
                sync()
                ms = (time.perf_counter() - t0) / args.steps * 1e3
            except Exception as e:
                if _is_oom(e):
                    release()
                    continue
                raise
            # ~10 field-sized passes (the RHS read, 3 forward and 3 inverse
            # transform stages, phi written) at the device-memory rate
            floor_ms = (10 * cfg.grid.num_nodes * itemsize / hbm_bw * 1e3
                        if cuda else None)
            return emit({
                "metric": f"spectral Poisson solve ms/step at {n}^3 "
                          f"({args.dtype}, {backend})",
                "value": round(ms, 3), "unit": "ms",
                "vs_baseline": round(floor_ms / ms, 4) if cuda else None})
        emit({"metric": "poisson ms/step", "value": 0, "unit": "ms",
              "vs_baseline": 0})
        return 1

    if args.mode == "pbinit":
        for n in sizes:
            try:
                cfg = ref_cfg(n)
                t0 = time.perf_counter()
                state, _, res = initialize(cfg, device=dev, with_residual=True)
                sync()
                first_s = time.perf_counter() - t0
                del state
                t0 = time.perf_counter()
                state, _, res = initialize(cfg, device=dev, with_residual=True)
                resv = float(res)
                elapsed = time.perf_counter() - t0
                del state
            except Exception as e:
                if _is_oom(e):
                    release()
                    continue
                raise
            iters = cfg.physics.pb_iters
            return emit({
                "metric": f"PB double-layer init at {n}^3 ({iters} iters, "
                          f"{args.dtype}, {backend})",
                "value": round(elapsed, 3), "unit": "s", "vs_baseline": 0,
                "ms_per_iteration": round(elapsed / iters * 1e3, 3),
                "final_relative_update": resv,
                # the first call's excess over the second: library set-up
                "compile_s": round(first_s - elapsed, 1)})
        emit({"metric": "pbinit", "value": 0, "unit": "s", "vs_baseline": 0})
        return 1

    ek = args.mode == "coupled"
    result = None
    for n in sizes:
        try:
            cfg = ref_cfg(n, enable_ek=ek, enable_thermal=ek,
                          scalar_lattice=args.scalar_lattice if ek else "same")
            shape = cfg.grid.shape
            kw = dict(dtype=dtype, device=dev)
            macro = Macro(
                rho=torch.full(shape, 1000.0, **kw),
                u=torch.zeros((3,) + shape, **kw),
                charge=torch.full(shape, 0.01, **kw) if ek else None,
                chargen=torch.full(shape, 0.01, **kw) if ek else None,
                temp=torch.full(shape, 0.5, **kw) if ek else None)
            state = state_from_macro(
                cfg, macro, torch.zeros(shape, **kw) if ek else None,
                torch.zeros((3,) + shape, **kw) if ek else None, 0.0)
            del macro
            # warm-up with the timed windows' step count
            state = multi_step(cfg, state, args.steps)
            sync()
            fs.reset_launches()
            windows = []
            for _ in range(max(1, args.reps)):
                t0 = time.perf_counter()
                state = multi_step(cfg, state, args.steps)
                sync()
                windows.append(time.perf_counter() - t0)
            med = _median(windows)
            result = dict(n=n, mlups=cfg.grid.num_nodes * args.steps / med / 1e6,
                          spread=(max(windows) - min(windows)) / med,
                          windows=len(windows),
                          launches={k: v for k, v in fs.launches.items() if v})
            break
        except Exception as e:
            if _is_oom(e):
                print(f"# size {n}^3 OOM, trying smaller", file=sys.stderr)
                state = None
                release()
                continue
            raise
    if result is None:
        emit({"metric": "MLUPS/chip", "value": 0, "unit": "MLUPS",
              "vs_baseline": 0})
        return 1

    if ek:
        bytes_per_node = (cfg.lattice.Q + 3 * cfg.scalar_lat.Q) * 2 * itemsize \
            + 48 + 128
        label = (f"MLUPS/chip full coupled EK-PNP-thermal step at "
                 f"{result['n']}^3 ({args.dtype}, {backend}, scalars "
                 f"{cfg.scalar_lat.name})")
    else:
        bytes_per_node = cfg.lattice.Q * 2 * itemsize
        label = (f"MLUPS/chip fluid-only step at {result['n']}^3 "
                 f"({args.dtype}, {backend})")
    roofline = hbm_bw / bytes_per_node / 1e6 if cuda else None
    out = {"metric": label, "value": round(result["mlups"], 1),
           "unit": "MLUPS",
           "vs_baseline": round(result["mlups"] / roofline, 4) if cuda else None,
           "spread": round(result["spread"], 4),
           "windows": result["windows"]}
    if cuda:  # the kernel launches of the timed windows
        out["launches"] = result["launches"]
    del state
    release()

    if ek:
        # the solve alone, on a zero RHS of the cell's shape
        rhs = torch.zeros((cfg.grid.nz - 2,) + cfg.grid.shape[1:], dtype=dtype,
                          device=dev)
        poisson_phi_from_rhs(cfg, rhs)
        sync()
        pt = []
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(40):
                poisson_phi_from_rhs(cfg, rhs)
            sync()
            pt.append((time.perf_counter() - t0) / 40)
        out["poisson_ms"] = round(_median(pt) * 1e3, 3)
        del rhs
        release()

    if ek and cfg.scalar_lat.name == "D3Q7" and not args.no_parity_run:
        # the all-D3Q27 companion in a fresh process: the headline state is
        # released above, so that the two 256^3 states never share the card
        cmd = [sys.executable, "-m", "ekpnp_torch", "bench", "--mode",
               "coupled", "--scalar-lattice", "same", "--size",
               str(result["n"]), "--steps", str(args.steps), "--reps",
               str(args.reps), "--dtype", args.dtype, "--no-parity-run",
               "--device", args.device]
        proc = subprocess.run(
            cmd, capture_output=True, text=True, timeout=1800,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
        if proc.returncode != 0 or not lines:
            raise RuntimeError(f"parity run failed ({proc.returncode}):\n"
                               f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
        parity = json.loads(lines[-1])
        out["ref_parity_all_d3q27_mlups"] = parity["value"]
        out["ref_parity_vs_roofline"] = parity["vs_baseline"]
        out["ref_parity_spread"] = parity["spread"]
        out["ref_parity_windows"] = parity["windows"]
        out["ref_parity_knobs"] = "default route (phi_hx chunk)"
    return emit(out)


if __name__ == "__main__":
    sys.exit(main())
