"""CLI runner of the port (counterpart of ekpnp/run.py: `run`, `info` and
`merge`).

Usage:
    python -m ekpnp_torch run <preset> [--steps N] [--set key=value ...]
                              [--precision f32|f64] [--outdir DIR]
                              [--device cuda|cpu]
                              [--mesh slab|pencil [--mesh-devices N]]
    python -m ekpnp_torch merge <preset> <rundir>
    python -m ekpnp_torch info <preset>

Outputs in --outdir, as the JAX package writes them:
    data.dat      tecplot zones every NSAVE steps
    umax.dat      (t, max uz) every printCurrent steps
    series.csv    (step, t, umax, |u|max, current, <T>)
    data_end.npz  macroscopic checkpoint (loads with ekpnp.io.checkpoint)
    data_end.dat  reference-layout ASCII checkpoint

On the card the time loop runs the hand-written fused step kernels
(ekpnp_torch/kernels); on the CPU their plain version.  The perturbed first
step (`perturb_first_step`) runs the plain step, on the card's tensors
where the run is on the card, as the JAX package runs it through its
oracle.  A non-finite state at a diagnostics event aborts with exit code
2.  Dumps are written synchronously, inside the timed loop.

--mesh shards the domain over N shards (default: one per device of the
--device kind), placed round-robin over those devices, so `--device cpu
--mesh slab --mesh-devices 4` runs 4 CPU shards and one card can hold
several; the time loop is the sharded one (parallel/halo.py), its first
step the plain per-shard step (parallel/mesh.py make_sharded_step).  A
sharded run writes per-shard field dumps (fields_NNNNNN.shards/) in place
of data.dat and data_end.*; `merge` assembles them (io/fields.py).  Not in
this port yet: --distributed, --resume and --checkpoint-full (sharded
checkpoints with them), --vtk, --save-scalars, --profile.
"""
from __future__ import annotations

import argparse
import ast
import contextlib
import os
import sys
import time


def _next_multiple(done, n, off):
    """Smallest e > done with e % n == off (the I/O event schedule)."""
    return ((done - off) // n + 1) * n + off


def _parse_overrides(pairs):
    out = {}
    for pair in pairs or []:
        if "=" not in pair:
            raise SystemExit(f"--set expects key=value, got {pair!r}")
        k, v = pair.split("=", 1)
        if v.lower() in ("true", "false"):
            out[k] = v.lower() == "true"
            continue
        try:
            out[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            out[k] = v
    return out


def build_config(args):
    from .config import from_file, preset

    overrides = _parse_overrides(args.set)
    if args.steps is not None:
        overrides["nsteps"] = args.steps
    if args.precision:
        overrides["dtype"] = {"f32": "float32", "f64": "float64"}[args.precision]
    if args.outdir:
        overrides["outdir"] = args.outdir
    if args.preset.endswith((".yaml", ".yml", ".json")) or os.path.isfile(args.preset):
        return from_file(args.preset, **overrides)
    return preset(args.preset, **overrides)


def cmd_merge(args):
    """Assemble a sharded run's per-shard field dumps into data.dat and
    data_end.dat / .npz (io/fields.py)."""
    from .io.fields import merge_run_dir

    n = merge_run_dir(args.rundir, build_config(args))
    print(f"merged {n} zones -> {os.path.join(args.rundir, 'data.dat')} "
          f"(+ data_end.dat, data_end.npz)")
    return 0


def cmd_info(args):
    from .diagnostics import dimensionless_banner

    print(dimensionless_banner(build_config(args)))
    return 0


def cmd_run(args):
    import torch

    from .device import resolve_device

    dev = resolve_device(args.device)
    # the card runs f32 unless asked otherwise; the CPU keeps the config's
    if (dev.type == "cuda" and args.precision is None
            and "dtype" not in _parse_overrides(args.set)):
        args.precision = "f32"
    cfg = build_config(args)

    from .diagnostics import dimensionless_banner, series_point
    from .init import initialize
    from .io import checkpoint as ckpt
    from .io import tecplot
    from .kernels.step import multi_step, step_fused
    from .ops.collide import compute_macro
    from .ops.poisson import efield
    from .parallel import mesh as pmesh
    from .step import step as plain_step

    mesh = None
    if args.mesh:
        mesh = pmesh.make_mesh(pmesh.mesh_devices(dev, args.mesh_devices),
                               pencil=args.mesh == "pencil")
        pmesh.check_divisibility(cfg, mesh)

    def sync():
        if dev.type == "cuda":
            for d in set(mesh.devices if mesh is not None else [dev]):
                torch.cuda.synchronize(d)

    print(dimensionless_banner(cfg))
    print(f"  timesteps: {cfg.run.nsteps}  save every: {cfg.run.nsave}")
    print(f"  dtype: {cfg.run.dtype}  lattice: {cfg.run.lattice}"
          f"  scalars: {cfg.scalar_lat.name}")
    print(f"  device: {dev}"
          + (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda" else "")
          + ("  fused step: CUDA kernels" if dev.type == "cuda"
             else "  fused step: plain PyTorch"))
    if mesh is not None:
        print(f"  mesh: {mesh.shape} over {len(set(mesh.devices))} "
              f"device(s); field dumps per shard (fields_NNNNNN.shards/), "
              f"run `merge {args.preset} <outdir>` for data.dat")

    outdir = cfg.run.outdir
    os.makedirs(outdir, exist_ok=True)

    print("Initializing (PB double-layer relaxation)...")
    t_init = time.perf_counter()
    state, _, pb_res = initialize(cfg, device=dev, with_residual=True)
    sync()
    if pb_res is not None:
        print(f"  PB init: {cfg.physics.pb_iters} iterations in "
              f"{time.perf_counter() - t_init:.2f} s, final relative "
              f"update {float(pb_res):.3e} (tune with --set pb_iters=N)")

    def efield_now(st):
        return efield(cfg, st.phi) if cfg.physics.enable_ek else None

    nsteps = cfg.run.nsteps
    nsave = max(1, cfg.run.nsave)
    ncur = max(1, cfg.run.print_current)
    save_off = 2 % nsave if cfg.run.compat_cadence else 0
    cur_off = 2 % ncur if cfg.run.compat_cadence else 0

    if mesh is None:
        def zone(fout, st, first=False):
            macro, _ = compute_macro(cfg, st)
            tecplot.write_zone(fout, cfg, macro, st.phi, efield_now(st),
                               float(st.t), first=first)
            return macro

        def advance(st, n):
            return multi_step(cfg, st, n)
    else:
        from .io.fields import save_fields_sharded
        from .parallel.halo import shard_macros

        state = pmesh.shard_state(cfg, mesh, state)
        chunk_fns = {}

        def zone(fout, st, first=False):
            parts = shard_macros(cfg, mesh, st)
            save_fields_sharded(
                os.path.join(outdir, f"fields_{done:06d}.shards"), cfg, mesh,
                [m for m, _ in parts], st.phi,
                [E for _, E in parts] if cfg.physics.enable_ek else None,
                float(st.t))

        def advance(st, n):
            if n not in chunk_fns:
                chunk_fns[n] = pmesh.make_sharded_multi_step(cfg, mesh, n)
            return chunk_fns[n](st)

    done = 0
    with contextlib.ExitStack() as files:
        fout = (files.enter_context(open(os.path.join(outdir, "data.dat"), "w"))
                if mesh is None else None)
        fumax = files.enter_context(open(os.path.join(outdir, "umax.dat"), "w"))
        fcsv = files.enter_context(open(os.path.join(outdir, "series.csv"), "w"))
        fcsv.write("step,t,umax_uz,umax_mag,current,mean_T\n")
        zone(fout, state, first=True)

        # one step before the clock starts (the reference times the loop
        # only); when configured it seeds the convection pattern through
        # the plain step, which the kernels do not implement; under a mesh
        # it is the plain per-shard step either way, as the JAX package's
        # first sharded step is its oracle's
        if mesh is not None:
            state, _ = pmesh.make_sharded_step(
                cfg, mesh, perturb=cfg.run.perturb_first_step)(state)
        elif cfg.run.perturb_first_step:
            state, _ = plain_step(cfg, state, perturb=True)
        else:
            state, _ = step_fused(cfg, state)
        sync()
        done = steps_warm = 1

        t0 = time.perf_counter()
        while done < nsteps:
            nxt = min(_next_multiple(done, nsave, save_off),
                      _next_multiple(done, ncur, cur_off), nsteps)
            state = advance(state, nxt - done)
            done = nxt
            if done % ncur == cur_off or done == nsteps:
                um, umag, cur, mean_t, finite = (
                    x.item() for x in series_point(cfg, state, mesh))
                t_now = float(state.t)
                fumax.write(f"{t_now:10.6f} {um:10.6f}\n")
                fcsv.write(f"{done},{t_now:.9e},{um:.9e},{umag:.9e},"
                           f"{cur:.9e},{mean_t:.9e}\n")
                print(f"Iteration: {done}, physical time: {t_now:g}, "
                      f"Current = {cur:g}, umax = {um:g}")
                if not finite:
                    print(f"ERROR: non-finite state detected at step {done}; "
                          f"aborting", file=sys.stderr)
                    return 2
            if done % nsave == save_off and done < nsteps:
                zone(fout, state)
        sync()
        runtime = time.perf_counter() - t0
        macro = zone(fout, state)

    if mesh is None:
        E_io = efield_now(state)
        ckpt.save_npz(os.path.join(outdir, "data_end.npz"), cfg, macro,
                      state.phi, E_io, float(state.t))
        ckpt.save_reference_ascii(os.path.join(outdir, "data_end.dat"), cfg,
                                  macro, state.phi, E_io, float(state.t))

    steps_timed = max(nsteps, done) - steps_warm
    nodes_updated = steps_timed * cfg.grid.num_nodes
    mlups = nodes_updated / (1e6 * runtime) if runtime > 0 else 0.0
    print(" ----- performance information -----")
    print(f"           timesteps: {max(nsteps, done)} ({steps_timed} timed; "
          f"{steps_warm} warm-up)")
    print(f"       clock runtime: {runtime:.3f} (s)")
    print(f"               speed: {mlups:.2f} (Mlups)")
    return 0


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    ap = argparse.ArgumentParser(prog="ekpnp_torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument(
            "preset",
            help="reference|poiseuille|ek-channel|ek-pnp|ek-pnp-thermal|pod, "
                 "or a YAML/JSON config file")
        p.add_argument("--steps", type=int, default=None)
        p.add_argument("--set", nargs="*", metavar="key=value")
        p.add_argument("--precision", choices=["f32", "f64"], default=None)
        p.add_argument("--outdir", default=None)

    p_run = sub.add_parser("run", help="run a simulation")
    common(p_run)
    p_run.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                       help="cuda (default; raises without a card) or cpu")
    p_run.add_argument(
        "--mesh", choices=["slab", "pencil"], default=None,
        help="shard the domain (slab: y, pencil: y+x) over --mesh-devices "
             "shards")
    p_run.add_argument(
        "--mesh-devices", type=int, default=0,
        help="number of shards for --mesh, round-robin over the devices of "
             "the --device kind (default: one per device)")
    p_run.set_defaults(fn=cmd_run)

    p_info = sub.add_parser("info", help="print configuration banner")
    common(p_info)
    p_info.set_defaults(fn=cmd_info)

    p_merge = sub.add_parser(
        "merge", help="assemble a sharded run's per-shard field dumps "
        "(fields_NNNNNN.shards/) into data.dat + data_end.dat/.npz")
    common(p_merge)
    p_merge.add_argument("rundir", help="the sharded run's --outdir")
    p_merge.set_defaults(fn=cmd_merge)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
