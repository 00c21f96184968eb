"""CLI runner of the port (counterpart of ekpnp/run.py: `run`, `info`,
`merge` and `bench`).

Usage:
    python -m ekpnp_torch run <preset> [--steps N] [--set key=value ...]
                              [--precision f32|f64] [--outdir DIR]
                              [--device cuda|cpu]
                              [--mesh slab|pencil [--mesh-devices N]
                               [--distributed]]
                              [--resume CHECKPOINT] [--checkpoint-full]
                              [--vtk] [--save-scalars] [--profile DIR]
    python -m ekpnp_torch merge <preset> <rundir> [--vtk]
    python -m ekpnp_torch info <preset>
    python -m ekpnp_torch bench [...]      (ekpnp_torch/benchmark.py)

Outputs in --outdir, as the JAX package writes them:
    data.dat        tecplot zones every NSAVE steps
    umax.dat        (t, max uz) every printCurrent steps
    series.csv      (step, t, umax, |u|max, current, <T>)
    data_end.npz    macroscopic checkpoint (either package's load_npz)
    data_end.dat    reference-layout ASCII checkpoint
    state_end.npz   lossless full state (--checkpoint-full; with --mesh the
                    per-shard directory state_end.ckpt)
    fieldsNNNNNN.vtk, nameNNNN.bin   with --vtk, --save-scalars

--resume takes any of the four checkpoint kinds, the JAX package's too: a
per-shard directory (restored onto the run's mesh, or onto one device),
a full-state .npz (exact), a macroscopic .npz or a reference .dat
(populations re-equilibrated).  A resumed run is not perturbed.

On the card the time loop runs the hand-written fused step kernels
(ekpnp_torch/kernels); on the CPU their plain version.  One step runs
before the clock starts: the perturbed first step (`perturb_first_step`)
through the plain step, under --mesh the plain per-shard step, else the
kernel step.  Then, still before the clock, the kernel library is loaded
(and built at first use) and every distinct chunk of the cadence is run
once on a throwaway copy of the state, so the clock holds neither a build
nor a first launch.  Series events and dumps run on a writer thread, in
order: the main thread snapshots fresh tensors and goes on launching, and
the writer copies them to the host (on a stream of its own, after an event
recorded behind the snapshot) and formats them in C++ (io/native.py).  The
clock stops when the last chunk is done, before the writer drains.  A
non-finite state aborts with exit code 2 at the next event or at the end.

--mesh shards the domain over N shards (default: one per device of the
--device kind), placed round-robin over those devices, so `--device cpu
--mesh slab --mesh-devices 4` runs 4 CPU shards and one card can hold
several; the time loop is the sharded one (parallel/halo.py).  A sharded
run writes per-shard field dumps (fields_NNNNNN.shards/) in place of
data.dat and data_end.*; `merge` assembles them (io/fields.py).

--distributed runs the sharded loop over several processes, one global
mesh, each process launched by `python -m torch.distributed.run` (which
sets RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT):

    python -m torch.distributed.run --nproc-per-node 4 -m ekpnp_torch \
        run pod --distributed --mesh slab --set pb_omega=0.02

With --device cuda the processes talk over NCCL, one process per card
(cuda:LOCAL_RANK; NCCL refuses two on one card), with --device cpu over
Gloo.  --mesh-devices is the global shard count, a multiple of the
process count (default: one shard per process); process r holds the r-th
contiguous block of shards in mesh order, all on its own device.  Every
process runs the cold start itself and keeps its shards, writes its own
shards' dumps and checkpoint (shard_<rank>.npz); process 0 alone prints
and writes series.csv, umax.dat and the directories' meta.json, whose
contents equal the one-process mesh run's.  The clock runs from a barrier
after the warm-up to a barrier after the last chunk; the MLUPS is the
global grid's, the launch counts process 0's.  An error on any process
ends it non-zero and the others with it (their next message fails, or
the launcher stops them).
"""
from __future__ import annotations

import argparse
import ast
import contextlib
import json
import os
import queue
import sys
import threading
import time
from functools import lru_cache


class _AsyncIO:
    """Single-worker FIFO writer: series events and save-cadence dumps run
    on a thread, overlapping the host copy and the formatting with the
    next chunk.  FIFO order keeps the zones in order."""

    def __init__(self):
        # deep enough that series events queue behind a dump in flight
        # without blocking the launching thread
        self._q = queue.Queue(maxsize=8)
        self._err = None
        self._t = threading.Thread(target=self._loop, daemon=True)
        self._t.start()

    def _loop(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                item()
            except Exception as e:  # surfaced on the next submit/close
                self._err = self._err or e
            finally:
                self._q.task_done()

    def submit(self, fn):
        if self._err:
            raise self._err
        self._q.put(fn)

    def close(self):
        self._q.put(None)
        self._t.join()
        if self._err:
            raise self._err


def _write_trace(prof, outdir):
    """Stop the profiler and write its Chrome trace to outdir/trace.json."""
    prof.stop()
    os.makedirs(outdir, exist_ok=True)
    trace = os.path.join(outdir, "trace.json")
    prof.export_chrome_trace(trace)
    print(f"  profiler trace written to {trace}")


class _NonFinite(RuntimeError):
    """Raised on the writer thread by the finite guard; surfaces at the
    next submit or close (at worst one more chunk runs before the abort)."""

    def __init__(self, step):
        super().__init__(f"non-finite state detected at step {step}")
        self.step = step


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
    data_end.dat / .npz (io/fields.py); --vtk also fieldsNNNNNN.vtk."""
    from .io.fields import merge_run_dir

    n = merge_run_dir(args.rundir, build_config(args), vtk=args.vtk)
    print(f"merged {n} zones -> {os.path.join(args.rundir, 'data.dat')} "
          f"(+ data_end.dat, data_end.npz)")
    return 0


def cmd_info(args):
    from .diagnostics import dimensionless_banner

    print(dimensionless_banner(build_config(args)))
    return 0


# ---------------------------------------------------------------------------
# the steps before the clock, and the writer's host copies
# ---------------------------------------------------------------------------

def _clock() -> float:
    """The run loop's clock."""
    return time.perf_counter()


# the run's spans (telemetry): a dump on the launching thread (zone 0 and
# the final), one on the writer thread, the drain of the writer after the
# clock
DUMP, WRITER, DRAIN = ("ekpnp_torch.dump", "ekpnp_torch.writer",
                       "ekpnp_torch.drain")
# the set-up spans --profile's table lists: the library load and its build,
# the cold start and its parts, zone 0, the chunks (the first: the warm-up)
SETUP = tuple("ekpnp_torch." + s for s in (
    "load", "build", "init", "init.cold_fields", "init.pb",
    "init.equilibria", "dump", "chunk"))


def _count_seconds(stat):
    """(instances, host seconds) of a span's Stat (None: none ran)."""
    return (0, 0.0) if stat is None else (stat.count, stat.seconds)


def _prepare(dev) -> None:
    """Load the kernel library the time loop launches (nvcc builds it at
    first use), on the card; the CPU runs the plain versions."""
    if dev.type == "cuda":
        from .kernels.fused_step import _load

        _load()


def _tree_map(fn, x):
    """x with fn applied to every tensor of it (a state, a snapshot, a
    sharded field: tensors in tuples, named tuples and lists)."""
    import torch

    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, list):
        return [_tree_map(fn, v) for v in x]
    if isinstance(x, tuple):
        vals = [_tree_map(fn, v) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    return x


def _tensors(x):
    """Every tensor of x, flat."""
    out = []
    _tree_map(out.append, x)
    return out


def _warm(advance, state, sizes, dev) -> None:
    """Run a chunk of each size in `sizes` once on a throwaway copy of the
    state, so that the first launch of every kernel form, the solve's
    library set-up, the allocator's buffers and (over several processes)
    every exchange's first message come before the clock.  A chunk of
    min(n, 2) steps launches every form and buffer a chunk of n does (n =
    1: a collide and a stream; n >= 2: a pass between them), so that is
    what runs.  Skipped on the card where a second state would not fit the
    free memory (of any process's card: they decide together)."""
    import torch
    import torch.distributed

    if dev.type == "cuda":
        need = {}
        for t in _tensors(state):
            need[t.device] = need.get(t.device, 0) + t.numel() * t.element_size()
        fits = all(2.2 * n <= torch.cuda.mem_get_info(d)[0]
                   for d, n in need.items())
        if torch.distributed.is_initialized():  # every process alike
            flag = torch.tensor([int(fits)], device=dev)
            torch.distributed.all_reduce(flag, torch.distributed.ReduceOp.MIN)
            fits = bool(flag)
        if not fits:
            return
    for n in sorted({min(n, 2) for n in sizes}):
        advance(_tree_map(torch.clone, state), n)


def _record(x):
    """Events recorded behind the work that made the CUDA tensors of `x`,
    by device."""
    import torch

    events = {}
    for t in _tensors(x):
        if t.device.type == "cuda" and t.device not in events:
            events[t.device] = torch.cuda.Event()
            events[t.device].record(torch.cuda.current_stream(t.device))
    return events


@lru_cache(maxsize=None)
def _copy_stream(device):
    import torch

    return torch.cuda.Stream(device=device)


def _host(x, events):
    """`x` with every tensor copied to a numpy array.  A card's tensor is
    copied on the copy stream after its event, so the copy waits for the
    snapshot only, not for the chunks launched since."""
    import torch

    def fetch(t):
        if t.device.type != "cuda":
            return t.numpy()
        stream = _copy_stream(t.device)
        stream.wait_event(events[t.device])
        with torch.cuda.stream(stream):
            return t.to("cpu").numpy()

    return _tree_map(fetch, x)


def _init_distributed(args):
    """Join the process group of `run --distributed` from the launcher's
    environment (env://): NCCL for --device cuda, on card LOCAL_RANK, Gloo
    for --device cpu; no other backend and no fallback.  Returns (rank,
    world)."""
    import datetime

    import torch
    import torch.distributed as dist

    if not args.mesh:
        raise SystemExit("--distributed needs --mesh slab|pencil")
    if args.device == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("--distributed --device cuda runs over NCCL, "
                               "which this PyTorch build lacks")
        local = int(os.environ.get("LOCAL_RANK", "0"))
        count = torch.cuda.device_count()
        if local >= count:
            raise RuntimeError(
                f"--distributed --device cuda runs one NCCL process per "
                f"card: LOCAL_RANK {local}, {count} card(s) visible")
        torch.cuda.set_device(local)
    dist.init_process_group("nccl" if args.device == "cuda" else "gloo",
                            init_method="env://",
                            timeout=datetime.timedelta(minutes=10))
    _barrier()  # every process is here; NCCL builds its communicator
    return dist.get_rank(), dist.get_world_size()


def _barrier():
    import torch
    import torch.distributed as dist

    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def cmd_run(args):
    """`run`; with --distributed as one process of the process group
    (only process 0 prints), which it leaves on return or on an error."""
    if not args.distributed:
        return _run(args, 0, 1)
    import torch.distributed as dist

    rank, world = _init_distributed(args)
    try:
        with contextlib.ExitStack() as stack:
            if rank:
                stack.enter_context(contextlib.redirect_stdout(
                    stack.enter_context(open(os.devnull, "w"))))
            return _run(args, rank, world)
    finally:
        dist.destroy_process_group()


def _run(args, rank, world):
    import torch
    import torch.distributed

    from .device import resolve_device

    dev = resolve_device(args.device)
    # the card runs f32 unless asked otherwise; the CPU keeps the config's
    if (dev.type == "cuda" and args.precision is None
            and "dtype" not in _parse_overrides(args.set)):
        args.precision = "f32"
    cfg = build_config(args)

    from .diagnostics import dimensionless_banner, series_point
    from .init import INIT, initialize
    from .io import checkpoint as ckpt
    from .io import tecplot
    from .kernels import fused_step as fs
    from .kernels.step import multi_step, step_fused
    from .ops.collide import compute_macro
    from .ops.poisson import efield
    from . import telemetry
    from .parallel import mesh as pmesh
    from .step import step as plain_step

    mesh = None
    if args.mesh:
        mesh = pmesh.make_mesh(
            pmesh.mesh_devices(dev, args.mesh_devices,
                               world if args.distributed else None),
            pencil=args.mesh == "pencil", rank=rank, world=world)
        pmesh.check_divisibility(cfg, mesh)
    devices = sorted(set(mesh.devices if mesh is not None else [dev]), key=str)

    def sync():
        if dev.type == "cuda":
            for d in devices:
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
        print(f"  mesh: {mesh.shape} over {len(devices)} device(s)"
              + (f" in each of {world} processes "
                 f"({torch.distributed.get_backend()})"
                 if args.distributed else "")
              + f"; field dumps per shard (fields_NNNNNN.shards/), run "
              f"`merge {args.preset} <outdir>` for data.dat")
        skipped = [flag for flag, on in (("--vtk", args.vtk),
                                         ("--save-scalars", args.save_scalars))
                   if on]
        if skipped and rank == 0:
            print(f"WARNING: {' and '.join(skipped)} write nothing under "
                  f"--mesh (the dumps are per shard); `merge {args.preset} "
                  f"<outdir> --vtk` writes the VTK files", file=sys.stderr)

    outdir = cfg.run.outdir
    os.makedirs(outdir, exist_ok=True)

    resumed_sharded = False
    if args.resume:
        if ckpt.is_sharded_checkpoint(args.resume):
            print(f"Restoring from {args.resume} (lossless per-shard resume, "
                  f"mesh-elastic)...")
            state = ckpt.load_sharded(args.resume, cfg, mesh, device=dev)
            resumed_sharded = mesh is not None
        elif ckpt.is_full_checkpoint(args.resume):
            print(f"Restoring from {args.resume} (lossless full-state resume)...")
            state = ckpt.load_full_npz(args.resume, cfg, device=dev)
        else:
            print(f"Restoring from {args.resume} (populations re-equilibrated)...")
            load = (ckpt.load_reference_ascii if args.resume.endswith(".dat")
                    else ckpt.load_npz)
            state = load(args.resume, cfg, device=dev)
    else:
        print("Initializing (PB double-layer relaxation)...")
        state, _, pb_res = initialize(cfg, device=dev, with_residual=True)
        sync()
        if pb_res is not None:
            print(f"  PB init: {cfg.physics.pb_iters} iterations in "
                  f"{telemetry.stat(INIT).last:.2f} s, final relative "
                  f"update {float(pb_res):.3e} (tune with --set pb_iters=N)")
    if mesh is not None and not resumed_sharded:
        state = pmesh.shard_state(cfg, mesh, state)

    ek = cfg.physics.enable_ek
    nsteps = cfg.run.nsteps
    nsave = max(1, cfg.run.nsave)
    ncur = max(1, cfg.run.print_current)
    save_off = 2 % nsave if cfg.run.compat_cadence else 0
    cur_off = 2 % ncur if cfg.run.compat_cadence else 0

    if mesh is None:
        def snapshot(st):
            """Fresh tensors of a dump (the next chunk reuses the state's
            buffers): (Macro, phi, E, t)."""
            macro, _ = compute_macro(cfg, st)
            return (macro, None if st.phi is None else st.phi.clone(),
                    efield(cfg, st.phi) if ek else None, st.t.clone())

        def advance(st, n):
            return multi_step(cfg, st, n)
    else:
        from .io.fields import save_fields_sharded
        from .parallel.halo import shard_macros

        chunk_fns = {}

        def snapshot(st):
            parts = shard_macros(cfg, mesh, st)
            return (pmesh.fields(mesh, parts, 0),
                    [None if p is None else p.clone() for p in st.phi]
                    if ek else None, pmesh.fields(mesh, parts, 1),
                    st.t.clone())

        def advance(st, n):
            if n not in chunk_fns:
                chunk_fns[n] = pmesh.make_sharded_multi_step(cfg, mesh, n)
            return chunk_fns[n](st)

    files = {}  # data.dat of a run without a mesh, opened below

    def write(d, snap, kind):
        """Write a dump's host arrays; kind: "first" (zone 0), "save" (a
        cadence dump) or "final"."""
        macro, phi, E, t = snap
        t = float(t)
        if mesh is not None:
            save_fields_sharded(os.path.join(outdir, f"fields_{d:06d}.shards"),
                                cfg, mesh, macro, phi, E, t, pid=rank,
                                nprocs=world)
            return
        tecplot.write_zone(files["data"], cfg, macro, phi, E, t,
                           first=kind == "first")
        if args.save_scalars and kind == "save":
            from .io.scalars import save_scalars

            save_scalars(outdir, d, cfg, macro, phi, E)
        if args.vtk and kind != "first":
            from .io.vtk import write_vtk

            write_vtk(os.path.join(outdir, f"fields{d:06d}.vtk"), cfg, macro,
                      phi, E, t)

    def dump_now(d, st, kind):
        with telemetry.span(DUMP, device=False):
            snap = snapshot(st)
            snap = _host(snap, _record(snap))
            write(d, snap, kind)
        return snap

    prof = None
    with contextlib.ExitStack() as stack:
        if mesh is None:
            files["data"] = stack.enter_context(
                open(os.path.join(outdir, "data.dat"), "w"))
        # the run-level files are process 0's
        here = lambda name: os.path.join(outdir, name) if rank == 0 \
            else os.devnull
        fumax = stack.enter_context(open(here("umax.dat"), "w"))
        fcsv = stack.enter_context(open(here("series.csv"), "w"))
        fcsv.write("step,t,umax_uz,umax_mag,current,mean_T\n")
        dump_now(0, state, "first")
        t_zone0 = telemetry.stat(DUMP).last

        # one step before the clock starts (the reference times the loop
        # only); when configured it seeds the convection pattern through
        # the plain step, which the kernels do not implement (never on a
        # resumed run); under a mesh it is the plain per-shard step, as the
        # JAX package's first sharded step is its oracle's
        perturb0 = bool(cfg.run.perturb_first_step) and not args.resume
        if mesh is not None:
            state, _ = pmesh.make_sharded_step(cfg, mesh, perturb=perturb0)(state)
        elif perturb0:
            state, _ = plain_step(cfg, state, perturb=True)
        else:
            state, _ = step_fused(cfg, state)
        done = steps_warm = 1
        sizes, d = set(), done
        while d < nsteps:
            nxt = min(_next_multiple(d, nsave, save_off),
                      _next_multiple(d, ncur, cur_off), nsteps)
            sizes.add(nxt - d)
            d = nxt
        _prepare(dev)
        _warm(advance, state, sizes, dev)
        sync()
        if args.distributed:
            _barrier()

        aio = _AsyncIO()
        if args.profile:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
            prof = profile(activities=acts)
            prof.start()
        # the cadence dumps' copies, formatting and writes before the loop
        writer0 = _count_seconds(telemetry.stat(WRITER))
        counters0 = dict(telemetry.counters)
        fs.reset_launches()
        t0 = _clock()
        try:
            while done < nsteps:
                nxt = min(_next_multiple(done, nsave, save_off),
                          _next_multiple(done, ncur, cur_off), nsteps)
                state = advance(state, nxt - done)
                done = nxt
                if done % ncur == cur_off or done == nsteps:
                    vals = (*series_point(cfg, state, mesh), state.t.clone())

                    def _series(vals=vals, ev=_record(vals), d=done):
                        um, umag, cur, mean_t, finite, t_now = (
                            float(x) for x in _host(vals, ev))
                        fumax.write(f"{t_now:10.6f} {um:10.6f}\n")
                        fcsv.write(f"{d},{t_now:.9e},{um:.9e},{umag:.9e},"
                                   f"{cur:.9e},{mean_t:.9e}\n")
                        print(f"Iteration: {d}, physical time: {t_now:g}, "
                              f"Current = {cur:g}, umax = {um:g}", flush=True)
                        if not finite:
                            raise _NonFinite(d)

                    aio.submit(_series)
                if done % nsave == save_off and done < nsteps:
                    snap = snapshot(state)

                    def _dump(snap=snap, ev=_record(snap), d=done):
                        with telemetry.span(WRITER, device=False):
                            write(d, _host(snap, ev), "save")

                    aio.submit(_dump)
            sync()
            if args.distributed:
                _barrier()
            runtime = _clock() - t0
            launches = {k: v for k, v in fs.launches.items() if v}
            if prof is not None:
                _write_trace(prof, args.profile)
                prof = None
                spans = telemetry.table(done - steps_warm, counters0, SETUP)
            with telemetry.span(DRAIN, device=False) as drain:
                aio.close()  # drain the events and dumps before the final zone
        except _NonFinite as e:
            print(f"ERROR: {e}; aborting", file=sys.stderr)
            if prof is not None:  # the trace up to the abort
                _write_trace(prof, args.profile)
            with contextlib.suppress(_NonFinite):
                aio.close()  # let the writer finish before the files close
            return 2
        macro, phi, E, t = dump_now(max(nsteps, done), state, "final")

    if mesh is None:
        ckpt.save_npz(os.path.join(outdir, "data_end.npz"), cfg, macro, phi,
                      E, t)
        ckpt.save_reference_ascii(os.path.join(outdir, "data_end.dat"), cfg,
                                  macro, phi, E, t)
    if args.checkpoint_full:
        if mesh is not None:
            ckpt.save_sharded(os.path.join(outdir, "state_end.ckpt"), cfg,
                              state, mesh, pid=rank, nprocs=world)
        else:
            ckpt.save_full_npz(os.path.join(outdir, "state_end.npz"), cfg,
                               state)

    steps_timed = max(nsteps, done) - steps_warm
    nodes_updated = steps_timed * cfg.grid.num_nodes
    mlups = nodes_updated / (1e6 * runtime) if runtime > 0 else 0.0
    print(" ----- performance information -----")
    print(f"           timesteps: {max(nsteps, done)} ({steps_timed} timed; "
          f"{steps_warm} warm-up)")
    print(f"       clock runtime: {runtime:.3f} (s)")
    print(f"               speed: {mlups:.2f} (Mlups)")
    # every active field's directions, read and written once a step (the
    # reference's own printout counts the fluid field only, main.cu:236-245)
    nsc = ((2 if cfg.physics.two_species else 1) if ek else 0) + (
        1 if cfg.physics.enable_thermal else 0)
    dirs = cfg.lattice.Q + nsc * cfg.scalar_lat.Q
    dsize = 8 if cfg.run.dtype == "float64" else 4
    gib = (nodes_updated * dirs * 2 * dsize / (1024.0 ** 3) / runtime
           if runtime > 0 else 0.0)
    print(f"           bandwidth: {gib:.1f} (GiB/s), all-field population "
          f"traffic")
    dumps, writer_s = (a - b for a, b in zip(
        _count_seconds(telemetry.stat(WRITER)), writer0))
    print(f"       writer thread: {dumps} dumps in "
          f"{writer_s:.3f} s (host copy, formatting, write), drained "
          f"{drain.seconds:.3f} s after the clock; zone 0 {t_zone0:.3f} s")
    print(f"     kernel launches: {json.dumps(launches)}")
    if args.profile:
        print(" ----- spans and counters of the profiled loop -----")
        print(spans)
    return 0


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "bench":
        # everything after "bench" goes to the benchmark's own parser
        from .benchmark import main as bench_main

        return bench_main(argv[1:])
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
             "the --device kind (default: one per device); with "
             "--distributed the global count, a multiple of the process "
             "count (default: one per process)")
    p_run.add_argument(
        "--distributed", action="store_true",
        help="one process of a multi-process run under `python -m "
             "torch.distributed.run` (env://): NCCL with --device cuda, one "
             "process per card; Gloo with --device cpu; needs --mesh")
    p_run.add_argument(
        "--resume", default=None,
        help="checkpoint to continue from: a per-shard directory, a full "
             "or macroscopic .npz, or a reference .dat")
    p_run.add_argument(
        "--checkpoint-full", action="store_true",
        help="also write the lossless full state: state_end.npz, or with "
             "--mesh the per-shard directory state_end.ckpt")
    p_run.add_argument(
        "--vtk", action="store_true",
        help="also write binary VTK snapshots fieldsNNNNNN.vtk at every save "
             "step and at the end")
    p_run.add_argument(
        "--save-scalars", action="store_true",
        help="per-field binary dumps nameNNNN.bin at every save step")
    p_run.add_argument(
        "--profile", default=None, metavar="DIR",
        help="write a torch.profiler Chrome trace of the timed loop to "
             "DIR/trace.json")
    p_run.set_defaults(fn=cmd_run)

    p_info = sub.add_parser("info", help="print configuration banner")
    common(p_info)
    p_info.set_defaults(fn=cmd_info)

    p_merge = sub.add_parser(
        "merge", help="assemble a sharded run's per-shard field dumps "
        "(fields_NNNNNN.shards/) into data.dat + data_end.dat/.npz")
    common(p_merge)
    p_merge.add_argument("rundir", help="the sharded run's --outdir")
    p_merge.add_argument("--vtk", action="store_true",
                         help="also write fieldsNNNNNN.vtk per dump")
    p_merge.set_defaults(fn=cmd_merge)

    sub.add_parser(
        "bench", help="one-card MLUPS / Poisson benchmark (one JSON line); "
        "all further flags go to ekpnp_torch.benchmark", add_help=False)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
