"""One run of one cell: set-up, the window, the traced reading, the check
and the result line.

A configuration whose `deployment` names processes runs a slab mesh over
that many processes, one card each, over NCCL (Gloo on the CPU), as `run
pod --distributed --mesh slab` does: this process is rank 0 and starts
the others itself (`python3 -m ekbench.run ... --rank r --port p`).  Every
process runs the cold start and keeps its shard.  Process 0 decides when
the window ends, receives the other processes' snapshot shards for the
check and their peak memory and trace readings, and prints the result.
"""
from __future__ import annotations

import ast
import dataclasses
import datetime
import os
import socket
import statistics
import subprocess
import sys

import torch

from . import compare, harness, trace
from .accounting import hbm_bandwidth, power_limit
from .manifest import program_overrides, reader
from .reference import lbm, params, shards, solve

# chunks by which process 0 posts its decisions ahead: a process's host
# runs at most QUEUE + 2 chunks ahead of its card, and the cards of a mesh
# keep step with each other through their collectives
LEAD = harness.QUEUE + 4
CODE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MIN_GAPS = 200     # series intervals a tail needs


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class Group:
    """The processes of a mesh cell: the store, the process group and the
    workers process 0 started.  One process: none of them."""

    def __init__(self, world: int, rank: int, port: int, device, spawn,
                 worker: list):
        self.world, self.rank, self.procs, self.store = world, rank, [], None
        if world == 1:
            return
        import torch.distributed as dist

        if rank == 0:
            port = port or _free_port()
            for r in range(1, world):
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-m", *worker, *spawn,
                     "--rank", str(r), "--port", str(port),
                     "--device", device.type],
                    cwd=CODE, stdout=subprocess.DEVNULL))
        self.store = dist.TCPStore("localhost", port, world, rank == 0,
                                   timeout=datetime.timedelta(minutes=5))
        if device.type == "cuda":
            torch.cuda.set_device(rank)
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                store=self.store, rank=rank, world_size=world,
                                timeout=datetime.timedelta(minutes=5))
        self.barrier()

    def barrier(self):
        if self.world == 1:
            return
        import torch.distributed as dist

        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()

    def post(self, key: str, value):
        if self.world > 1:
            self.store.set(f"ekbench/{key}/{self.rank}", repr(value))

    def gather(self, key: str) -> list:
        """Every process's posted value (read by process 0)."""
        return [ast.literal_eval(self.store.get(f"ekbench/{key}/{r}").decode())
                for r in range(self.world)]

    def close(self) -> int:
        """Leave the group; process 0 waits for the workers and returns how
        many failed."""
        if self.world == 1:
            return 0
        import torch.distributed as dist

        self.barrier()
        dist.destroy_process_group()
        bad = 0
        for p in self.procs:
            try:
                bad += p.wait(timeout=120) != 0
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
                bad += 1
        return bad


def program_config(cell):
    from ekpnp_torch.config import preset

    return preset(cell.config["preset"], **program_overrides(cell.config))


def run_cell(cell, seed: int, seconds: float, traced: bool, device,
             t_start: float, rank: int = 0, port: int = 0,
             control: bool = False, worker=("ekbench.worker",)):
    """Run the cell once; process 0 returns the result dict, a worker None.
    `control` also reads the control's numbers (`calibrate`); `worker` is
    the module (and its first arguments) the other processes of a mesh
    cell run."""
    dep = cell.config.get("deployment", {})
    world = int(dep.get("processes", 1))
    if world > 1 and dep.get("mesh") != "slab":
        raise ValueError("the harness runs slab meshes over processes")
    spawn = ["--root", cell.root, "--workload", cell.name, "--seed", str(seed),
             "--seconds", repr(seconds), "--trace", str(int(traced))]
    if device.type == "cuda":
        from ekpnp_torch.kernels import fused_step

        torch.cuda.set_device(rank)
        with harness.span("setup.load", traced):
            fused_step._load()     # process 0 builds before the others start
    group = Group(world, rank, port, device, spawn, worker)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    cfg = program_config(cell)
    mesh = None
    if world > 1:
        from ekpnp_torch.parallel.mesh import make_mesh, mesh_devices

        mesh = make_mesh(mesh_devices(device, world, world), rank=rank,
                         world=world)
    prog = harness.Program(cfg, device, mesh)
    timings = {}
    state, keep = harness.setup(prog, cell, seed, traced, timings)
    group.barrier()
    stop = harness.Stop(group.store, rank, LEAD if world > 1 else 0)
    prof = trace.profiler() if traced else None
    with harness.span("window", traced):
        state, win = harness.window(prog, state, keep, seconds, traced, stop,
                                    group.barrier if world > 1 else None)
    tr = trace.Trace(trace.events(prof)) if traced else None
    cuda = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    del state
    group.post("peak", peak)
    group.post("busy", [tr.busy_us, tr.window_us] if tr else None)
    if cuda:
        torch.cuda.empty_cache()
    t_check = harness.clock()
    numbers, extra = check(cell, keep, win, seed, group, device, control)
    timings["check_s"] = harness.clock() - t_check
    bad = group.close()
    if rank:
        return None
    if world > 1:
        peak = max(group.gather("peak"))
        busy = group.gather("busy") if tr else None
    else:
        busy = [[tr.busy_us, tr.window_us]] if tr else None
    if bad:
        numbers["workers_failed"] = float(bad)
    out = result(cell, cfg, device, t_start, win, timings, tr, busy, peak,
                 numbers, world, mesh)
    if control:
        out["control"] = extra
    return out


# ---------------------------------------------------------------------------
# the check
# ---------------------------------------------------------------------------

def _gather_full(bufs: dict, group, P, device):
    """The whole-grid state from every process's shard (process 0; the
    others send theirs and get None).  A slab shard r holds the y rows of
    `reference.shards.rows`."""
    import torch.distributed as dist

    out = {} if group.rank == 0 else None
    for k in sorted(bufs):
        mine = bufs[k].contiguous()
        if group.rank:
            dist.send(mine, dst=0)
            continue
        full = torch.empty(mine.shape[:-2] + (P.ny, P.nx), dtype=mine.dtype,
                           device=device)
        for r in range(group.world):
            y0, y1 = shards.rows(P.ny, group.world, r)
            if r == 0:
                full[..., y0:y1, :] = mine
            else:
                part = torch.empty_like(mine)
                dist.recv(part, src=r)
                full[..., y0:y1, :] = part
                del part
        out[k] = full
    return out


def check(cell, keep: dict, win: dict, seed: int, group, device,
          control: bool = False):
    """(numbers compared, the control's numbers where `control`), on
    process 0; the workers only send their shards."""
    P = params.from_config(cell.config)
    bufs = keep.pop("bufs")
    if group.world > 1:
        st_in = _gather_full(bufs["in"], group, P, device)
        st_out = _gather_full(bufs["out"], group, P, device)
    else:
        st_in, st_out = bufs["in"], bufs["out"]
    del bufs
    if group.rank:
        return {}, {}
    dtype = st_in["f"].dtype
    numbers, extra = {}, {}
    with solve.full_f32():
        cold = solve.pb_cold_start(P, device, dtype)
        numbers.update(compare.check_cold(P, keep["cold"], cold))
        ref_init = compare.initial_planes(P, cold, cell.traffic, seed,
                                          keep["planes"], device)
        numbers.update(compare.check_init(keep["init"], ref_init))
        if control:
            cold_c = solve.pb_cold_start(P, device, dtype, tf32=True)
            extra.update(compare.check_cold(
                P, dict(zip(("phi", "charge", "chargen"), cold_c)), cold))
            extra.update(compare.check_init(compare.initial_planes(
                P, cold_c, cell.traffic, seed, keep["planes"], device),
                ref_init))
            del cold_c
        del cold, ref_init
        ref_out = lbm.run(P, st_in, keep["n"])
        detail = extra.setdefault("program", {}) if control else None
        numbers.update(compare.check_chunk(P, st_in, st_out, ref_out, detail))
        ref_series = lbm.series(P, ref_out)
        if control:
            del st_out
            ctl = lbm.run(P, st_in, keep["n"], tf32=True)
            cdet = extra.setdefault("control_detail", {})
            extra.update(compare.check_chunk(P, st_in, ctl, ref_out, cdet))
            ctl_series = lbm.series(P, ctl)
            extra.update(compare.check_series(
                [ctl_series[k] for k in compare.SERIES], ref_series, cdet))
            del ctl
            extra["unchanged"] = compare.check_chunk(P, st_in, st_in, ref_out)
    landed = {i: vals for i, vals, _ in win["landed"]}
    got = landed.get(win["check"])
    numbers.update(compare.check_series(got[:4], ref_series, detail) if got
                   else {"series.current": float("inf")})
    numbers["nonfinite"] = float(sum(1 for v in landed.values() if not v[4])
                                 + (win["chunks"] - len(landed)))
    return numbers, extra


# ---------------------------------------------------------------------------
# the result line
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Context:
    """What a per-layer reader (`ekbench/metrics/<name>.py`) sees."""

    trace: object         # ekbench.trace.Trace of process 0's window
    n: int                # steps per chunk (the series cadence)
    chunks: int           # chunks in the window
    steps: int            # steps in the window
    series: int           # series points in the window
    shape: tuple          # the grid (NZ, NY, NX)
    local_shape: tuple    # process 0's block of it
    q_f: int
    q_s: int
    itemsize: int
    bandwidth: float      # the card's published memory rate, B/s
    pb_init_s: float      # host clock around the cold start


def _gaps_ms(landed) -> list:
    times = [t for _, _, t in landed]
    return [(b - a) * 1e3 for a, b in zip(times, times[1:])]


def end_to_end(cell, cfg, t_start, win, peak) -> dict:
    nodes = cfg.grid.num_nodes
    gaps = _gaps_ms(win["landed"])
    values = {
        "setup_s": win["t0"] - t_start,
        "mlups": nodes * win["steps"] / win["seconds"] / 1e6,
        "peak_gib": peak / 2.0 ** 30,
    }
    values["mlups_4card"] = values["mlups"]
    if len(gaps) > MIN_GAPS:
        values["series_gap_ms_p95"] = statistics.quantiles(
            gaps, n=100, method="inclusive")[94]
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in cell.end_to_end if m["name"] in values}


def per_layer(cell, ctx) -> dict:
    out = {}
    for m in cell.per_layer:
        v = reader(cell, m["name"]).read(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def result(cell, cfg, device, t_start, win, timings, tr, busy, peak, numbers,
           world, mesh) -> dict:
    ok, rows = compare.verdict(numbers, cell.limits)
    cuda = device.type == "cuda"
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind,
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": ok, "attempted": win["chunks"],
           "failed": int(numbers.get("nonfinite", 0))}
    if tr is None:
        metrics = end_to_end(cell, cfg, t_start, win, peak)
    else:
        local = cfg.grid.shape if mesh is None else (
            cfg.grid.nz, cfg.grid.ny // world, cfg.grid.nx)
        ctx = Context(trace=tr, n=int(cell.traffic["series_every"]),
                      chunks=win["chunks"], steps=win["steps"],
                      series=len(win["landed"]), shape=cfg.grid.shape,
                      local_shape=local, q_f=cfg.lattice.Q,
                      q_s=cfg.scalar_lat.Q,
                      itemsize=4 if cfg.run.dtype == "float32" else 8,
                      bandwidth=hbm_bandwidth(kind) if cuda else float("nan"),
                      pb_init_s=timings["pb_init_s"])
        metrics = per_layer(cell, ctx)
        dev["busy_s"] = statistics.fmean(b for b, _ in busy) * 1e-6
        dev["window_s"] = tr.window_us * 1e-6
        out["breakdown"] = tr.breakdown()
    if not cuda:   # a rehearsal's numbers are the CPU's, never a device's
        metrics = {f"cpu_rehearsal.{k}": v for k, v in metrics.items()}
    out["metrics"] = metrics
    out["device"] = dev
    out["card"] = power_limit() if cuda else "cpu"
    out["timings"] = timings
    out["checks"] = rows
    return out
