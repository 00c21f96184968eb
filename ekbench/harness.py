"""Set-up, the measured window and the snapshots of one run.

The window drives the program's time loop as its CLI (`ekpnp_torch.run`
`_run`) composes it at a series cadence of n steps: a chunk of n steps
(`multi_step`, or the sharded chunk of `parallel.mesh` on a mesh), then
`diagnostics.series_point`, an event recorded behind it, and the values
copied to the host on a side stream by a worker thread, so the launching
thread never waits for them; a queue of 8 series points bounds how far it
runs ahead.  Chunks run until --seconds have passed; then the cards are
synchronised and the worker drained.  The window is the time from its
first launch to the last series value on the host.

Inside the window, at the chunk the seed picks (`perturb.check_fraction`),
the state going in and the state coming out are copied into buffers made
in set-up: the check (`compare`) runs the reference over that chunk once
the window has closed.
"""
from __future__ import annotations

import contextlib
import queue
import threading
import time

import torch

from .perturb import apply, check_fraction, perturbation, sample_planes

POPS = ("f", "h", "hn", "g")
QUEUE = 8          # series points in flight, as the CLI's writer allows


def clock() -> float:
    return time.perf_counter()


def span(name: str, on: bool):
    """A harness span in the profiler's trace (a no-op untraced)."""
    if on:
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


class Writer:
    """The CLI's single worker thread for series events (run.py
    `_AsyncIO`): each item copies one series point's values to the host on
    a copy stream after the event behind them, and notes when they landed."""

    def __init__(self, depth: int = QUEUE):
        self._q = queue.Queue(maxsize=depth)
        self._streams = {}        # a copy stream per card
        self.landed = []          # (chunk, values as floats, host time)
        self.error = None
        self._t = threading.Thread(target=self._loop, daemon=True)
        self._t.start()

    def _loop(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                i, vals, events = item
                host = [float(v) for v in self._to_host(vals, events)]
                self.landed.append((i, host, clock()))
            except Exception as e:  # noqa: BLE001 - surfaced by close()
                self.error = self.error or e
            finally:
                self._q.task_done()

    def submit(self, i, vals):
        if self.error:
            raise self.error
        self._q.put((i, vals, _record(vals)))

    def close(self):
        self._q.put(None)
        self._t.join()
        if self.error:
            raise self.error

    def _to_host(self, vals, events):
        """The values as Python numbers, each card's copied on its copy
        stream once the event behind them has passed."""
        out = []
        for t in vals:
            if t.device.type != "cuda":
                out.append(t.item())
                continue
            stream = self._streams.setdefault(
                t.device, torch.cuda.Stream(device=t.device))
            stream.wait_event(events[t.device])
            with torch.cuda.stream(stream):
                out.append(t.to("cpu").item())
        return out


def _record(vals):
    events = {}
    for t in vals:
        if t.device.type == "cuda" and t.device not in events:
            events[t.device] = torch.cuda.Event()
            events[t.device].record(torch.cuda.current_stream(t.device))
    return events


# ---------------------------------------------------------------------------
# the program, one device or one process of a mesh
# ---------------------------------------------------------------------------

class Program:
    """The program's calls the window makes, and its state's tensors."""

    def __init__(self, cfg, device, mesh=None):
        from ekpnp_torch.diagnostics import series_point
        from ekpnp_torch.kernels.step import multi_step

        self.cfg, self.device, self.mesh = cfg, device, mesh
        self._series = series_point
        self._multi = multi_step
        self._chunks = {}

    def advance(self, state, n: int):
        if self.mesh is None:
            return self._multi(self.cfg, state, n)
        if n not in self._chunks:
            from ekpnp_torch.parallel.mesh import make_sharded_multi_step

            self._chunks[n] = make_sharded_multi_step(self.cfg, self.mesh, n)
        return self._chunks[n](state)

    def series(self, state):
        """(max uz, max |u|, current, mean T, finite, t) as 0-d tensors."""
        return (*self._series(self.cfg, state, self.mesh), state.t.clone())

    def fields(self, state) -> dict:
        """This process's tensors of the state: {name: tensor} (a mesh
        process holds one shard: its own)."""
        out = {}
        for k in POPS + ("phi",):
            v = getattr(state, k)
            if v is None:
                continue
            if isinstance(v, list):
                v = next(t for t in v if t is not None)
            out[k] = v
        return out

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def setup(prog: Program, cell, seed: int, traced: bool, timings: dict):
    """The cold start, the seeded perturbation, the equilibrium state, the
    check's buffers and the warm-up of the cell's chunk.  Returns (state,
    keep): keep holds what the check needs of set-up."""
    from ekpnp_torch.init import initialize, state_from_macro
    from ekpnp_torch.ops.poisson import efield
    from ekpnp_torch.state import Macro

    cfg, dev = prog.cfg, prog.device
    n = int(cell.traffic["series_every"])
    with span("setup.cold_start", traced):
        t0 = clock()
        state0, m0 = initialize(cfg, device=dev)
        prog.sync()
        timings["pb_init_s"] = clock() - t0
    phi = state0.phi
    del state0
    with span("setup.perturb", traced):
        d = perturbation(cfg.grid.shape, cell.traffic, seed, dev)
        rho, u, c, cn, temp = apply(m0.rho, m0.u, m0.charge, m0.chargen,
                                    m0.temp, d, cfg.physics.TH)
        del d
        cold = dict(phi=phi.clone(), charge=m0.charge.clone(),
                    chargen=m0.chargen.clone())
        del m0
        state = state_from_macro(cfg, Macro(rho, u, c, cn, temp), phi,
                                 efield(cfg, phi), t=0.0)
        del rho, u, c, cn, temp
    planes = sample_planes(cfg.grid.nz, cell.traffic["init_planes"], seed)
    idx = torch.tensor(planes, device=dev)
    init = {k: torch.index_select(v, -3, idx).clone()
            for k, v in prog.fields(state).items() if k in POPS}
    if prog.mesh is not None:
        from ekpnp_torch.parallel.mesh import shard_state

        state = shard_state(cfg, prog.mesh, state)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    bufs = {side: {k: torch.empty_like(v)
                   for k, v in prog.fields(state).items()}
            for side in ("in", "out")}
    with span("setup.warm", traced):
        _copy(bufs["in"], prog.fields(state))
        state = prog.advance(state, n)
        _copy(bufs["out"], prog.fields(state))
        w = Writer()
        w.submit(-1, prog.series(state))
        w.close()
        prog.sync()
    keep = dict(cold=cold, init=init, planes=planes, bufs=bufs, n=n,
                frac=check_fraction(cell.traffic, seed))
    return state, keep


def _copy(dst: dict, src: dict):
    for k, v in src.items():
        dst[k].copy_(v)


class Stop:
    """When the window ends and which chunk it checks, agreed by every
    process: process 0 decides by its clock and posts the chunk indices a
    few chunks ahead (`lead`, more than any process can run ahead of
    another) on the store; one process needs no store."""

    def __init__(self, store=None, rank: int = 0, lead: int = 0):
        self.store, self.rank, self.lead = store, rank, lead
        self.check = None
        self.last = None

    def _post(self, key, value):
        if self.store is None:
            return value
        self.store.set(key, str(value))
        return value

    def _read(self, key):
        if self.store is None or not self.store.check([key]):
            return None
        return int(self.store.get(key))

    def update(self, i: int, elapsed: float, seconds: float, frac: float):
        """Before launching chunk i."""
        if self.rank == 0:
            if self.check is None and elapsed >= frac * seconds:
                self.check = self._post("check", i + self.lead)
            if (self.last is None and self.check is not None
                    and elapsed >= seconds):
                self.last = self._post("last", max(i + self.lead, self.check))
            return
        if self.check is None:
            self.check = self._read("check")
        if self.last is None:
            self.last = self._read("last")


def window(prog: Program, state, keep: dict, seconds: float, traced: bool,
           stop: Stop, barrier=None):
    """Run chunks for `seconds`; returns (state, result) with the window's
    clock, the chunks and the landed series values."""
    n, bufs = keep["n"], keep["bufs"]
    writer = Writer()
    chunks = 0
    t0 = clock()
    while True:
        stop.update(chunks, clock() - t0, seconds, keep["frac"])
        if stop.last is not None and chunks > stop.last:
            break
        take = stop.check == chunks
        if take:
            _copy(bufs["in"], prog.fields(state))
        with span("chunk", traced):
            state = prog.advance(state, n)
        if take:
            _copy(bufs["out"], prog.fields(state))
        with span("series", traced):
            writer.submit(chunks, prog.series(state))
        chunks += 1
    with span("window.drain", traced):
        prog.sync()
        if barrier is not None:
            barrier()
        t_sync = clock()
        writer.close()
    landed = sorted(writer.landed)
    t_end = max([t_sync] + [t for _, _, t in landed])
    return state, dict(t0=t0, t_end=t_end, seconds=t_end - t0, chunks=chunks,
                       steps=chunks * n, landed=landed, check=stop.check)
