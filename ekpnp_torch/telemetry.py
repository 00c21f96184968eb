"""Spans and counters of the port: where its host time goes, and, while a
`torch.profiler` session runs, where its card time goes.

  span(name)       a context manager around one piece of the program's
                   work; `with span(...) as s:` leaves its host seconds in
                   `s.seconds`;
  count(name, k)   adds k to a counter;
  launches         the kernel launches of each form on the card
                   (kernels/fused_step.py counts them where it launches).

Every name starts with `ekpnp_torch.`, clear of the names a caller's own
spans take.  The program's spans sit at its layer boundaries: the library
load and build, the cold start, the time loop's chunk and its pieces (at
most one of each a step), the series point and its pieces, the exchanges
and collectives of a mesh, and the CLI's dumps, writer and drain.

Off (no profiler session): a span reads the host clock twice and adds the
seconds to its name's `Stat` (count, total, the first and the last
instance); nothing else.  On (between a profiler's start and stop, as
`torch.autograd.profiler._is_profiler_enabled` says): a span also enters
`torch.profiler.record_function(name)`, so it appears in the profiler's
trace, and keeps a `Record` of its instance: its parent (the innermost
span open on its thread), the chunk it ran in, its host start (read on
both sides of the annotation's own) and end on the trace's clock
(`time.time_ns()` in microseconds: the exported Chrome trace's `ts` plus
its base time), and on the card a pair of timing events
on the current stream.  The first span of a session after a span that saw
no session starts a new record set (so a traced loop's records exclude its
untraced set-up's and an earlier session's); `records()` reads it, the
events once the card has been synchronised.  A name's `Stat` is updated
without a lock: the spans of one name run on one thread (the CLI's writer
thread has a name of its own); records are appended from any thread.
"""
from __future__ import annotations

import threading
import time
from typing import Optional

import torch
import torch.autograd.profiler as _profiler

PREFIX = "ekpnp_torch."
CHUNK = PREFIX + "chunk"
# an empty annotation that opens each session's record set: the first
# annotation of a session (of a process: ~1 ms) is slow to reach its
# timestamp, and the spans' stamps are to meet the trace's
SESSION = PREFIX + "session"

# the launches of each kernel form on the card, counted where it is
# launched (kernels/fused_step.py names the forms)
launches: dict = {}
# counters by name, over the process's life
counters: dict = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def count(name: str, k: int = 1) -> None:
    counters[name] = counters.get(name, 0) + k


class Stat:
    """A span name's host seconds over the process's life."""

    __slots__ = ("count", "seconds", "first", "last")

    def __init__(self):
        self.count, self.seconds, self.first, self.last = 0, 0.0, 0.0, 0.0


class Record:
    """One instance of a span under a profiler session.  start_us, end_us:
    host time.time_ns() in microseconds; events: (start, end) timing events
    on the card, or None."""

    __slots__ = ("name", "parent", "chunk", "start_us", "end_us", "events",
                 "_rf")

    def __init__(self, name: str, parent: Optional["Record"], chunk: int,
                 start_us: float, end_us: float = float("nan"),
                 events=None):
        self.name, self.parent, self.chunk = name, parent, chunk
        self.start_us, self.end_us, self.events = start_us, end_us, events
        self._rf = None

    def device_ms(self) -> Optional[float]:
        """Milliseconds on the card between the span's events (its work and
        any wait for the host inside it), or None off the card."""
        if self.events is None:
            return None
        return self.events[0].elapsed_time(self.events[1])


_stats: dict = {}
_records: list = []
_session = {"on": False, "chunk": -1}
_lock = threading.Lock()
_local = threading.local()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class span:
    """A span of the program (see the module's docstring).  device=False:
    no timing events, for a span of host work alone."""

    __slots__ = ("name", "device", "seconds", "_t0", "_rec")

    def __init__(self, name: str, device: bool = True):
        self.name, self.device = name, device
        self.seconds = 0.0

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            if not _session["on"]:
                _new_session()
            self._rec = _open(self.name, self.device)
        else:
            self._rec = None
            _session["on"] = False
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = dt = time.perf_counter() - self._t0
        st = _stats.get(self.name)
        if st is None:
            st = _stats[self.name] = Stat()
            st.first = dt
        st.count += 1
        st.seconds += dt
        st.last = dt
        if self._rec is not None:
            _close(self._rec)
        return False


def _new_session() -> None:
    """A new profiler session: a new record set (once, whichever thread's
    span sees it first)."""
    with _lock:
        if _session["on"]:
            return
        _records.clear()
        _session["chunk"] = -1
        with torch.profiler.record_function(SESSION):
            pass
        _session["on"] = True


def _open(name: str, device: bool) -> Record:
    if name == CHUNK:
        _session["chunk"] += 1
    stack = _stack()
    rf = torch.profiler.record_function(name)
    before = time.time_ns()
    rf.__enter__()    # the annotation reads its clock inside, a few us in
    rec = Record(name, stack[-1] if stack else None, _session["chunk"],
                 (before + time.time_ns()) * 0.5e-3)
    rec._rf = rf
    if device and torch.cuda.is_initialized():
        # after the stamp: a full launch queue may hold the host here
        stream = torch.cuda.current_stream()
        rec.events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True), stream)
        rec.events[0].record(stream)
    stack.append(rec)
    _records.append(rec)
    return rec


def _close(rec: Record) -> None:
    rec._rf.__exit__(None, None, None)
    rec._rf = None
    rec.end_us = time.time_ns() * 1e-3
    if rec.events is not None:
        start, end, stream = rec.events
        end.record(stream)
        rec.events = (start, end)
    stack = _stack()
    if stack and stack[-1] is rec:
        stack.pop()


def stat(name: str) -> Optional[Stat]:
    """The host seconds of every instance of span `name`, or None if none
    ran."""
    return _stats.get(name)


def records(name: Optional[str] = None) -> list:
    """The spans of the latest profiler session (those named `name`), in
    the order they began."""
    if name is None:
        return list(_records)
    return [r for r in _records if r.name == name]


def _path(rec: Record) -> tuple:
    names = []
    while rec is not None:
        names.append(rec.name)
        rec = rec.parent
    return tuple(reversed(names))


def table(steps: int, before: Optional[dict] = None, setup=()) -> str:
    """The latest profiler session's spans, each under its parent: count,
    host seconds, device milliseconds and self seconds (host seconds less
    its children's); then every counter per step, less its value in
    `before` (a copy of `counters` taken when the steps began), and the
    launches; then the host seconds of the spans named in `setup`, which
    ran before the session (count, total, first instance)."""
    rows, first = {}, {}
    for r in _records:
        path = _path(r)
        row = rows.setdefault(path, [0, 0.0, None, 0.0])
        first.setdefault(path, len(first))
        host = (r.end_us - r.start_us) * 1e-6
        ms = r.device_ms()
        row[0] += 1
        row[1] += host
        if ms is not None:
            row[2] = (row[2] or 0.0) + ms
        row[3] += host
        if path[:-1] in rows:
            rows[path[:-1]][3] -= host
    place = lambda path: [first.get(path[:i + 1], len(first))
                          for i in range(len(path))]
    out = [f"  {'span':<44} {'count':>7} {'host s':>10} {'device ms':>11} "
           f"{'self s':>10}"]
    for path in sorted(rows, key=place):
        n, host, ms, own = rows[path]
        name = "  " * (len(path) - 1) + path[-1]
        ms = "-" if ms is None else f"{ms:.3f}"
        out.append(f"  {name:<44} {n:>7} {host:>10.4f} {ms:>11} "
                   f"{own:>10.4f}")
    per = lambda v: v / steps if steps > 0 else float("nan")
    before = before or {}
    counts = {k: v - before.get(k, 0) for k, v in counters.items()}
    counts.update((f"{PREFIX}launches.{k}", v) for k, v in launches.items())
    counts = {k: v for k, v in counts.items() if v}
    if counts:
        out.append(f"  {'counter':<44} {'per step':>12}")
        out += [f"  {k:<44} {per(v):>12.6g}" for k, v in sorted(counts.items())]
    ran = [(name, _stats[name]) for name in setup if name in _stats]
    if ran:
        out.append(f"  {'set-up span':<44} {'count':>7} {'host s':>10} "
                   f"{'first s':>11}")
        out += [f"  {name:<44} {st.count:>7} {st.seconds:>10.4f} "
                f"{st.first:>11.4f}" for name, st in ran]
    return "\n".join(out)
