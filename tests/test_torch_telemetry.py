"""The port's spans and counters (ekpnp_torch/telemetry.py) on the CPU, at
16x8x17 in f64: with no profiler running a span enters no annotation,
records no timing event and keeps no record; under a `torch.profiler`
session the time loop, the series point and the cold start record their
spans with their parents, the state comes out bit for bit as untraced,
and each span's host stamp meets its annotation's time in the exported
Chrome trace; the library load and build spans, the launch counter and
the CLI's table."""
import json

import pytest
import torch

import test_torch_common  # noqa: F401  (one torch thread)

from ekpnp_torch import preset, telemetry
from ekpnp_torch.diagnostics import series_point
from ekpnp_torch.init import initialize
from ekpnp_torch.kernels import fused_step as fs
from ekpnp_torch.kernels.step import multi_step

N = 3
P = "ekpnp_torch."
CHUNK_SPANS = {"chunk": 1, "encode": 1, "collide": 1, "solve": N,
               "pass": N - 1, "stream": 1, "decode": 1}
SERIES_SPANS = ("series.macro", "series.reduce", "series.finite")


@pytest.fixture(scope="module")
def cfg():
    return preset("reference", nx=16, ny=8, nz=17, dtype="float64",
                  fft_method="matmul", pb_iters=3)


@pytest.fixture(scope="module")
def start(cfg):
    state, _ = initialize(cfg, device="cpu")
    return state


def _copy(state):
    return state._replace(**{k: None if v is None else v.clone()
                             for k, v in state._asdict().items()})


def _counts():
    return {k: (v.count if v else 0) for k, v in
            ((k, telemetry.stat(P + k))
             for k in [*CHUNK_SPANS, "series", *SERIES_SPANS])}


def _profiled(fn):
    """fn() under a CPU profiler session, after a span with none, as the
    program's own set-up runs before its traced loop (the first span of a
    session after one seen with no profiler starts a new record set);
    returns (its result, the exported Chrome trace)."""
    import os
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    with telemetry.span(P + "test", device=False):
        pass
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        out = fn()
    finally:
        prof.stop()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return out, json.load(f)
    finally:
        os.remove(path)


def test_off_a_span_enters_no_annotation_and_keeps_no_record(cfg, start,
                                                               monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("entered while no profiler runs")

    assert not torch.autograd.profiler._is_profiler_enabled
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    kept = telemetry.records()
    before = _counts()
    state = multi_step(cfg, _copy(start), N)
    series_point(cfg, state)
    initialize(cfg, device="cpu")
    assert [id(r) for r in telemetry.records()] == [id(r) for r in kept]
    after = _counts()
    for name, n in CHUNK_SPANS.items():
        assert after[name] - before[name] == n, name
    for name in ("series", *SERIES_SPANS):
        assert after[name] - before[name] == 1, name
    for name in ("init", "init.cold_fields", "init.pb", "init.equilibria"):
        st = telemetry.stat(P + name)
        assert st is not None and st.seconds >= st.last > 0, name


def test_traced_chunk_and_series_record_their_spans_and_parents(cfg, start):
    def run():
        state = multi_step(cfg, _copy(start), N)
        return state, series_point(cfg, state)

    _profiled(run)
    recs = telemetry.records()
    names = [r.name[len(P):] for r in recs]
    assert all(r.name.startswith(P) for r in recs)
    for name, n in CHUNK_SPANS.items():
        assert names.count(name) == n, name
    chunk = telemetry.records(P + "chunk")[0]
    assert chunk.parent is None and chunk.chunk == 0
    for r in recs:
        if r.name[len(P):] in CHUNK_SPANS and r is not chunk:
            assert r.parent is chunk, r.name
        assert r.start_us <= r.end_us and r.chunk == 0
        assert r.device_ms() is None      # no card: no timing events
    series = telemetry.records(P + "series")
    assert len(series) == 1 and series[0].parent is None
    assert [r.name[len(P):] for r in recs if r.parent is series[0]] == \
        list(SERIES_SPANS)
    # the next session after the program ran untraced keeps a new set
    series_point(cfg, start)
    _profiled(lambda: series_point(cfg, start))
    assert [r.name for r in telemetry.records()] == [
        P + "series", *(P + s for s in SERIES_SPANS)]


def test_a_traced_chunk_equals_an_untraced_one_bit_for_bit(cfg, start):
    plain = multi_step(cfg, _copy(start), N)
    traced, _ = _profiled(lambda: multi_step(cfg, _copy(start), N))
    for k in ("f", "h", "hn", "g", "phi", "t"):
        assert torch.equal(getattr(plain, k), getattr(traced, k)), k
    assert telemetry.records(P + "solve")


def _misses(trace) -> list:
    """The latest records whose start or end is 50 us or more from their
    annotation's in the exported trace (the n-th record of a name against
    the n-th annotation of that name), as (name, start us, end us)."""
    base_us = trace.get("baseTimeNanoseconds", 0) * 1e-3
    ann = {}
    for e in trace["traceEvents"]:
        if e.get("cat") == "user_annotation" and e.get("ph") == "X":
            ann.setdefault(e["name"], []).append(e)
    recs = telemetry.records()
    assert len(recs) > 10
    out = []
    for name in {r.name for r in recs}:
        mine = [r for r in recs if r.name == name]
        theirs = sorted(ann.get(name, []), key=lambda e: e["ts"])
        assert len(theirs) == len(mine), name
        for r, e in zip(mine, theirs):
            start = e["ts"] + base_us - r.start_us
            end = e["ts"] + e["dur"] + base_us - r.end_us
            if abs(start) >= 50 or abs(end) >= 50:
                out.append((name, start, end))
    return out


def test_stamps_meet_the_chrome_trace_within_50_us(cfg, start):
    """Every span's start and end stamps lie within 50 us of its
    annotation's.  A thread preempted between a stamp and the annotation's
    own clock read moves that one span by the preemption, so a run is
    repeated, at most twice, when one misses; the collector stays off
    during the runs."""
    import gc

    def run():
        state = multi_step(cfg, _copy(start), N)
        series_point(cfg, state)
        initialize(cfg, device="cpu")

    gc.collect()
    gc.disable()
    runs = []
    try:
        while len(runs) < 3 and [] not in runs:
            runs.append(_misses(_profiled(run)[1]))
    finally:
        gc.enable()
    assert [] in runs, runs


def test_counters_launches_and_the_table(cfg, start, monkeypatch):
    assert fs.launches is telemetry.launches
    assert fs.reset_launches is telemetry.reset_launches
    assert set(fs.KERNELS) <= set(fs.launches)
    monkeypatch.setitem(fs.launches, "stream_bc_kernel", 5)
    fs.reset_launches()
    assert not any(fs.launches.values())
    monkeypatch.setattr(telemetry, "counters", {})
    telemetry.count(P + "collective.calls.ring_shift")
    telemetry.count(P + "collective.calls.ring_shift", 2)
    telemetry.count(P + "collective.bytes.ring_shift", 96)
    assert telemetry.counters == {P + "collective.calls.ring_shift": 3,
                                  P + "collective.bytes.ring_shift": 96}
    _profiled(lambda: multi_step(cfg, _copy(start), N))
    lines = telemetry.table(N, {P + "collective.bytes.ring_shift": 6},
                            (P + "init.pb", P + "never")).splitlines()
    rows = {ln.split()[0]: ln.split() for ln in lines[1:]}
    assert rows[P + "chunk"][1] == "1"
    assert rows[P + "solve"][1] == str(N) and rows[P + "solve"][3] == "-"
    assert float(rows[P + "collective.calls.ring_shift"][1]) == 1.0
    assert float(rows[P + "collective.bytes.ring_shift"][1]) == 30.0
    # the set-up spans that ran before the session: count, total, first
    st = telemetry.stat(P + "init.pb")
    assert rows[P + "init.pb"][1] == str(st.count)
    assert float(rows[P + "init.pb"][3]) == pytest.approx(st.first, abs=1e-4)
    assert P + "never" not in rows
    # a child line sits under its parent, indented
    chunk_at = next(i for i, ln in enumerate(lines) if P + "chunk" in ln)
    solve = next(ln for ln in lines if P + "solve" in ln)
    assert lines.index(solve) > chunk_at and solve.startswith("    ")


def test_the_library_load_and_its_build_are_spans(tmp_path, monkeypatch):
    """The first, loading call of `_load` is the ekpnp_torch.load span,
    nvcc (where the source has no build) its ekpnp_torch.build child, whose
    seconds build_info keeps; later calls and a cached build add none."""
    monkeypatch.setattr(fs, "_libs", None)
    monkeypatch.setattr(fs, "library_path",
                        lambda real: str(tmp_path / f"lib_{real}.so"))

    def compile_(todo, paths):
        for k in todo:
            open(paths[k], "w").close()
        return {k: "log" for k in todo}

    monkeypatch.setattr(fs, "_compile", compile_)
    monkeypatch.setattr(fs, "_open_libs", lambda: (fs.build(), {})[1])
    n_load = getattr(telemetry.stat(P + "load"), "count", 0)
    n_build = getattr(telemetry.stat(P + "build"), "count", 0)
    assert fs._load() == {} and fs._load() == {}
    assert telemetry.stat(P + "load").count == n_load + 1
    assert telemetry.stat(P + "build").count == n_build + 1
    assert fs.build_info["seconds"] == telemetry.stat(P + "build").last
    fs.build()          # cached: no span, 0 s
    assert telemetry.stat(P + "build").count == n_build + 1
    assert fs.build_info["seconds"] == 0.0


def test_spans_on_threads_of_their_own_lose_no_count(monkeypatch):
    """Eight threads, each with a span name of its own, with the switch
    interval shortened: every name counts each of its spans, with no
    profiler and under one (which keeps a record of every span)."""
    import sys
    import threading

    names = [f"{P}stress.{i}" for i in range(8)]
    for name in names:
        monkeypatch.delitem(telemetry._stats, name, raising=False)

    def work(name):
        for _ in range(100):
            with telemetry.span(name, device=False):
                pass

    def run_threads():
        threads = [threading.Thread(target=work, args=(n,)) for n in names]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        run_threads()
        _profiled(run_threads)
    finally:
        sys.setswitchinterval(interval)
    assert [telemetry.stat(n).count for n in names] == [200] * 8
    recs = telemetry.records()
    assert sorted({r.name for r in recs}) == names and len(recs) == 800
    assert all(r.parent is None for r in recs)
