"""The readers of the program's own spans (`ekpnp_torch.telemetry`) on the
CPU: their arithmetic on synthetic records beside a synthetic trace, the
harness's attribution unchanged by the program's annotations nested in
its spans, and a traced rehearsal that reads them or nothing."""
import math

import pytest

from ekbench import trace
from ekbench.tests.test_ekbench_harness import CELL, _rehearse, root  # noqa: F401
from ekbench.tests.test_ekbench_metrics import _ctx, _events, _reader

BASE = 1.79e15        # the host clock's microseconds at the trace's zero
NEW = ("solve_span_ms", "series_macro_ms", "idle_loop_pct", "load_s",
       "first_chunk_s")
OLD = ("idle_pct", "solve_ms", "series_ms", "nccl_ms.4card",
       "fused_pass_roofline", "step_mfu", "pb_init_s")


class _Events:
    """A pair of timing events `ms` apart."""

    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, other):
        return self.ms


def _records():
    """The program's spans in the synthetic window (trace time + BASE + 2
    us): a chunk over the harness's chunk [0, 300] with two solves of 0.4
    and 0.6 ms on the card, a series over the harness's series [300, 320]
    with its macro pass (20 ms)."""
    from ekpnp_torch.telemetry import Record

    at = lambda t: BASE + 2 + t
    chunk = Record("ekpnp_torch.chunk", None, 0, at(0), at(294), None)
    solve1 = Record("ekpnp_torch.solve", chunk, 0, at(96), at(174),
                    (_Events(0.4), None))
    passes = Record("ekpnp_torch.pass", chunk, 0, at(176), at(200), None)
    solve2 = Record("ekpnp_torch.solve", chunk, 0, at(200), at(260),
                    (_Events(0.6), None))
    series = Record("ekpnp_torch.series", None, 0, at(299), at(313), None)
    macro = Record("ekpnp_torch.series.macro", series, 0, at(300), at(306),
                   (_Events(20.0), None))
    return [chunk, solve1, passes, solve2, series, macro]


@pytest.fixture
def program(monkeypatch):
    """The telemetry module holding the synthetic records and host
    seconds: the load 0.8 s of which the build 0.5, the first chunk 1.25."""
    from ekpnp_torch import telemetry

    stats = {}
    for name, first in (("ekpnp_torch.load", 0.8), ("ekpnp_torch.build", 0.5),
                        ("ekpnp_torch.chunk", 1.25)):
        stats[name] = telemetry.Stat()
        stats[name].count, stats[name].first = 1, first
    monkeypatch.setattr(telemetry, "_stats", stats)
    monkeypatch.setattr(telemetry, "_records", _records())
    return telemetry


def test_the_new_readers_on_synthetic_records(program):
    ctx = _ctx(trace.Trace(_events()))
    read = lambda name: _reader(name).read(ctx)
    assert read("solve_span_ms") == pytest.approx((0.4 + 0.6) / 2)
    assert read("series_macro_ms") == pytest.approx(20.0)
    # the device's gaps 110-120, 170-180 (in a solve), 280-290 began in the
    # chunk (mapped to [0, 294]), 300-310 in the series' macro pass ([300,
    # 306]); 320-400, 410-430, 450-460 and 470-600 after both
    assert read("idle_loop_pct") == pytest.approx(100 * 40 / 1000)
    assert read("idle_loop_pct") <= read("idle_pct")
    assert read("load_s") == pytest.approx(0.3)
    assert read("first_chunk_s") == 1.25
    idle = _reader("idle_loop_pct")
    tr = ctx.trace
    off = idle.offset(tr, program.records())
    assert off == pytest.approx(BASE + 2)
    split = idle.by_span(tr, program.records(), off)
    assert split == pytest.approx({"ekpnp_torch.solve": 20.0,
                                   "ekpnp_torch.chunk": 10.0,
                                   "ekpnp_torch.series.macro": 10.0,
                                   idle.OUTSIDE: 80 + 20 + 10 + 130})
    del program._stats["ekpnp_torch.build"]
    assert read("load_s") == pytest.approx(0.8)


def test_the_new_readers_read_nothing_where_nothing_was_recorded(
        program, monkeypatch):
    ctx = _ctx(trace.Trace(_events()))
    monkeypatch.setattr(program, "_records", [])
    monkeypatch.setattr(program, "_stats", {})
    for name in NEW:
        assert _reader(name).read(ctx) is None, name
    # a program without the telemetry module (the parent of this reader)
    import sys

    import ekpnp_torch

    monkeypatch.delattr(ekpnp_torch, "telemetry")
    monkeypatch.setitem(sys.modules, "ekpnp_torch.telemetry", None)
    for name in NEW:
        assert _reader(name).read(ctx) is None, name


def _nested(evs):
    """The synthetic trace with the program's annotations inside the
    harness's spans: its chunk (the GEMM's launch at 30 inside a solve),
    its series, a macro pass inside that."""
    extra = [("ekpnp_torch.session", 0.5, 0), ("ekpnp_torch.chunk", 1, 298),
             ("ekpnp_torch.collide", 2, 20), ("ekpnp_torch.solve", 25, 10),
             ("ekpnp_torch.pass", 38, 20), ("ekpnp_torch.series", 301, 18),
             ("ekpnp_torch.series.macro", 302, 6)]
    return evs + [{"ph": "X", "cat": "user_annotation", "name": n, "ts": ts,
                   "dur": dur} for n, ts, dur in extra]


def test_the_programs_annotations_change_no_harness_reading():
    plain = trace.Trace(_events())
    nested = trace.Trace(_nested(_events()))
    assert nested.kernels == plain.kernels
    assert nested.breakdown() == plain.breakdown()
    for name in OLD:
        a = _reader(name).read(_ctx(plain))
        b = _reader(name).read(_ctx(nested))
        assert a == b and a is not None, name


def test_traced_rehearsal_reads_the_new_metrics_or_nothing(root):  # noqa: F811
    res, _ = _rehearse(root, "--trace", "1")
    got = res["metrics"]
    for name in NEW:
        v = got.get("cpu_rehearsal." + name)
        assert v is None or math.isfinite(v["value"]), name
    # the host-clock reading needs no card; the device ones read nothing
    assert got["cpu_rehearsal.first_chunk_s"]["value"] > 0
    for name in ("solve_span_ms", "series_macro_ms", "load_s"):
        assert "cpu_rehearsal." + name not in got, name
