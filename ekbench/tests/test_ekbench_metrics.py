"""The metric arithmetic on the CPU: attribution of a synthetic profiler
trace to the harness's spans, the per-layer readers on it, the byte
accounting, and the end-to-end rate and tail."""
import dataclasses
import importlib.util
import os

import pytest

from ekbench import accounting, cell, trace

HERE = os.path.dirname(os.path.abspath(__file__))
METRICS = os.path.join(os.path.dirname(HERE), "metrics")


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        "m_" + name.replace(".", "_"), os.path.join(METRICS, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _events():
    """A window [0, 1000] us: chunk span [0, 300] launches a collide
    (10-110), a GEMM of the solve (120-170), a pass (180-280) and two row
    products (290-300, 310-320, launched at host 60 and 250); a series span
    [300, 320] launches two reductions (400-410, 430-450); a copy 460-470;
    an NCCL kernel outside any span (600-650)."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "window", "ts": 0, "dur": 1000},
        {"ph": "X", "cat": "user_annotation", "name": "chunk", "ts": 0, "dur": 300},
        {"ph": "X", "cat": "user_annotation", "name": "series", "ts": 300, "dur": 20},
    ]
    launches = [  # (corr, host ts, kernel name, start, dur)
        (1, 5, "void collide_kernel<float, 27, 27>(Args)", 10, 100),
        (2, 30, "ampere_sgemm_128x64_nn", 120, 50),
        (3, 40, "void fused_pass_kernel<float, 27, 27>(Args)", 180, 100),
        (4, 60, "void hartley_rows_tf32x3_kernel<float>(Args)", 290, 10),
        (5, 250, "void hartley_rows_tf32x3_kernel<float>(Args)", 310, 10),
        (6, 305, "reduce_kernel", 400, 10),
        (7, 310, "reduce_kernel", 430, 20),
        (8, 500, "ncclDevKernel_SendRecv(ncclDevComm*)", 600, 50),
    ]
    # torch.distributed's own annotations nest inside the harness's spans
    ev += [{"ph": "X", "cat": "user_annotation", "name": "nccl:send",
            "ts": 6 + 2 * i, "dur": 1} for i in range(12)]
    for corr, host, name, start, dur in launches:
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                   "ts": host, "dur": 1, "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": "kernel", "name": name, "ts": start,
                   "dur": dur, "args": {"correlation": corr}})
    ev.append({"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH",
               "ts": 460, "dur": 10, "args": {}})
    return ev


def _ctx(tr, **kw):
    base = dict(trace=tr, n=2, chunks=1, steps=2, series=1,
                shape=(257, 256, 256), local_shape=(257, 256, 256), q_f=27,
                q_s=27, itemsize=4, bandwidth=3.35e12, pb_init_s=1.5)
    base.update(kw)
    return cell.Context(**base)


def test_kernels_are_attributed_to_the_span_that_launched_them():
    tr = trace.Trace(_events())
    spans = {k[0].split("<")[0].split("(")[0].replace("void ", ""): k[3]
             for k in tr.kernels}
    assert spans["collide_kernel"] == "chunk"
    assert spans["fused_pass_kernel"] == "chunk"
    assert spans["reduce_kernel"] == "series"
    assert spans["ncclDevKernel_SendRecv"] is None
    assert tr.window_us == 1000
    assert tr.busy_us == 100 + 50 + 100 + 10 + 10 + 10 + 20 + 10 + 50
    assert tr.busy_in("chunk") == 270
    assert tr.instances("series") == [(400, 450)]
    b = tr.breakdown()
    assert b["device_ops"][0][0] in ("collide_kernel", "fused_pass_kernel")
    assert b["idle_gaps"][0][1] == pytest.approx(130e-6)   # 470 -> 600


def test_readers_on_the_synthetic_trace():
    tr = trace.Trace(_events())
    ctx = _ctx(tr)
    assert _reader("idle_pct").read(ctx) == pytest.approx(100 * (1 - 360 / 1000))
    # everything in the chunk but the collide and the pass: GEMM + rows
    assert _reader("solve_ms").read(ctx) == pytest.approx((50 + 10 + 10) * 1e-3 / 2)
    assert _reader("series_ms").read(ctx) == pytest.approx(50e-3)
    assert _reader("nccl_ms.4card").read(ctx) == pytest.approx(50e-3 / 2)
    bound = accounting.pass_bytes(27, 27, 4, (257, 256, 256)) / 3.35e12
    assert _reader("fused_pass_roofline").read(ctx) == pytest.approx(
        100 * bound / (100e-6 + 2 * 10e-6))
    floor = 872 * 257 * 256 * 256 * 2 / 3.35e12
    assert _reader("step_mfu").read(ctx) == pytest.approx(100 * floor / 270e-6)
    assert _reader("pb_init_s").read(ctx) == 1.5
    # a reader that finds nothing returns nothing, never 0
    empty = trace.Trace([_events()[0]])
    for name in ("fused_pass_roofline", "fused_pass_rows_roofline",
                 "step_mfu", "solve_ms", "series_ms", "nccl_ms.4card"):
        assert _reader(name).read(_ctx(empty)) is None, name


def test_byte_accounting_matches_the_ports_bounds():
    assert accounting.step_bytes_per_node(27, 27, 4) == 872
    assert accounting.step_bytes_per_node(27, 7, 4) == 392
    ms = lambda b: b / 3.35e12 * 1e3
    shape = (257, 256, 256)
    assert ms(accounting.pass_bytes(27, 27, 4, shape, phi_hx=False)) == pytest.approx(4.384, abs=1e-3)
    assert ms(accounting.pass_bytes(27, 27, 4, shape)) == pytest.approx(4.464, abs=1e-3)
    assert ms(accounting.pass_bytes(27, 7, 4, shape)) == pytest.approx(2.051, abs=1e-3)
    pod = accounting.pass_bytes(27, 27, 4, (257, 64, 512), shard=True)
    assert ms(pod) == pytest.approx(2.244, abs=1e-3)
    assert accounting.hbm_bandwidth("NVIDIA H100 80GB HBM3") == 3.35e12
    with pytest.raises(ValueError):
        accounting.hbm_bandwidth("some other card")


@dataclasses.dataclass
class _Cell:
    end_to_end: list


def test_rate_is_all_the_work_over_all_the_time_and_the_tail_every_gap():
    class Grid:
        num_nodes = 1000

    class Cfg:
        grid = Grid()

    # 301 series points: 300 gaps, 280 of 10 ms and 20 of 100 ms, which a
    # median of chunk times would never show
    times = [0.0]
    for i in range(300):
        times.append(times[-1] + (0.1 if i % 15 == 7 else 0.01))
    landed = [(i, [0.0] * 6, t) for i, t in enumerate(times)]
    win = dict(t0=-1.0, steps=3010, seconds=times[-1] + 1.0, landed=landed)
    names = ["setup_s", "mlups", "series_gap_ms_p95", "peak_gib"]
    c = _Cell([{"name": n, "unit": "u"} for n in names])
    got = cell.end_to_end(c, Cfg(), -3.0, win, 2 ** 31)
    assert got["mlups"]["value"] == pytest.approx(1000 * 3010 / win["seconds"] / 1e6)
    assert got["setup_s"]["value"] == pytest.approx(2.0)
    assert got["peak_gib"]["value"] == 2.0
    assert got["series_gap_ms_p95"]["value"] == pytest.approx(100.0)
    short = dict(win, landed=landed[:150])
    assert "series_gap_ms_p95" not in cell.end_to_end(c, Cfg(), -3.0, short, 0)
