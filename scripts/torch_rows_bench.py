#!/usr/bin/env python3
"""The x-Hartley row product alone on one NVIDIA card: both forms of
`ekpnp_torch.kernels.fused_step.hartley_rows` against the plain version,
an f64 product and `torch.matmul`.

    python3 scripts/torch_rows_bench.py [--reps N]

Builds the kernel libraries of this checkout, prints the row products'
registers and spill stores (ptxas), then for each shape (rows x NX, f32,
the RHS rows plain and the psi rows lifted):

  - the form the wrapper takes (`hartley_rows_tc`) and its launch counts;
  - max|d| / max|ref| of the tensor-core form (hartley_rows_tf32x3_kernel),
    the FMA form (hartley_rows_kernel, forced) and `torch.matmul` against
    the f64 product of the same f32 inputs, and of each form against the
    plain version (`hartley_rows_reference`, the tolerance 1e-5);
  - times by CUDA events (N launches after one, `ms`; and the same with
    the host's launches queued ahead behind a sleep on the card,
    `device_ms`): the tensor-core form, the FMA form, `torch.matmul` on
    the same (M, NX) rows and H, and the
    bounds: the bytes (rows in and out, H once) over the card's memory
    rate, 2 NX operations per value over 67 TFLOP/s (FP32) and three
    times that over 495 TFLOP/s (TF32 dense).

One line `ROWS {...}` a shape after the card's name and power limit.
Fails (exit 1) if a form differs from the plain version by more than
1e-5 or a launch took another form than the rule says.
"""
import argparse
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (label, rows z, rows y, NX, lifted): the full RHS / psi rows at 256^3,
# slab 8's shard (256x32x257) RHS rows, pod's width, a ragged count
SHAPES = (("rhs 256^3", 255, 256, 256, False),
          ("psi 256^3", 257, 256, 256, True),
          ("rhs slab8", 255, 32, 256, False),
          ("rhs pod", 255, 64, 512, False),
          ("odd 259", 37, 7, 256, True),
          ("nx16", 37, 7, 16, True))
TOL = 1e-5


def _events_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _device_ms(fn, reps):
    """Device time of one call: the card first sleeps while the host queues
    the `reps` calls behind it, so the events time the kernels back to back
    and not the host's pace (a small launch's wrapper takes ~20-30 us on
    the host)."""
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_rows_bench: no CUDA device")
    import ekpnp_torch
    from ekpnp_torch.device import torch_setup
    from ekpnp_torch.kernels import fused_step as fs

    torch_setup()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    fs._load()
    log = fs.build_info["log"]
    for name in re.findall(r"Compiling entry function '(\w*hartley_rows\w*)'",
                           log):
        rest = log[log.index(name):]
        used = re.search(r"Used (\d+) registers", rest)
        spill = re.search(r"(\d+) bytes spill stores", rest)
        print(f"ptxas {name}: {used.group(1) if used else '?'} registers, "
              f"{spill.group(1) if spill else '?'} B spill stores", flush=True)
    for line in log.splitlines():  # ptxas's word on the asynchronous products
        if "wgmma" in line and "ptxas" in line:
            print(line, flush=True)
    bw = 3.35e12
    failed = False
    for label, nz, ny, nx, lifted in SHAPES:
        cfg = ekpnp_torch.preset("reference", nx=nx, ny=ny, nz=nz,
                                 dtype="float32")
        rng = np.random.default_rng(nx + ny)
        a = torch.as_tensor(rng.standard_normal((nz, ny, nx)),
                            dtype=torch.float32, device="cuda")
        lift = cfg if lifted else None
        flat = a.view(-1, nx)
        H = fs._cas(nx, a)
        ref64 = fs.hartley_rows_reference(a.double(), lift=lift)
        plain = fs.hartley_rows_reference(a, lift=lift)
        rel = lambda x, y: float((x.double() - y.double()).abs().max()
                                 / y.double().abs().max())
        fs.reset_launches()
        got = fs.hartley_rows(a, lift=lift)
        counts = {k: v for k, v in fs.launches.items() if v}
        tc = fs.hartley_rows_tc(a.dtype, nx, a.data_ptr(), got.data_ptr())
        fma = fs.hartley_rows(a, lift=lift, fma=True)
        mm = torch.matmul(flat, H).view(a.shape)
        if lifted:
            mm = mm + (plain - fs.hartley_rows_reference(a))
        res = dict(
            shape=label, rows=flat.shape[0], nx=nx, lifted=lifted,
            tc_form=tc, launches=counts,
            err_vs_f64=dict(tf32x3=rel(got, ref64), fma=rel(fma, ref64),
                            matmul=rel(mm, ref64), plain=rel(plain, ref64)),
            err_vs_plain=dict(tf32x3=rel(got, plain), fma=rel(fma, plain)),
            ms={}, device_ms={},
            bound_ms=dict(
                bytes=(2 * a.numel() + nx * nx) * 4 / bw * 1e3,
                fp32=2 * nx * a.numel() / 67e12 * 1e3,
                tf32x3=3 * 2 * nx * a.numel() / 495e12 * 1e3))
        calls = dict(tf32x3=lambda: fs.hartley_rows(a, lift=lift),
                     fma=lambda: fs.hartley_rows(a, lift=lift, fma=True),
                     matmul=lambda: torch.matmul(flat, H))
        for timer, key in ((_events_ms, "ms"), (_device_ms, "device_ms")):
            for k, fn in calls.items():
                res[key][k] = timer(fn, args.reps)
        want = {"hartley_rows_kernel": 1}
        if tc:
            want["hartley_rows_kernel.tf32x3"] = 1
        if (counts != want or max(res["err_vs_plain"].values()) > TOL):
            failed = True
        print("ROWS " + json.dumps(res), flush=True)
    print(smi.stdout.strip().splitlines()[0])
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
