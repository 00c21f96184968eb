"""The port's command line on the CPU: `python -m ekpnp_torch run` writes
the JAX package's artifacts, its checkpoint loads with
`ekpnp.io.checkpoint.load_npz`, and the default device raises without a
card; every kind of --resume, --checkpoint-full, --vtk, --save-scalars,
--profile, `merge --vtk` and the bandwidth line; the steps before the
clock; the writer thread's abort on a non-finite state."""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import test_torch_common  # noqa: F401  (one torch thread per worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cli_run_writes_artifacts_the_jax_package_loads(tmp_path):
    from ekpnp import preset
    from ekpnp.io.checkpoint import load_npz

    out = tmp_path / "run"
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "ekpnp_torch", "run", "reference", "--steps",
         "10", "--device", "cpu", "--precision", "f64", "--outdir", str(out),
         "--set", "nsave=5", "print_current=5"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "Iteration: 10" in proc.stdout and "Mlups" in proc.stdout
    for name in ("data.dat", "umax.dat", "series.csv", "data_end.npz",
                 "data_end.dat"):
        assert (out / name).stat().st_size > 0, name
    rows = (out / "series.csv").read_text().splitlines()
    assert rows[0] == "step,t,umax_uz,umax_mag,current,mean_T"
    assert [r.split(",")[0] for r in rows[1:]] == ["5", "10"]
    zones = (out / "data.dat").read_text().count("ZONE T=")
    assert zones == 3  # initial, step 5, final
    cfg = preset("reference", dtype="float64")
    state = load_npz(str(out / "data_end.npz"), cfg)
    assert np.isfinite(np.asarray(state.f)).all()
    table = np.loadtxt(out / "data_end.dat")
    assert table.shape == (cfg.grid.num_nodes, 12)


def test_cli_device_cuda_raises_without_a_card(tmp_path):
    from ekpnp_torch.run import main

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["run", "reference", "--steps", "2", "--outdir", str(tmp_path)])
    assert not any(tmp_path.iterdir())  # nothing ran, nothing written


def _run(capsys, *argv):
    """`python -m ekpnp_torch` in this process (CPU, f64): (rc, stdout,
    stderr)."""
    from ekpnp_torch.run import main

    rc = main([*argv, "--device", "cpu", "--precision", "f64"])
    out = capsys.readouterr()
    return rc, out.out, out.err


def _series(path):
    with open(path) as fh:
        rows = fh.read().splitlines()
    return {int(r.split(",")[0]): r.split(",")[1:] for r in rows[1:]}


# the plain-RHS route (fft_method "fft"): its chunks equal their steps bit
# for bit, so a run may be cut anywhere and resumed exactly
FFT = ["--set", "fft_method=fft", "nsave=3", "print_current=3"]


@pytest.fixture(scope="module")
def base_runs(tmp_path_factory):
    """reference, 6 steps uninterrupted, and 3 steps, each with the full
    checkpoint; the 3-step run also on a slab-4 mesh."""
    from ekpnp_torch.run import main

    root = tmp_path_factory.mktemp("base")
    out = {}
    for name, steps, extra in (("six", 6, []), ("three", 3, []),
                               ("three_slab4", 3, ["--mesh", "slab",
                                                   "--mesh-devices", "4"])):
        out[name] = root / name
        rc = main(["run", "reference", "--steps", str(steps), "--device",
                   "cpu", "--precision", "f64", "--checkpoint-full",
                   "--outdir", str(out[name]), *FFT, *extra])
        assert rc == 0, name
    return out


def _full_state(path):
    with np.load(path) as d:
        return {k: d[k] for k in d.files}


def test_cli_resume_full_state_continues_exactly(base_runs, tmp_path, capsys):
    """run(6) == run(3) + --resume state_end.npz + run(3), bit for bit."""
    out = tmp_path / "resumed"
    rc, stdout, _ = _run(capsys, "run", "reference", "--steps", "3",
                         "--resume", str(base_runs["three"] / "state_end.npz"),
                         "--checkpoint-full", "--outdir", str(out), *FFT)
    assert rc == 0 and "lossless full-state resume" in stdout
    want = _full_state(base_runs["six"] / "state_end.npz")
    got = _full_state(out / "state_end.npz")
    assert sorted(want) == sorted(got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert _series(out / "series.csv")[3] == \
        _series(base_runs["six"] / "series.csv")[6]


@pytest.mark.parametrize("kind", ["data_end.npz", "data_end.dat"])
def test_cli_resume_macroscopic_checkpoints(base_runs, tmp_path, capsys, kind):
    """The lossy kinds re-equilibrate: the run starts from the loader's
    state and time."""
    from ekpnp_torch import preset
    from ekpnp_torch.io import checkpoint as ckpt

    src = str(base_runs["three"] / kind)
    out = tmp_path / "resumed"
    rc, stdout, _ = _run(capsys, "run", "reference", "--steps", "3",
                         "--resume", src, "--outdir", str(out), *FFT)
    assert rc == 0 and "populations re-equilibrated" in stdout
    six = _series(base_runs["six"] / "series.csv")[6]
    got = _series(out / "series.csv")[3]
    if kind.endswith(".npz"):  # t continues ("%10.6f" in .dat drops it)
        assert got[0] == six[0]
    assert all(np.isfinite(float(v)) for v in got)
    cfg = preset("reference", dtype="float64")
    load = ckpt.load_reference_ascii if kind.endswith(".dat") else ckpt.load_npz
    start = load(src, cfg, device="cpu")
    zone0 = (out / "data.dat").read_text().split("ZONE T=")[1]
    assert zone0.startswith(f'"t={float(start.t):g}"')


@pytest.mark.parametrize("mesh", [None, "pencil"])
def test_cli_resume_sharded_checkpoint_on_another_mesh(base_runs, tmp_path,
                                                       capsys, mesh):
    """A slab-4 state_end.ckpt resumes on pencil 2x2 and with no mesh; the
    result equals the uninterrupted one-device run to the distributed
    solve's roundoff."""
    from ekpnp_torch import preset
    from ekpnp_torch.io import checkpoint as ckpt

    out = tmp_path / "resumed"
    extra = ["--mesh", mesh, "--mesh-devices", "4"] if mesh else []
    rc, stdout, _ = _run(capsys, "run", "reference", "--steps", "3",
                         "--resume", str(base_runs["three_slab4"] /
                                         "state_end.ckpt"),
                         "--checkpoint-full", "--outdir", str(out), *FFT,
                         *extra)
    assert rc == 0 and "per-shard resume" in stdout
    cfg = preset("reference", dtype="float64")
    got = ckpt.load_sharded(str(out / "state_end.ckpt"), cfg, device="cpu") \
        if mesh else ckpt.load_full_npz(str(out / "state_end.npz"), cfg,
                                        device="cpu")
    want = _full_state(base_runs["six"] / "state_end.npz")
    for k, key in (("f", "f_pop"), ("h", "h_pop"), ("hn", "hn_pop"),
                   ("g", "g_pop"), ("phi", "phi"), ("t", "t")):
        np.testing.assert_allclose(getattr(got, k).numpy(), want[key],
                                   rtol=1e-10, atol=1e-13, err_msg=k)


def test_cli_extras_vtk_scalars_profile_merge(tmp_path, capsys):
    """--vtk, --save-scalars, --profile and the bandwidth line; then a
    slab-2 run's `merge --vtk` writes the VTK files the one-device run
    wrote (equal to the distributed solve's roundoff: rtol 1e-9, and 1e-12
    of the field's largest value where a component is near zero)."""
    from ekpnp_torch.io.vtk import read_vtk

    one, two = tmp_path / "one", tmp_path / "two"
    common = ["--steps", "4", "--set", "nsave=2", "print_current=2"]
    rc, stdout, _ = _run(capsys, "run", "reference", *common, "--vtk",
                         "--save-scalars", "--profile", str(one / "prof"),
                         "--outdir", str(one))
    assert rc == 0
    assert "bandwidth:" in stdout and "GiB/s" in stdout
    names = set(os.listdir(one))
    assert {"fields000002.vtk", "fields000004.vtk"} <= names
    assert "fields000000.vtk" not in names  # the first zone has no VTK
    for field in ("rho", "ux", "uy", "uz", "charge", "chargen", "phi", "Ex",
                  "Ey", "Ez", "T"):
        assert f"{field}0002.bin" in names and f"{field}0004.bin" not in names
    assert np.fromfile(one / "rho0002.bin", "<f8").size == 50 * 8 * 51
    trace = json.loads((one / "prof" / "trace.json").read_text())
    assert trace["traceEvents"]
    rc, _, err = _run(capsys, "run", "reference", *common, "--mesh", "slab",
                      "--mesh-devices", "2", "--vtk", "--save-scalars",
                      "--outdir", str(two))
    assert rc == 0
    # under a mesh the dumps are per shard: said once, nothing written
    assert err.count("--vtk and --save-scalars write nothing under --mesh") == 1
    assert not [n for n in os.listdir(two) if n.endswith((".vtk", ".bin"))]
    from ekpnp_torch.run import main

    assert main(["merge", "reference", str(two), "--vtk", "--precision",
                 "f64"]) == 0
    for step in ("000002", "000004"):
        a = read_vtk(str(one / f"fields{step}.vtk"))
        b = read_vtk(str(two / f"fields{step}.vtk"))
        for k in a:
            np.testing.assert_allclose(b[k], a[k], rtol=1e-9,
                                       atol=1e-12 * np.abs(a[k]).max(),
                                       err_msg=f"{step} {k}")


@pytest.mark.parametrize("case", ["mesh", "perturb", "resume"])
def test_cli_warms_before_the_clock(base_runs, tmp_path, capsys, monkeypatch,
                                    case):
    """The library load and the per-chunk warm run before the clock
    starts: under a mesh, with the perturbed first step, and on resume,
    where the first step is the kernel step and unperturbed."""
    import importlib

    from ekpnp_torch import run

    step_mod = importlib.import_module("ekpnp_torch.step")
    events = []
    real_warm, real_step = run._warm, step_mod.step

    def clock():
        events.append("clock")
        return time.perf_counter()

    def warm(advance, state, sizes, dev):
        events.append(("warm", tuple(sorted(sizes))))
        return real_warm(advance, state, sizes, dev)

    def plain_step(cfg, state, perturb=False):
        events.append(("plain step", perturb))
        return real_step(cfg, state, perturb=perturb)

    monkeypatch.setattr(run, "_prepare", lambda dev: events.append("prepare"))
    monkeypatch.setattr(run, "_warm", warm)
    monkeypatch.setattr(run, "_clock", clock)
    monkeypatch.setattr(step_mod, "step", plain_step)
    extra = {"mesh": ["--mesh", "slab", "--mesh-devices", "2"],
             "perturb": [],
             "resume": ["--resume", str(base_runs["three"] / "state_end.npz")],
             }[case]
    rc, _, _ = _run(capsys, "run", "reference", "--steps", "7", "--outdir",
                    str(tmp_path), *extra, "--set", "nsave=3",
                    "print_current=3", "perturb_first_step=true")
    assert rc == 0
    # the step before the clock: steps 1 -> 3 -> 6 -> 7, chunks of 2, 3, 1
    assert events.index("prepare") < events.index(("warm", (1, 2, 3)))
    assert events.index(("warm", (1, 2, 3))) < events.index("clock")
    assert events.count("clock") == 2  # t0 and the end
    # the first step: the perturbed plain step; on resume the kernel step,
    # unperturbed; under a mesh the plain per-shard step (mesh.py), which
    # does not go through ekpnp_torch.step.step
    first = [e for e in events if isinstance(e, tuple)][0]
    assert first == (("plain step", True) if case == "perturb"
                     else ("warm", (1, 2, 3)))
    assert events.count(("plain step", True)) == (case == "perturb")


def test_cli_non_finite_on_the_writer_thread_exits_2(tmp_path, capsys,
                                                      monkeypatch):
    """A non-finite state found by the series event (on the writer thread)
    aborts the run with exit code 2, and --profile's trace of the loop up
    to the abort is written all the same."""
    import threading

    import ekpnp_torch.diagnostics as diag

    real = diag.series_point
    threads = []

    def series_point(cfg, state, mesh=None):
        *vals, _ = real(cfg, state, mesh)
        return (*vals, torch.tensor(False))

    def host(x, events, real_host=None):
        threads.append(threading.current_thread().name)
        return real_host(x, events)

    from ekpnp_torch import run

    monkeypatch.setattr(diag, "series_point", series_point)
    monkeypatch.setattr(run, "_host", lambda x, ev, h=run._host: host(x, ev, h))
    rc, stdout, err = _run(capsys, "run", "reference", "--steps", "6",
                           "--outdir", str(tmp_path), "--set", "nsave=3",
                           "print_current=3", "--profile",
                           str(tmp_path / "prof"))
    assert rc == 2
    assert "non-finite state detected at step 3" in err
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert trace["traceEvents"]
    assert any(t != threading.main_thread().name for t in threads)
