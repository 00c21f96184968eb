"""The port's command line on the CPU: `python -m ekpnp_torch run` writes
the JAX package's artifacts, its checkpoint loads with
`ekpnp.io.checkpoint.load_npz`, and the default device raises without a
card."""
import os
import subprocess
import sys

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
