"""The North star's end-to-end anchors through the port (CPU, the port's
time loop: the kernels' plain versions): the 1000-step reference
experiment through the command line, held to the JAX package's pinned
series tail (tests/test_production_run.py) at rtol 1e-8, and the f32
envelope against f64 over the 200 steps of tests/test_precision.py, with
that file's gates.

The 1000-step run takes about 150 s on one CPU thread, so it is marked
`slow` and left out of the tier-1 run; chip_smoke.py runs it on the card
in every call (phase a)."""
import csv
import os
import subprocess
import sys

import numpy as np
import pytest

import test_torch_common  # noqa: F401  (one torch thread per worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NSTEPS = 200


@pytest.mark.slow
def test_reference_experiment_end_to_end(tmp_path):
    from test_production_run import _PINNED_TAIL

    out = tmp_path / "ref1000"
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "ekpnp_torch", "run", "reference", "--steps",
         "1000", "--device", "cpu", "--precision", "f64", "--checkpoint-full",
         "--set", "perturb_first_step=True", "--outdir", str(out)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-2000:]
    for name in ("data.dat", "umax.dat", "series.csv", "data_end.npz",
                 "data_end.dat", "state_end.npz"):
        assert (out / name).stat().st_size > 0, name
    with open(out / "data.dat") as f:
        assert sum(1 for line in f if line.startswith("ZONE")) == 3
    with open(out / "series.csv") as f:
        rows = {int(row["step"]): row for row in csv.DictReader(f)}
    for step, want in _PINNED_TAIL.items():
        got = [float(rows[step][k]) for k in ("umax_uz", "umax_mag", "current")]
        np.testing.assert_allclose(got, want, rtol=1e-8, err_msg=str(step))


@pytest.fixture(scope="module")
def envelope():
    """series point after NSTEPS steps of the port's time loop, f64 and
    f32, from the reference cold start."""
    import ekpnp_torch
    from ekpnp_torch.diagnostics import series_point
    from ekpnp_torch.init import initialize
    from ekpnp_torch.kernels.step import multi_step

    out = {}
    for dt in ("float64", "float32"):
        cfg = ekpnp_torch.preset("reference", dtype=dt)
        state, _ = initialize(cfg, device="cpu")
        state = multi_step(cfg, state, NSTEPS)
        um, umag, cur, mt, finite = (float(x) for x in series_point(cfg, state))
        assert finite
        out[dt] = dict(umax=um, umag=umag, current=cur, mean_t=mt)
    return out


def test_f32_envelope_current(envelope):
    """test_precision.py's gate (the JAX package measured 2.0e-5; the port
    2.2e-5)."""
    a, b = envelope["float64"], envelope["float32"]
    rel = abs(a["current"] - b["current"]) / abs(a["current"])
    assert rel < 1e-4, f"current rel diff {rel:.2e}"


def test_f32_envelope_mean_temperature(envelope):
    """test_precision.py's gate (measured: 1.2e-4 in both packages)."""
    a, b = envelope["float64"], envelope["float32"]
    rel = abs(a["mean_t"] - b["mean_t"]) / abs(a["mean_t"])
    assert rel < 5e-4, f"mean T rel diff {rel:.2e}"


def test_f32_envelope_umax_at_resolution_floor(envelope):
    """test_precision.py's gates (measured: 7.5e-7 absolute in both)."""
    a, b = envelope["float64"], envelope["float32"]
    assert abs(a["umax"] - b["umax"]) < 2e-6
    assert abs(a["umax"] - b["umax"]) / abs(a["umax"]) < 0.25


def test_f64_resolves_subfloor_transverse_flow(envelope):
    a, b = envelope["float64"], envelope["float32"]
    assert a["umag"] > 2 * a["umax"]
    assert b["umag"] < 1.5 * b["umax"]
