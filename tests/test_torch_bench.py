"""The port's benchmark entry on the CPU: `python -m ekpnp_torch bench`
prints one JSON line with the JAX package's keys (ekpnp/benchmark.py) in
every mode, and the device-memory rate comes from the card's name or
raises."""
import json
import os
import subprocess
import sys

import pytest

import test_torch_common  # noqa: F401  (one torch thread per worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the keys of the JAX package's lines, by mode (ekpnp/benchmark.py)
KEYS = {
    "coupled": {"metric", "value", "unit", "vs_baseline", "spread", "windows",
                "poisson_ms", "ref_parity_all_d3q27_mlups",
                "ref_parity_vs_roofline", "ref_parity_spread",
                "ref_parity_windows", "ref_parity_knobs"},
    "fluid": {"metric", "value", "unit", "vs_baseline", "spread", "windows"},
    "poisson": {"metric", "value", "unit", "vs_baseline"},
    "pbinit": {"metric", "value", "unit", "vs_baseline", "ms_per_iteration",
               "final_relative_update", "compile_s"},
}


def test_bench_prints_one_line_with_the_jax_keys():
    """The default mode through the command line, with its parity
    companion (a second process)."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "ekpnp_torch", "bench", "--device", "cpu",
         "--size", "16", "--steps", "2", "--reps", "2"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert KEYS["coupled"] <= set(out)
    assert out["unit"] == "MLUPS" and out["value"] > 0
    assert out["windows"] == 2 and out["ref_parity_windows"] == 2
    assert "16^3" in out["metric"] and "D3Q7" in out["metric"]
    assert out["vs_baseline"] is None  # no device-memory rate on a CPU
    assert out["device"] == "cpu"


@pytest.mark.parametrize("mode", ["fluid", "poisson", "pbinit"])
def test_bench_modes(capsys, mode):
    from ekpnp_torch.run import main

    assert main(["bench", "--device", "cpu", "--size", "16", "--steps", "2",
                 "--reps", "2", "--mode", mode]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert KEYS[mode] <= set(out) and out["value"] > 0


def test_hbm_bandwidth_by_card_name(monkeypatch):
    from ekpnp_torch.benchmark import _hbm_bandwidth

    monkeypatch.delenv("EKPNP_HBM_BW", raising=False)
    assert _hbm_bandwidth("NVIDIA H100 80GB HBM3") == 3.35e12
    assert _hbm_bandwidth("NVIDIA H100 PCIe") == 2.0e12
    assert _hbm_bandwidth("NVIDIA H100 NVL") == 3.9e12
    for name in ("NVIDIA A100-SXM4-80GB", "NVIDIA H100", "cpu"):
        with pytest.raises(ValueError, match="unknown card"):
            _hbm_bandwidth(name)
    monkeypatch.setenv("EKPNP_HBM_BW", "1.5e12")
    assert _hbm_bandwidth("NVIDIA A100-SXM4-80GB") == 1.5e12
