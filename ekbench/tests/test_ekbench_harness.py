"""The harness on the CPU: a rehearsal of a test cell through the same code
as `ekbench.run` (not in BENCHMARK.json; its numbers carry the
`cpu_rehearsal.` prefix, never a device metric's name), the result line,
the whole-name check for JAX and the JAX package, the refusals, a cell
added with new files alone, the faults that must make `correct` false and
the control at a size a test holds."""
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from ekbench.run import forbidden_modules
from ekbench.tests import rehearse

CODE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELL = ("rehearsal.s10", "rehearsal", "series10", "rehearsal.limits.json")
SEED = 2147483659          # above 2**31, as the driver's are
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _run(args, cwd=CODE, timeout=300):
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, cwd=cwd, timeout=timeout)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return rehearse.make_root(str(tmp_path_factory.mktemp("bench")), [CELL])


def _rehearse(root, *extra, seconds=1.5, cell=CELL[0], seed=SEED):
    out = _run(["-m", "ekbench.tests.rehearse", "--root", root, "--workload",
                cell, "--seed", str(seed), "--seconds", str(seconds), *extra])
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1]), out.stderr


def test_rehearsal_prints_one_result_line(root):
    res, err = _rehearse(root)
    assert list(res)[:len(KEYS)] == KEYS and list(res)[-1] == "checks"
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 1 and res["failed"] == 0
    assert res["device"]["platform"] == "cpu"
    assert set(res["metrics"]) == {"cpu_rehearsal.setup_s",
                                   "cpu_rehearsal.mlups",
                                   "cpu_rehearsal.peak_gib"}
    # every compared number beside its limit, last on standard error
    lines = err.strip().splitlines()[-len(res["checks"]):]
    assert all(re.match(r"check \S+ = .* \(limit .*\)", ln) for ln in lines)


def test_traced_rehearsal_reads_the_per_layer_metrics(root):
    res, _ = _rehearse(root, "--trace", "1")
    assert "cpu_rehearsal.pb_init_s" in res["metrics"]
    assert not any(k.endswith(("mlups", "setup_s")) for k in res["metrics"])
    assert res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_the_same_seed_makes_the_same_inputs():
    import torch

    from ekbench.perturb import check_fraction, perturbation
    from ekbench.tests.rehearse import DATA

    with open(os.path.join(DATA, "..", "..", "traffic", "series10.json")) as f:
        traffic = json.load(f)
    a = perturbation((9, 4, 6), traffic, SEED, "cpu")
    b = perturbation((9, 4, 6), traffic, SEED, "cpu")
    c = perturbation((9, 4, 6), traffic, SEED + 1, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["charge"], c["charge"])
    assert all(float(v[0].abs().max()) == 0 == float(v[-1].abs().max())
               for v in a.values())      # the plates are never touched
    lo, hi = traffic["check_at"]
    assert lo <= check_fraction(traffic, SEED) <= hi


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_a_broken_timed_path_is_not_correct(root, fault):
    res, _ = _rehearse(root, "--fault", fault)
    assert res["correct"] is False, res["checks"]


def test_the_control_fails_and_the_program_passes(root):
    res, err = _rehearse(root, "--control")
    assert res["correct"] is True, res["checks"]
    control = json.loads(next(ln for ln in err.splitlines()
                              if ln.startswith("CONTROL "))[len("CONTROL "):])
    limits = {k: v["limit"] for k, v in res["checks"].items()}
    assert any(control[k] > limits[k] for k in control if k in limits), control


def test_forbidden_names_are_compared_whole(monkeypatch):
    for name in ("ekpnp_torch", "ekpnp_torch.run", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert forbidden_modules() == []
    for name in ("ekpnp", "ekpnp.run", "jax.numpy", "jaxlib", "flax"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert forbidden_modules() == ["ekpnp", "ekpnp.run", "flax", "jax.numpy",
                                   "jaxlib"]


def test_no_jax_after_a_rehearsal(root):
    """What the rehearsal loaded (the harness, the program, the reference)
    holds no JAX and no JAX package: emit() refuses otherwise."""
    code = ("import sys; from ekbench.tests import rehearse; "
            f"rc = rehearse.main(['--root', {root!r}, '--workload', "
            f"{CELL[0]!r}, '--seed', '3', '--seconds', '1']); "
            "import ekbench.reference.lbm, ekbench.calibrate, ekbench.worker; "
            "from ekbench.run import forbidden_modules; "
            "print('LOADED', forbidden_modules(), 'ekpnp_torch' in sys.modules)")
    out = _run(["-c", code])
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LOADED [] True" in out.stdout


def test_the_benchmark_refuses_without_a_card():
    out = _run(["-m", "ekbench.run", "--workload", "thermal27-256.s50",
                "--seed", str(SEED), "--seconds", "1", "--trace", "0"])
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_the_benchmark_refuses_without_the_program(tmp_path):
    shutil.copytree(os.path.join(CODE, "ekbench"), tmp_path / "ekbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(CODE, "BENCHMARK.json"), tmp_path)
    out = _run(["-m", "ekbench.run", "--workload", "thermal27-256.s50",
                "--seed", "1", "--seconds", "1", "--trace", "0"],
               cwd=str(tmp_path))
    assert out.returncode != 0 and out.stdout == ""


def test_a_cell_a_config_and_a_metric_are_new_files_alone(tmp_path):
    """A throwaway configuration, traffic mix, limits and per-layer reader,
    and their entries in BENCHMARK.json: the rehearsal reads them with no
    file of the harness edited."""
    root = rehearse.make_root(str(tmp_path), [CELL])
    bench_dir = os.path.join(root, "ekbench")
    with open(os.path.join(bench_dir, "tests", "data", "rehearsal.json")) as f:
        cfg = json.load(f)
    cfg["name"], cfg["grid"]["nx"] = "throwaway", 8
    with open(os.path.join(bench_dir, "configs", "throwaway.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bench_dir, "traffic", "series10.json")) as f:
        traffic = json.load(f)
    traffic["series_every"] = 5
    with open(os.path.join(bench_dir, "traffic", "series5.json"), "w") as f:
        json.dump(traffic, f)
    shutil.copy(os.path.join(bench_dir, "tests", "data", "rehearsal.limits.json"),
                os.path.join(bench_dir, "limits", "throwaway.s5.json"))
    with open(os.path.join(bench_dir, "metrics", "chunks_seen.py"), "w") as f:
        f.write('UNIT = "1"\nLAYER = "Device"\nMOVES = "mlups"\n\n\n'
                'def read(ctx):\n    return float(ctx.chunks)\n')
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "throwaway", "source": "test",
                             "file": "ekbench/configs/throwaway.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "throwaway.s5", "config": "throwaway",
                               "traffic": "series5", "chips": 1, "why": "t"})
    bench["per_layer"].append({"name": "chunks_seen", "unit": "1",
                               "better": "higher", "source": "host_clock",
                               "layer": "Device", "moves": "mlups",
                               "workloads": ["throwaway.s5"]})
    for m in bench["end_to_end"]:
        m["workloads"] = m.get("workloads", []) + ["throwaway.s5"]
    with open(path, "w") as f:
        json.dump(bench, f)
    res, _ = _rehearse(root, "--trace", "1", cell="throwaway.s5")
    assert res["metrics"]["cpu_rehearsal.chunks_seen"]["value"] == res["attempted"]
    assert res["correct"] is True, res["checks"]


def test_the_manifest_names_files_that_agree_with_it():
    """Every cell's configuration, traffic and limits file exists; every
    per-layer entry has its reader, whose unit, layer and `moves` are the
    entry's; every end-to-end metric a per-layer one moves is reported in
    that metric's cells."""
    from ekbench import manifest

    with open(os.path.join(CODE, "BENCHMARK.json")) as f:
        bench = json.load(f)
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    assert bench["command"][:3] == ["python3", "-m", "ekbench.run"]
    for w in bench["workloads"]:
        cell = manifest.load(w["name"], CODE)
        assert cell.limits and cell.traffic["series_every"] > 0
        assert name.match(w["name"]) and len(w["why"]) <= 200
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        mod = manifest.reader(manifest.load(m["workloads"][0], CODE), m["name"])
        assert (mod.UNIT, mod.LAYER, mod.MOVES) == (m["unit"], m["layer"],
                                                    m["moves"])
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get(
            "workloads", m["workloads"]))
