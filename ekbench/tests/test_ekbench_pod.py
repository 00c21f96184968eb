"""The pod's path on the CPU: a slab mesh over 2 Gloo processes at 32x16x17
(process 0 starts the other itself, as on 4 NCCL cards), held to the
reference; the edge exchange left out must make `correct` false.  The
manifest gains the pod's metrics as entries alone, as the pod cell will."""
import json
import os
import subprocess
import sys

import pytest

from ekbench.tests import rehearse

CODE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELL = ("rehearsal-pod.s10", "rehearsal-pod", "series10",
        "rehearsal.limits.json")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = rehearse.make_root(str(tmp_path_factory.mktemp("pod")), [CELL])
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["end_to_end"].append({"name": "mlups_4card", "unit": "MLUPS",
                                "better": "higher", "bound": 0.25,
                                "source": "host_clock", "workloads": [CELL[0]]})
    for name in ("nccl_ms.4card", "idle_pct.4card", "step_mfu.4card",
                 "solve_ms.4card", "fused_pass_rows_roofline"):
        bench["per_layer"].append({"name": name, "unit": "%", "better": "higher",
                                   "source": "device_trace", "layer": "Device",
                                   "moves": "mlups_4card", "workloads": [CELL[0]]})
    with open(path, "w") as f:
        json.dump(bench, f)
    return root


def _rehearse(root, *extra):
    out = subprocess.run(
        [sys.executable, "-m", "ekbench.tests.rehearse", "--root", root,
         "--workload", CELL[0], "--seed", "2147483661", "--seconds", "1.5",
         *extra], capture_output=True, text=True, cwd=CODE, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_two_processes_rehearse_the_pod(root):
    res = _rehearse(root)
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 1 and res["failed"] == 0
    assert "workers_failed" not in res["checks"]
    assert "cpu_rehearsal.mlups_4card" in res["metrics"]


def test_traced_pod_rehearsal_reads_process_0(root):
    res = _rehearse(root, "--trace", "1")
    assert "cpu_rehearsal.idle_pct.4card" in res["metrics"]
    assert res["device"]["window_s"] > 0


def test_the_exchange_left_out_is_not_correct(root):
    res = _rehearse(root, "--fault", "exchange")
    assert res["correct"] is False, res["checks"]
