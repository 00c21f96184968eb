"""On a card (marked `cuda`; each test skips without one, decided in the
fixture): the rehearsal cell through the CUDA kernels with its control,
and one short run of a real cell through `python3 -m ekbench.run`.

    python -m pytest ekbench/tests/test_ekbench_card.py -q -p no:cacheprovider
"""
import json
import os
import subprocess
import sys

import pytest

from ekbench.tests import rehearse

pytestmark = pytest.mark.cuda
CODE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@pytest.fixture(scope="module")
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _last_json(out):
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_rehearsal_on_the_card_with_its_control(card, tmp_path):
    root = rehearse.make_root(str(tmp_path), [
        ("rehearsal.s10", "rehearsal", "series10", "rehearsal.limits.json")])
    out = subprocess.run(
        [sys.executable, "-m", "ekbench.tests.rehearse", "--root", root,
         "--workload", "rehearsal.s10", "--seed", "2147483663", "--seconds",
         "2", "--control", "--device", "cuda"],
        capture_output=True, text=True, cwd=CODE, timeout=900)
    res = _last_json(out)
    assert res["correct"] is True, res["checks"]
    control = json.loads(next(ln for ln in out.stderr.splitlines()
                              if ln.startswith("CONTROL "))[8:])
    assert any(control[k] > res["checks"][k]["limit"] for k in control
               if k in res["checks"]), control


def test_a_cell_runs_through_the_benchmark_command(card):
    out = subprocess.run(
        [sys.executable, "-m", "ekbench.run", "--workload", "d3q7-256.s10",
         "--seed", "2147483667", "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, cwd=CODE, timeout=900)
    res = _last_json(out)
    assert res["correct"] is True, res["checks"]
    assert res["device"]["platform"] == "gpu" and res["metrics"]["mlups"]["value"] > 0
