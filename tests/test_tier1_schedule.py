"""The tier-1 run's xdist scheduler (conftest.py at the repo root): which
items share a work unit, the order units are dealt out in, and that the
files it splits exist.  No JAX, no torch; well under a second."""
import importlib.util
from pathlib import Path
from types import SimpleNamespace

import pytest

ROOT = Path(__file__).resolve().parent.parent

# Loaded by its path under a name of its own: `import conftest` could name
# either this file's or tests/conftest.py's module.
_spec = importlib.util.spec_from_file_location("tier1_schedule_conftest",
                                               ROOT / "conftest.py")
schedule = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(schedule)


def _config(dist, workers=6):
    option = SimpleNamespace(dist=dist, tx=[f"{workers}*popen"],
                             loadscopereorder=True)
    return SimpleNamespace(option=option,
                           getoption=lambda name: getattr(option, name),
                           getvalue=lambda name: getattr(option, name))


@pytest.mark.parametrize("nodeid, scope", [
    ("tests/test_pallas_fused.py::test_fused_chunked_collide_multi_strip",
     "tests/test_pallas_fused.py::test_fused_chunked_collide_multi_strip"),
    ("tests/test_sharding.py::test_halo_shardmap_matches_single_pallas[slab-4]",
     "tests/test_sharding.py::test_halo_shardmap_matches_single_pallas[slab-4]"),
    ("tests/test_torch_step.py::test_step_matches_oracle[f64]",
     "tests/test_torch_step.py"),
    ("tests/test_torch_cli.py::TestRun::test_resume", "tests/test_torch_cli.py"),
    ("tests/test_golden.py::test_golden_60_steps", "tests/test_golden.py"),
])
def test_split_scope(nodeid, scope):
    sched = schedule.pytest_xdist_make_scheduler(_config("loadfile"), None)
    assert isinstance(sched, schedule.SplitFileScheduling)
    assert sched._split_scope(nodeid) == scope


@pytest.mark.parametrize("dist", ["load", "loadscope", "no"])
def test_other_dist_modes_keep_xdist_scheduler(dist):
    assert schedule.pytest_xdist_make_scheduler(_config(dist), None) is None


def test_work_order_deals_split_items_first():
    units = [("tests/a.py", {"tests/a.py::t1": False}),
             ("tests/test_sharding.py::s1", {"tests/test_sharding.py::s1": False}),
             ("tests/b.py", {"tests/b.py::t1": False, "tests/b.py::t2": False}),
             ("tests/test_sharding.py::s2", {"tests/test_sharding.py::s2": False})]
    assert [scope for scope, _ in schedule.work_order(units)] == [
        "tests/test_sharding.py::s1", "tests/test_sharding.py::s2",
        "tests/b.py", "tests/a.py"]


class _Node:
    """Stands in for xdist's WorkerController: records what it is sent."""

    def __init__(self, name, sent):
        self.gateway = SimpleNamespace(id=name)
        self.shutting_down = False
        self._sent = sent

    def send_runtest_some(self, indexes):
        self._sent.append((self.gateway.id, indexes))

    def shutdown(self):
        self.shutting_down = True


def test_schedule_deals_split_items_first():
    # xdist's own schedule() runs: if it stopped calling the overrides, the
    # split files would go whole, and by size last.
    collection = ["tests/test_a.py::t1", "tests/test_a.py::t2", "tests/test_a.py::t3",
                  "tests/test_pallas_fused.py::f1", "tests/test_pallas_fused.py::f2",
                  "tests/test_sharding.py::s1[x]",
                  "tests/test_torch_b.py::TestB::b1", "tests/test_torch_b.py::b2"]
    sent = []
    sched = schedule.pytest_xdist_make_scheduler(_config("loadfile", 3), None)
    nodes = [_Node(f"gw{i}", sent) for i in range(3)]
    for node in nodes:
        sched.add_node(node)
    for node in nodes:
        sched.add_node_collection(node, collection)
    sched.schedule()
    assert [(name, [collection[i] for i in idx]) for name, idx in sent] == [
        ("gw0", ["tests/test_pallas_fused.py::f1"]),
        ("gw1", ["tests/test_pallas_fused.py::f2"]),
        ("gw2", ["tests/test_sharding.py::s1[x]"]),
        ("gw0", collection[:3]),
        ("gw1", collection[6:]),
    ]
    assert not sched.workqueue and nodes[2].shutting_down


@pytest.mark.parametrize("path", schedule.SPLIT_FILES)
def test_split_file_exists(path):
    # a renamed file would silently turn the split off
    assert (Path(schedule.__file__).resolve().parent / path).is_file()
