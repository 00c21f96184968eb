"""The tier-1 run's xdist scheduler.

`--dist loadfile` gives each test file whole to one worker.  The items of
SPLIT_FILES (the JAX package's interpret-mode Pallas and shard_map checks,
minutes each on the 8-device CPU mesh) are dealt out one at a time instead,
ahead of the whole files: whole, tests/test_pallas_fused.py alone outlasts
the tier-1 run's time limit.  Every other file stays one work unit.  Under
any other `--dist` mode, one process or `-p no:xdist` nothing changes.

This file sits at the root (pytest's rootdir) so that it is an initial
conftest of any test path; it imports neither JAX nor torch.
"""
import pytest

try:
    from xdist.scheduler import LoadFileScheduling
except ImportError:  # no pytest-xdist: one process, nothing to schedule
    LoadFileScheduling = None

# Paths relative to this file, as in pytest's node ids.
SPLIT_FILES = ("tests/test_pallas_fused.py", "tests/test_sharding.py")


def work_order(units):
    """The (scope, items) work units in the order they are dealt out: the
    split files' single items in collection order, then whole files by item
    count."""
    single = [u for u in units if "::" in u[0]]
    whole = sorted((u for u in units if "::" not in u[0]), key=lambda u: -len(u[1]))
    return single + whole


@pytest.hookimpl(optionalhook=True)
def pytest_xdist_make_scheduler(config, log):
    if LoadFileScheduling is None or config.getoption("dist") != "loadfile":
        return None
    return SplitFileScheduling(config, log)


if LoadFileScheduling is not None:

    class SplitFileScheduling(LoadFileScheduling):
        _ordered = False

        def _split_scope(self, nodeid):
            path = nodeid.split("::", 1)[0]
            return nodeid if path in SPLIT_FILES else path

        def _assign_work_unit(self, node):
            # schedule() fills the queue and deals its first units out in one
            # call, with no hook for order: reorder before the first leaves.
            if not self._ordered:
                self._ordered = True
                units = work_order(list(self.workqueue.items()))
                self.workqueue.clear()
                self.workqueue.update(units)
            super()._assign_work_unit(node)
