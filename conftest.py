"""Suite-wide pytest hooks: the ``slow`` marker, and the order in which
pytest-xdist hands out work under ``--dist loadfile``.

Under ``loadfile`` each test file is one unit of work, and xdist queues the
units by case count, largest first, so a file of few but long tests is
handed out last. A worker also holds the unit after the one it runs, and
starts it only when that one ends, so a long unit handed out late can end
the run long after the other workers went idle. The units of the files in
``FIRST`` are handed out before any other, in its order; each test of a
file marked True is a unit of its own, so its tests spread over the
workers. Every other file stays one unit, in xdist's order.
"""

import pytest

# Measured with the tier-1 command (6 workers, 8 cores):
FIRST = {
    # 11 JAX tests, 1238 s in series as one unit: the run took 1345 s
    "tests/test_sharded.py": True,
    # one 316-785 s training, a module fixture of its 4 tests: queued late
    "tests/test_e2e.py": False,
    # one 340-521 s test, queued last: it waited behind a long test, and
    # the run was cut at 1471 s
    "tests/test_multihost.py": False,
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: a long run, left out of tier-1 by -m 'not slow'")


@pytest.hookimpl(optionalhook=True)  # a hook of xdist, which may be absent
def pytest_xdist_make_scheduler(config, log):
    if config.getoption("dist", None) != "loadfile":
        return None
    from xdist.scheduler import LoadFileScheduling

    order = list(FIRST)

    class LongFirst(LoadFileScheduling):
        def _split_scope(self, nodeid):
            path = super()._split_scope(nodeid)
            return nodeid if FIRST.get(path) else path

        def _assign_work_unit(self, node):
            first = sorted((s for s in self.workqueue
                            if s.split("::", 1)[0] in FIRST),
                           key=lambda s: order.index(s.split("::", 1)[0]))
            for scope in reversed(first):
                self.workqueue.move_to_end(scope, last=False)
            super()._assign_work_unit(node)

    return LongFirst(config, log)
