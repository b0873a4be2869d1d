"""How the test suite runs, as a pytest plugin (the repository's root
conftest.py loads it): a time limit on every test call, and the xdist queue
of ``--dist loadfile``.

The queue. xdist hands a worker a whole file at a time and orders the files
by their count of tests, most first, so a file holding one long test starts
late and ends the run late. ``CostliestFirstScheduling`` makes each test
function of ``APART`` a work unit of its own (all its cases together) and
reorders the queue once, before the first unit is handed out: the units of
``COSTS``, costliest first (longest processing time first), then the rest in
xdist's order, then ``RUN_LAST``'s. A stale entry costs time, never a test.

The time limit. ``DEFAULT_TIME_LIMIT`` a call, or the test's row in
``LIMITS``; an overrun fails that test alone, with its traceback
(``tests/time_limit.py``). A hang inside a C call never returns to the
interpreter, so ``HANG_GRACE`` after the limit faulthandler prints every
thread's stack and ends the process: xdist reports the worker down, the
test failed, and goes on with the rest.
"""

import faulthandler
import os

import pytest

from tests.time_limit import DEFAULT_TIME_LIMIT, time_limit

HANG_GRACE = 60.0

# Worker-seconds of the costliest work units: the JUnit times of a Tier-1
# run at commit 7d3a13b (6 workers, `--dist loadfile`), summed over each
# unit's tests. A unit is a test file, less the functions run apart, or a
# function named here. A new unit above ~100 worker-seconds gets a row;
# none should pass ~300 unless it is a single test function.
COSTS = {
    "tests/test_dist.py::test_sharded_hybrid_scene2_matches_production": 547,
    "tests/test_dist.py::test_dryrun_entrypoint": 374,
    "tests/test_fused_shadow.py::test_small_scene_fused_matches_twolaunch":
        364,
    "tests/test_pallas_bvh.py::test_sorted_continuation_matches_wholeframe":
        296,
    "tests/test_pallas_bvh.py": 266,
    "tests/test_cli.py::test_play_bvh_mt_toggles": 253,
    "tests/test_pallas_bvh.py::test_split_kernel_raygen_odd_sizes": 204,
    "tests/test_dist.py": 177,
    "tests/test_sah.py": 166,
    "tests/test_fused_shadow.py::test_scene1_fused_matches_twolaunch": 155,
    "tests/test_live_edit.py": 149,
    "tests/test_pallas_bvh.py::test_scene3_kernels": 137,
    "tests/test_grad.py": 135,
    "tests/test_fused_shadow.py": 134,
    "tests/test_dynamic.py": 130,
    "tests/test_dynamic.py::test_animated_sorted_hybrid_matches_unsorted": 121,
    "tests/test_dynamic.py::test_wheel_animation_split_matches_host_prepare":
        115,
    "tests/test_scene2_parity.py": 111,
    "tests/test_cli.py": 91,
    "tests/test_inverse_kernel.py": 90,
}

# A wall-clock ratio that fails now and then wherever it runs (ROADMAP.md,
# "Test-time budget"): started after every other unit, when the workers
# still busy are on their last.
RUN_LAST = ("tests/test_dist.py::test_sharded_split_stream_no_per_frame_sync",)

APART = {unit for unit in COSTS if "::" in unit} | set(RUN_LAST)

# Tests measured over 250 s, at twice the longest JUnit time seen or more.
LIMITS = {
    "tests/test_dist.py::test_sharded_hybrid_scene2_matches_production": 1300,
    "tests/test_dist.py::test_dryrun_entrypoint": 1000,
    "tests/test_pallas_bvh.py::test_sorted_continuation_matches_wholeframe":
        800,
    "tests/test_cli.py::test_play_bvh_mt_toggles": 700,
}


def function_of(nodeid):
    """'path::name[case]' -> 'path::name'."""
    return nodeid.split("[", 1)[0]


STDERR_FD = pytest.StashKey[int]()


def pytest_configure(config):
    # Capturing swaps fd 2 during a test: keep the real stderr for
    # faulthandler's stacks.
    config.stash[STDERR_FD] = os.dup(2)


def pytest_unconfigure(config):
    os.close(config.stash[STDERR_FD])


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    limit = LIMITS.get(function_of(item.nodeid), DEFAULT_TIME_LIMIT)
    faulthandler.dump_traceback_later(
        limit + HANG_GRACE, exit=True, file=item.config.stash[STDERR_FD])
    try:
        with time_limit(limit):
            return (yield)
    finally:
        faulthandler.cancel_dump_traceback_later()


try:
    from xdist.scheduler import LoadFileScheduling
except ImportError:  # pytest without xdist runs the files in order
    LoadFileScheduling = None

if LoadFileScheduling is not None:
    class CostliestFirstScheduling(LoadFileScheduling):
        """`--dist loadfile` with APART's functions as units of their own
        and the queue reordered once: COSTS' units, costliest first, then
        the rest in xdist's order, then RUN_LAST's."""

        _reordered = False

        def _split_scope(self, nodeid):
            function = function_of(nodeid)
            if function in APART:
                return function
            return super()._split_scope(nodeid)

        def _assign_work_unit(self, node):
            if not self._reordered:
                self._reordered = True
                for unit in sorted(filter(COSTS.get, self.workqueue),
                                   key=COSTS.get):
                    self.workqueue.move_to_end(unit, last=False)
                for unit in RUN_LAST:
                    if unit in self.workqueue:
                        self.workqueue.move_to_end(unit)
            super()._assign_work_unit(node)

        def remove_node(self, node):
            # xdist queues a crashed worker's unfinished tests again, the
            # one that crashed it included, so a hang (ended by HANG_GRACE)
            # would end every worker in turn. It is marked done before
            # xdist requeues the rest, and reported failed once.
            crashitem = next(
                (nodeid for unit in self.assigned_work[node].values()
                 for nodeid, done in unit.items() if not done), None)
            if crashitem is not None:
                scope = self._split_scope(crashitem)
                self.assigned_work[node][scope][crashitem] = True
            super().remove_node(node)
            return crashitem

    @pytest.hookimpl(optionalhook=True)
    def pytest_xdist_make_scheduler(config, log):
        if config.getvalue("dist") == "loadfile":
            return CostliestFirstScheduling(config, log)
        return None
