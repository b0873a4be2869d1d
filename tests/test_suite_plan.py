"""The xdist queue of tests/suite_plan.py, driven with stand-in workers."""

from types import SimpleNamespace

from tests.suite_plan import CostliestFirstScheduling


class Worker:
    def __init__(self, name):
        self.gateway = SimpleNamespace(id=name)
        self.shutting_down = False
        self.sent = []

    def send_runtest_some(self, indices):
        self.sent.append(list(indices))

    def shutdown(self):
        self.shutting_down = True


def scheduled(nodeids, n_workers=2):
    config = SimpleNamespace(
        getvalue={"tx": [f"{n_workers}*popen"]}.get,
        option=SimpleNamespace(loadscopereorder=True))
    sched = CostliestFirstScheduling(config)
    workers = [Worker(f"gw{i}") for i in range(n_workers)]
    for w in workers:
        sched.add_node(w)
    for w in workers:
        sched.add_node_collection(w, nodeids)
    sched.schedule()
    return sched, workers


def test_queue_starts_with_the_costliest_units():
    hybrid = "tests/test_dist.py::test_sharded_hybrid_scene2_matches_production"
    dryrun = "tests/test_dist.py::test_dryrun_entrypoint"
    stream = "tests/test_dist.py::test_sharded_split_stream_no_per_frame_sync"
    fused = "tests/test_fused_shadow.py::test_small_scene_fused_matches_twolaunch"
    sched, (a, b) = scheduled([
        "tests/test_dist.py::test_eight_devices_available", dryrun, stream,
        hybrid, f"{fused}[kw0]", f"{fused}[kw1]",
        "tests/test_geom.py::TestSphere::test_miss",
        "tests/test_geom.py::test_a", "tests/test_geom.py::test_b"])
    # two units a worker to start, costliest first; the wall-clock test last
    assert list(sched.assigned_work[a]) == [hybrid, fused]
    assert list(sched.assigned_work[b]) == [dryrun, "tests/test_dist.py"]
    assert list(sched.workqueue) == ["tests/test_geom.py", stream]
    assert list(sched.assigned_work[a][fused]) == [
        f"{fused}[kw0]", f"{fused}[kw1]"]
    assert len(sched.workqueue["tests/test_geom.py"]) == 3


def test_a_crashed_test_is_reported_once_and_not_run_again():
    ids = ["tests/test_a.py::t1", "tests/test_a.py::t2", "tests/test_a.py::t3",
           "tests/test_b.py::u1", "tests/test_c.py::v1", "tests/test_d.py::w1"]
    sched, (a, b) = scheduled(ids)
    assert a.sent == [[0, 1, 2]] and b.sent == [[3], [4]]
    sched.mark_test_complete(a, 0)
    assert a.sent[-1] == [5] and not sched.workqueue
    # `a` dies in t2 while `b`, two tests pending, waits for more work
    assert sched.remove_node(a) == "tests/test_a.py::t2"
    assert b.sent[-1] == [2]
    assert list(sched.workqueue) == ["tests/test_d.py"]
