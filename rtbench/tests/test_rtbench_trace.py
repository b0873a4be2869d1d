"""The reduction of a device trace: busy time as the union of the device
operations, and idle gaps named by the host span open when each began."""

from rtbench import trace


class _Event:
    def __init__(self, start, end, name):
        self.s, self.t, self.n = start, end, name

    def name(self):
        return self.n

    def device_type(self):
        return "DeviceType.CUDA"

    def is_user_annotation(self):
        return False

    def start_ns(self):
        return self.s

    def end_ns(self):
        return self.t


class _Prof:
    def __init__(self, events):
        results = type("R", (), {"events": lambda _self: events})()
        self.profiler = type("P", (), {"kineto_results": results})()


def test_busy_union_and_named_gaps():
    ms = 1_000_000
    events = [_Event(1 * ms, 3 * ms, "k"), _Event(2 * ms, 4 * ms, "k"),
              _Event(6 * ms, 7 * ms, "copy")]
    host = [(0, 2 * ms, "render"), (2 * ms, 5 * ms, "wait"),
            (5 * ms, 7 * ms, "camera")]
    red = trace.reduce(_Prof(events), host)
    assert abs(red["busy_s"] - 4e-3) < 1e-12
    assert red["ops"]["k"][1] == 2
    # 0-1 ms idle under "render", 4-6 ms idle from within "wait"
    assert abs(red["gaps"]["render"] - 1e-3) < 1e-12
    assert abs(red["gaps"]["wait"] - 2e-3) < 1e-12
    assert red["aligned"] == 1.0
    bd = trace.breakdown(red)
    assert bd["device_ops"][0][0] == "k"
    assert bd["idle_gaps"][0][0] == "wait"


def test_no_device_operation_reads_nothing():
    red = trace.reduce(_Prof([]), [(0, 10, "render")])
    assert red["busy_s"] is None and red["aligned"] is None
