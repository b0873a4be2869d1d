"""Host-clock spans that the benchmark opens around its calls into the
program: seconds summed by name, and with tracing on each span's start
and end on the wall clock (``time.time_ns``, the clock of the profiler's
device timestamps), so that the idle gaps of the device trace can be
named by what the host was doing. Nothing here calls into the profiler:
a traced window records the device's activity alone."""

from __future__ import annotations

import collections
import contextlib
import time


class Spans:
    def __init__(self, traced: bool):
        self.traced = traced
        self.total = collections.defaultdict(float)
        self.intervals = []        # (start ns, end ns, name), traced only

    @contextlib.contextmanager
    def __call__(self, name: str):
        t = time.perf_counter()
        w = time.time_ns() if self.traced else 0
        try:
            yield
        finally:
            self.total[name] += time.perf_counter() - t
            if self.traced:
                self.intervals.append((w, time.time_ns(), name))
