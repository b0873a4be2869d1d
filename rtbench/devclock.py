"""Marks on the device's stream: CUDA events on the card; on the CPU,
where the program's plain versions run synchronously, the host clock (for
the CPU tests of the harness only: no number of a CPU run is reported as
a device metric); and the release of the program's memory before the
check."""

from __future__ import annotations

import time

import torch


class _HostMark:
    def __init__(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, other) -> float:
        return (other.t - self.t) * 1e3


class Clock:
    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"

    def mark(self):
        if not self.cuda:
            return _HostMark()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    @staticmethod
    def ms(a, b) -> float:
        return a.elapsed_time(b)


def release(device) -> None:
    """Let the program's freed memory go before the reference runs."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
