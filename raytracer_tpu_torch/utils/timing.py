"""Timing and throughput (port of ``raytracer_tpu/utils/timing.py``).

The reference's only metric is the ImGui FPS readout from glfwGetTime
deltas with vsync off (src/main.cpp:296-300, 375, 175). ``FrameTimer``
keeps its delta/fps semantics for the interactive loop; ``benchmark``
reports wall time per call, waiting for the card after each call
(``torch.cuda.synchronize``) where the result lies on one, and the
derived Mrays/s.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict

import torch


@dataclasses.dataclass
class FrameTimer:
    """deltaTime/fps bookkeeping (main.cpp:292-300)."""

    last_frame: float = 0.0
    delta_time: float = 0.0
    fps: float = 0.0
    frames: int = 0

    def tick(self, now: float = None) -> float:
        now = time.perf_counter() if now is None else now
        if self.frames:
            self.delta_time = now - self.last_frame
            self.fps = 1.0 / self.delta_time if self.delta_time > 0 else 0.0
        self.last_frame = now
        self.frames += 1
        return self.delta_time


def block_until_ready(x):
    """Wait for the card to finish ``x`` (a tensor, or a tuple or list of
    them); a result on the CPU is ready."""
    for t in x if isinstance(x, (tuple, list)) else (x,):
        if isinstance(t, torch.Tensor) and t.device.type == "cuda":
            torch.cuda.synchronize(t.device)
    return x


def benchmark(fn: Callable, *args, warmup: int = 2, iters: int = 10,
              rays_per_call: int = None, **kw) -> Dict[str, float]:
    """Time ``fn(*args, **kw)``, waiting for its result after each call.

    Returns the mean and min seconds per call, fps, and Mrays/s when
    ``rays_per_call`` is given (what a call counts as rays is the
    caller's choice; report what you pass)."""
    for _ in range(warmup):
        block_until_ready(fn(*args, **kw))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        block_until_ready(fn(*args, **kw))
        times.append(time.perf_counter() - t0)
    mean = sum(times) / len(times)
    out = {
        "mean_s": mean,
        "min_s": min(times),
        "fps": 1.0 / mean if mean > 0 else float("inf"),
        "iters": iters,
    }
    if rays_per_call:
        out["mrays_per_s"] = rays_per_call / mean / 1e6
    return out
