"""The frozen work count, the yardstick of the rooflines and of ``mfu``.

The work of a frame is what its rays need, counted from the benchmark's
own inputs, whatever implements the frame: the rays that the frame traces
(each pixel's primary ray; the shadow ray of each hit toward the light;
the reflection rays up to ``max_bounces``), the upstream's rays as the
reference traces them. Each is walked through each of two trees as
gpu_shader.comp::intersectScene2 (380-430) walks one (every box under a
hit box tested, every shape of a hit leaf tested): the upstream's own
BVH (``bvh.build``, which on scene 2 leaves the 707 shapes of the road in
one leaf) and the counting tree (``bvh.build_counting``: median splits
down to leaves of at most ``tracer.LEAF_MAX`` shapes). The tests of each
walk, by type (``tracer.RefScene.closest``), times a fixed count of f32
operations a test, give each tree's operations; the count is the lesser
of the two, so that a program which splits the big leaf, or walks a
better tree, is held to work it could do, not to the upstream's. The
bytes are the scene's shape arrays as the scene maker makes them, read
once, and the W x H x 3 f32 frame, written once.

A test's operations are those of the tests in ``tracer.test``, with what
depends on the shape alone (its edges, Gram terms, wall basis) counted
once per shape and left out here, and what depends on the ray alone (its
inverse direction) counted once per ray:

  box       6 sub, 6 mul, 6 min/max per axis pair, 4 min/max, 2 compares
  sphere    3 sub, 3 dots (15), 1 mul + 1 sub (cc), 3 (disc), 1 sqrt,
            3 (t), 2 compares
  plane     2 dots (10), 1 add, 1 neg, 1 div, 2 compares
  wall      plane, the hit point (6), 3 sub, 2 dots (10), 4 compares
  triangle  plane, the hit point (6), 3 sub, 2 dots (10), 2 x (2 mul,
            1 sub, 1 div), 2 sub (u), 3 compares

Peaks: NVIDIA's H100 SXM data sheet, 3.35 TB/s of HBM3 and 67 TFLOP/s of
f32 outside the tensor cores, at its 700 W power limit.
"""

from __future__ import annotations

import numpy as np
import torch

OPS = {"box": 24, "sphere": 29, "plane": 15, "wall": 38, "triangle": 47}
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def light_tensors(light: dict, device, dtype) -> dict:
    f32 = dict(dtype=torch.float32, device=device)
    pos = torch.tensor(light["position"], **f32)
    color = torch.tensor(light["intensity"], **f32) * torch.tensor(
        light["color"], **f32)
    return {"position": pos.to(dtype), "color": color.to(dtype)}


def frame_work(per_pixel: torch.Tensor, flat: dict, width: int,
               height: int) -> dict:
    """A frame's operations and bytes from the mean tests a pixel (five
    columns, ``tracer.COUNTS``, a counted tree), the lesser tree's, and
    the least time the card could take for them (ms)."""
    c = per_pixel.double().cpu().numpy().reshape(-1, 5)
    per_tree = [sum(float(row[i]) * OPS[k] for i, k in enumerate(
        ("box", "sphere", "plane", "wall", "triangle"))) for row in c]
    tree = int(np.argmin(per_tree))
    ops = per_tree[tree] * width * height
    nbytes = sum(int(np.asarray(v).nbytes) for v in flat.values()) + \
        width * height * 3 * 4
    return {"ops": ops, "bytes": float(nbytes),
            "bound_ms": max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES) * 1e3,
            "tree": tree, "ops_per_pixel_by_tree": per_tree,
            "tests_per_pixel": [float(x) for x in c[tree]]}
