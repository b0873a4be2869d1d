"""Stackless linearization of a BVH (port of
``raytracer_tpu/accel/linearize.py``).

Nodes are laid out in depth-first order with SKIP POINTERS: a walker keeps
one node pointer, advancing to ptr+1 when the node's box is hit and
jumping to skip[ptr] otherwise. Shape indices are re-emitted in DFS-leaf
order, so every leaf owns a contiguous range of ``perm``.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from raytracer_tpu_torch.accel.bvh import BVH


@dataclasses.dataclass
class LinearBVH:
    """Host (CPU) tensors for skip-pointer traversal; M nodes, DFS order."""

    bounds: torch.Tensor      # (M, 6) f32: bmin xyz, bmax xyz
    leaf_start: torch.Tensor  # (M,) i32: offset into perm (leaves), else 0
    leaf_count: torch.Tensor  # (M,) i32: #shapes in leaf, 0 for internal
    skip: torch.Tensor        # (M,) i32: next node after this subtree
    perm: torch.Tensor        # (K,) i32: shape ids in DFS-leaf order

    @property
    def num_nodes(self) -> int:
        return self.bounds.shape[0]


def linearize(bvh: BVH) -> LinearBVH:
    """Flatten a root-last BVH into DFS order with skip pointers."""
    m = bvh.num_nodes
    order: list = []
    bounds = np.zeros((m, 6), np.float32)
    leaf_start = np.zeros(m, np.int32)
    leaf_count = np.zeros(m, np.int32)
    skip = np.zeros(m, np.int32)
    perm: list = []

    def visit(node: int) -> int:
        me = len(order)
        order.append(node)
        bounds[me, 0:3] = bvh.bounds_min[node]
        bounds[me, 3:6] = bvh.bounds_max[node]
        if bvh.left[node] == -1:
            leaf_start[me] = len(perm)
            cnt = int(bvh.count[node])
            leaf_count[me] = cnt
            s = int(bvh.start[node])
            perm.extend(bvh.indices[s:s + cnt].tolist())
        else:
            visit(int(bvh.left[node]))
            visit(int(bvh.right[node]))
        skip[me] = len(order)
        return skip[me]

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 10 * m + 100))
    try:
        visit(bvh.root)
    finally:
        sys.setrecursionlimit(old)
    if len(order) != m:
        raise ValueError(f"BVH is not a tree: visited {len(order)} of {m}")

    return LinearBVH(
        bounds=torch.from_numpy(bounds),
        leaf_start=torch.from_numpy(leaf_start),
        leaf_count=torch.from_numpy(leaf_count),
        skip=torch.from_numpy(skip),
        perm=torch.from_numpy(np.asarray(perm, np.int32)),
    )


def shape_leaf_boxes(lin: LinearBVH, num_shapes: int):
    """Per-shape leaf AABB, ((N,3) min, (N,3) max) — the box that gates a
    shape's visibility under BVH traversal."""
    bounds = lin.bounds.numpy()
    starts = lin.leaf_start.numpy()
    counts = lin.leaf_count.numpy()
    perm = lin.perm.numpy()
    bmin = np.zeros((num_shapes, 3), np.float32)
    bmax = np.zeros((num_shapes, 3), np.float32)
    for node in np.nonzero(counts > 0)[0]:
        sl = perm[starts[node]:starts[node] + counts[node]]
        bmin[sl] = bounds[node, 0:3]
        bmax[sl] = bounds[node, 3:6]
    return torch.from_numpy(bmin), torch.from_numpy(bmax)
