"""Host-side BVH: top-down median split with exact reference parity (port
of ``raytracer_tpu/accel/bvh.py``; reference src/main.cpp:1111-1193,
955-979).

Layout contract: children are appended after recursion (post-order), so
the ROOT IS THE LAST node; leaves have left == -1; only leaves emit shape
indices; split axis = largest box extent with the reference's
tie-breaking; a split with an empty child makes the parent a leaf. The
JAX package may build this with its native helper; this port always runs
the Python builder, whose output is identical.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from raytracer_tpu_torch.core.scene import FlatScene
from raytracer_tpu_torch.geom.aabb import shape_aabbs, shape_centers


@dataclasses.dataclass
class BVH:
    """Flat node arrays, root-last (reference serializeBVH layout)."""

    bounds_min: np.ndarray    # (M, 3) f32
    bounds_max: np.ndarray    # (M, 3) f32
    left: np.ndarray          # (M,) i32, -1 for leaf
    right: np.ndarray         # (M,) i32
    start: np.ndarray         # (M,) i32 offset into indices (leaves only)
    count: np.ndarray         # (M,) i32 number of shapes in the node
    indices: np.ndarray       # (K,) i32 shape indices, leaf-contiguous
    node_shapes: List[np.ndarray] = dataclasses.field(default_factory=list)

    @property
    def num_nodes(self) -> int:
        return self.bounds_min.shape[0]

    @property
    def root(self) -> int:
        return self.num_nodes - 1


class _Node:
    __slots__ = ("bmin", "bmax", "left", "right", "idx")

    def __init__(self):
        self.bmin = np.full(3, np.inf, np.float32)
        self.bmax = np.full(3, -np.inf, np.float32)
        self.left = -1
        self.right = -1
        self.idx: np.ndarray = np.empty(0, np.int64)


def _grow(node: _Node, mins, maxs, idx):
    if len(idx):
        node.bmin = np.minimum(node.bmin,
                               mins[idx].min(axis=0)).astype(np.float32)
        node.bmax = np.maximum(node.bmax,
                               maxs[idx].max(axis=0)).astype(np.float32)


def build_bvh(scene: FlatScene, max_depth: int = 15,
              aabbs=None, centers=None) -> BVH:
    """buildBVH + split + serializeBVH (main.cpp:1111-1193, 955-979)."""
    if aabbs is None:
        mins, maxs = shape_aabbs(scene)
    else:
        mins, maxs = aabbs
    if centers is None:
        centers = shape_centers(scene)

    out_nodes: List[_Node] = []

    def split(node: _Node, depth: int):
        if depth <= 0:
            return
        size = node.bmax - node.bmin
        axis = (0 if size[0] > max(size[1], size[2])
                else (1 if size[1] > size[2] else 2))
        split_pos = (node.bmin[axis] + node.bmax[axis]) * 0.5

        in_a = centers[node.idx, axis] < split_pos
        left, right = _Node(), _Node()
        left.idx = node.idx[in_a]
        right.idx = node.idx[~in_a]
        if len(left.idx) == 0 or len(right.idx) == 0:
            return
        _grow(left, mins, maxs, left.idx)
        _grow(right, mins, maxs, right.idx)

        split(left, depth - 1)
        split(right, depth - 1)

        out_nodes.append(left)
        node.left = len(out_nodes) - 1
        out_nodes.append(right)
        node.right = len(out_nodes) - 1

    n_shapes = mins.shape[0]
    root = _Node()
    root.idx = np.arange(n_shapes, dtype=np.int64)
    _grow(root, mins, maxs, root.idx)
    split(root, max_depth)
    out_nodes.append(root)

    m = len(out_nodes)
    bvh = BVH(
        bounds_min=np.stack([n.bmin for n in out_nodes]),
        bounds_max=np.stack([n.bmax for n in out_nodes]),
        left=np.array([n.left for n in out_nodes], np.int32),
        right=np.array([n.right for n in out_nodes], np.int32),
        start=np.zeros(m, np.int32),
        count=np.array([len(n.idx) for n in out_nodes], np.int32),
        indices=np.empty(0, np.int32),
        node_shapes=[n.idx.copy() for n in out_nodes],
    )
    indices: List[int] = []
    for i, n in enumerate(out_nodes):
        bvh.start[i] = len(indices)
        if n.left == -1:
            indices.extend(n.idx.tolist())
    bvh.indices = np.asarray(indices, np.int32)
    return bvh
