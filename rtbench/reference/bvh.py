"""The upstream's BVH: the top-down median split of buildBVH and split
(main.cpp:1111-1193) at the scene's maxDepth, over the AABBs of
BoundingBox.hpp, laid out root last as serializeBVH does (main.cpp:
955-979). The reference walks it as gpu_shader.comp::intersectScene2
(380-430) does: a node's box is tested when it is popped, a leaf's shapes
are tested when its box is hit, both children of a hit inner node are
pushed; no ordering and no culling by the closest t so far.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from .scene import PLANE, SPHERE, TRIANGLE, WALL


def wall_end(n, start, w, h) -> np.ndarray:
    """Wall::end() (wall.hpp:16-31): the far corner by the tangent basis,
    (K, 3) over K walls."""
    use_x = np.abs(n[:, 0]) > np.abs(n[:, 1])
    zero = np.zeros_like(n[:, 0])
    t1 = np.where(use_x[:, None], np.stack([-n[:, 2], zero, n[:, 0]], -1),
                  np.stack([zero, -n[:, 2], n[:, 1]], -1))
    t1n = np.linalg.norm(t1, axis=-1, keepdims=True)
    t1 = np.divide(t1, t1n, out=np.zeros_like(t1), where=t1n > 0)
    t2 = np.cross(n, t1)
    t2n = np.linalg.norm(t2, axis=-1, keepdims=True)
    t2 = np.divide(t2, t2n, out=np.zeros_like(t2), where=t2n > 0)
    return start + w[:, None] * t1 + h[:, None] * t2


def shape_aabbs(flat):
    """Per-shape (min, max), (N, 3) f32; a bare plane is unbounded."""
    st = flat["shape_type"]
    n = st.shape[0]
    mins = np.full((n, 3), np.inf, np.float32)
    maxs = np.full((n, 3), -np.inf, np.float32)
    s = st == SPHERE
    c, r = flat["sphere_center"][s], flat["sphere_radius"][s][:, None]
    mins[s], maxs[s] = c - r, c + r
    w = st == WALL
    if w.any():
        start = flat["wall_start"][w]
        end = wall_end(flat["plane_normal"][w], start, flat["wall_width"][w],
                       flat["wall_height"][w])
        mins[w], maxs[w] = np.minimum(start, end), np.maximum(start, end)
    t = st == TRIANGLE
    p = np.stack([flat["tri_p1"][t], flat["tri_p2"][t], flat["tri_p3"][t]], 1)
    mins[t], maxs[t] = p.min(axis=1), p.max(axis=1)
    if (st == PLANE).any():
        raise ValueError("a bare plane has no box: the upstream's tree "
                         "cannot hold it")
    return mins, maxs


def shape_centers(flat) -> np.ndarray:
    """Split-plane centres (main.cpp:1127-1153)."""
    st = flat["shape_type"]
    centers = np.zeros((st.shape[0], 3), np.float32)
    s = st == SPHERE
    centers[s] = flat["sphere_center"][s]
    w = st == WALL
    if w.any():
        start = flat["wall_start"][w]
        end = wall_end(flat["plane_normal"][w], start, flat["wall_width"][w],
                       flat["wall_height"][w])
        centers[w] = (start + end) * 0.5
    t = st == TRIANGLE
    centers[t] = (flat["tri_p1"][t] + flat["tri_p2"][t]
                  + flat["tri_p3"][t]) / 3.0
    return centers


@dataclasses.dataclass
class Tree:
    """Nodes root last. ``members[i]``: the shapes under node i (a leaf's
    are the shapes it tests)."""

    bmin: np.ndarray        # (M, 3) f32
    bmax: np.ndarray        # (M, 3) f32
    left: np.ndarray        # (M,) -1 for a leaf
    right: np.ndarray
    members: List[np.ndarray]

    @property
    def num_nodes(self) -> int:
        return self.bmin.shape[0]


def build(flat, max_depth: int) -> Tree:
    mins, maxs = shape_aabbs(flat)
    centers = shape_centers(flat)
    out = []   # (bmin, bmax, left, right, idx)

    def box(idx):
        return (np.minimum(np.full(3, np.inf, np.float32),
                           mins[idx].min(0)).astype(np.float32),
                np.maximum(np.full(3, -np.inf, np.float32),
                           maxs[idx].max(0)).astype(np.float32))

    def split(idx, bmin, bmax, depth):
        """Returns (left, right) node ids, or (-1, -1) for a leaf."""
        if depth <= 0:
            return -1, -1
        size = bmax - bmin
        axis = (0 if size[0] > max(size[1], size[2])
                else (1 if size[1] > size[2] else 2))
        pos = (bmin[axis] + bmax[axis]) * 0.5
        in_a = centers[idx, axis] < pos
        li, ri = idx[in_a], idx[~in_a]
        if len(li) == 0 or len(ri) == 0:
            return -1, -1
        lb, rb = box(li), box(ri)
        lc = split(li, *lb, depth - 1)
        rc = split(ri, *rb, depth - 1)
        out.append((*lb, *lc, li))
        left = len(out) - 1
        out.append((*rb, *rc, ri))
        return left, len(out) - 1

    root = np.arange(mins.shape[0], dtype=np.int64)
    rb = box(root)
    out.append((*rb, *split(root, *rb, max_depth), root))
    return Tree(np.stack([o[0] for o in out]), np.stack([o[1] for o in out]),
                np.array([o[2] for o in out], np.int64),
                np.array([o[3] for o in out], np.int64),
                [o[4] for o in out])


def build_counting(flat, leaf_max: int) -> Tree:
    """The tree of the work count (``work.py``): a split of the shapes at
    their median centre along the longest axis of the centres' bounds,
    down to leaves of at most ``leaf_max`` shapes. Every split separates,
    so no leaf holds more than ``leaf_max`` shapes, whatever the scene;
    laid out root last, as ``build``."""
    mins, maxs = shape_aabbs(flat)
    centers = shape_centers(flat)
    out = []

    def box(idx):
        return (mins[idx].min(0).astype(np.float32),
                maxs[idx].max(0).astype(np.float32))

    def split(idx):
        if len(idx) <= leaf_max:
            return -1, -1
        c = centers[idx]
        axis = int(np.argmax(c.max(0) - c.min(0)))
        order = idx[np.argsort(c[:, axis], kind="stable")]
        li, ri = order[:len(idx) // 2], order[len(idx) // 2:]
        lc, rc = split(li), split(ri)
        out.append((*box(li), *lc, li))
        left = len(out) - 1
        out.append((*box(ri), *rc, ri))
        return left, len(out) - 1

    root = np.arange(mins.shape[0], dtype=np.int64)
    out.append((*box(root), *split(root), root))
    return Tree(np.stack([o[0] for o in out]), np.stack([o[1] for o in out]),
                np.array([o[2] for o in out], np.int64),
                np.array([o[3] for o in out], np.int64),
                [o[4] for o in out])
