"""Binned surface-area-heuristic (SAH) BVH builder for the triangle tree.

Port of ``raytracer_tpu/accel/sah.py``, kept bit-identical: 16 centroid
bins per axis, the split minimising SA(L)*N_L + SA(R)*N_R, a leaf when no
split beats the leaf cost or when N <= leaf_target. Any triangle tree is
exact for the closest-hit walk (triangles are contained in their boxes),
so the tree's shape is a pure performance choice; the constants are the
JAX package's, so both packages build the same tree.

Emits the root-last ``BVH`` container, so ``linearize()`` works unchanged.
"""

from __future__ import annotations

import numpy as np

from raytracer_tpu_torch.accel.bvh import BVH
from raytracer_tpu_torch.geom.aabb import shape_aabbs, shape_centers

N_BINS = 16
# SAH constants: cost of one traversal step relative to one primitive
# intersection (the JAX package's values; changing them changes the tree).
C_TRAV = 24.0
C_ISECT = 1.0


def build_sah(scene=None, leaf_target: int = 64, *, aabbs=None,
              centers=None, max_depth: int = 32) -> BVH:
    """Build a binned-SAH BVH over the scene's shapes (or explicit
    aabbs/centers). Returns the root-last BVH container.
    """
    if aabbs is None:
        mins, maxs = shape_aabbs(scene)
    else:
        mins, maxs = aabbs
    if centers is None:
        centers = shape_centers(scene)
    mins = np.asarray(mins, np.float32)
    maxs = np.asarray(maxs, np.float32)
    centers = np.asarray(centers, np.float32)
    n = mins.shape[0]

    # reference arrays (ref -> original id)
    rid = np.arange(n, dtype=np.int64)
    rmin = mins.copy()
    rmax = maxs.copy()
    rcen = centers.copy()

    nodes_bmin: list = []
    nodes_bmax: list = []
    nodes_left: list = []
    nodes_right: list = []
    nodes_start: list = []
    nodes_count: list = []
    node_shapes: list = []
    indices: list = []

    def surf(bmin, bmax):
        d = np.maximum(bmax - bmin, 0.0)
        return 2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0])

    def emit_leaf(idx, bmin, bmax):
        nodes_bmin.append(bmin)
        nodes_bmax.append(bmax)
        nodes_left.append(-1)
        nodes_right.append(-1)
        nodes_start.append(len(indices))
        nodes_count.append(len(idx))
        node_shapes.append(rid[idx].astype(np.int32))
        indices.extend(int(i) for i in rid[idx])
        return len(nodes_bmin) - 1

    def object_split(idx, nn):
        """Best binned object split: (cost, lmask) or None."""
        best = None
        cb_min = rcen[idx].min(0)
        cb_max = rcen[idx].max(0)
        for axis in range(3):
            span = cb_max[axis] - cb_min[axis]
            if span <= 0:
                continue
            rel = (rcen[idx, axis] - cb_min[axis]) / span
            b = np.minimum((rel * N_BINS).astype(np.int32), N_BINS - 1)
            cnt = np.zeros(N_BINS, np.int64)
            bmn = np.full((N_BINS, 3), np.inf, np.float32)
            bmx = np.full((N_BINS, 3), -np.inf, np.float32)
            for k in range(N_BINS):
                m = b == k
                cnt[k] = m.sum()
                if cnt[k]:
                    bmn[k] = rmin[idx][m].min(0)
                    bmx[k] = rmax[idx][m].max(0)
            lcnt = np.cumsum(cnt)[:-1]
            rcnt = nn - lcnt
            la = np.empty(N_BINS - 1, np.float32)
            ra = np.empty(N_BINS - 1, np.float32)
            cmn = bmn[0].copy()
            cmx = bmx[0].copy()
            for k in range(N_BINS - 1):
                if k:
                    cmn = np.minimum(cmn, bmn[k])
                    cmx = np.maximum(cmx, bmx[k])
                la[k] = surf(cmn, cmx) if lcnt[k] else 0.0
            cmn = bmn[-1].copy()
            cmx = bmx[-1].copy()
            for k in range(N_BINS - 2, -1, -1):
                if k < N_BINS - 2:
                    cmn = np.minimum(cmn, bmn[k + 1])
                    cmx = np.maximum(cmx, bmx[k + 1])
                ra[k] = surf(cmn, cmx) if rcnt[k] else 0.0
            cost = la * lcnt + ra * rcnt
            valid = (lcnt > 0) & (rcnt > 0)
            if not valid.any():
                continue
            cost = np.where(valid, cost, np.inf)
            k = int(np.argmin(cost))
            if best is None or cost[k] < best[0]:
                best = (float(cost[k]), b <= k)
        return best

    def build(idx, depth) -> int:
        bmin = rmin[idx].min(0)
        bmax = rmax[idx].max(0)
        nn = len(idx)
        if nn <= leaf_target or depth >= max_depth:
            return emit_leaf(idx, bmin, bmax)

        obj = object_split(idx, nn)
        sa_p = surf(bmin, bmax)
        leaf_cost = C_ISECT * nn * sa_p
        if obj is None or C_TRAV * sa_p + C_ISECT * obj[0] >= leaf_cost:
            return emit_leaf(idx, bmin, bmax)

        _, lmask = obj
        li = build(idx[lmask], depth + 1)
        ri = build(idx[~lmask], depth + 1)
        nodes_bmin.append(bmin)
        nodes_bmax.append(bmax)
        nodes_left.append(li)
        nodes_right.append(ri)
        nodes_start.append(0)
        nodes_count.append(len(idx))
        node_shapes.append(rid[idx].astype(np.int32))
        return len(nodes_bmin) - 1

    build(np.arange(n, dtype=np.int64), 0)
    return BVH(
        bounds_min=np.asarray(nodes_bmin, np.float32),
        bounds_max=np.asarray(nodes_bmax, np.float32),
        left=np.asarray(nodes_left, np.int32),
        right=np.asarray(nodes_right, np.int32),
        start=np.asarray(nodes_start, np.int32),
        count=np.asarray(
            [c if l == -1 else 0
             for c, l in zip(nodes_count, nodes_left)], np.int32),
        indices=np.asarray(indices, np.int32),
        node_shapes=node_shapes,
    )
