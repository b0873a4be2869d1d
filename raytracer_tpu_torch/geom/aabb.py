"""Host-side AABB helpers for the BVH build (numpy; port of
``raytracer_tpu/geom/aabb.py``, reference src/BoundingBox.hpp).

  sphere   -> center +- radius
  wall     -> start and Wall::end() corners
  triangle -> the three vertices (skipped if any coordinate is non-finite)
  plane    -> skipped (infinite extent), with a warning
"""

from __future__ import annotations

import warnings
from typing import Tuple

import numpy as np

from raytracer_tpu_torch.core.scene import (PLANE, SPHERE, TRIANGLE, WALL,
                                            FlatScene, to_numpy, wall_end)


def shape_aabbs(scene: FlatScene) -> Tuple[np.ndarray, np.ndarray]:
    """Per-shape AABBs, (N, 3) min / max. Planes get (+inf, -inf)."""
    st = to_numpy(scene.shape_type)
    n = st.shape[0]
    mins = np.full((n, 3), np.inf, np.float32)
    maxs = np.full((n, 3), -np.inf, np.float32)

    sph = st == SPHERE
    if sph.any():
        c = to_numpy(scene.sphere_center)[sph]
        r = to_numpy(scene.sphere_radius)[sph][:, None]
        mins[sph] = c - r
        maxs[sph] = c + r

    wl = st == WALL
    if wl.any():
        start = to_numpy(scene.wall_start)[wl]
        end = np.asarray(wall_end(scene, wl))
        mins[wl] = np.minimum(start, end)
        maxs[wl] = np.maximum(start, end)

    tri = st == TRIANGLE
    if tri.any():
        p = np.stack([to_numpy(scene.tri_p1)[tri],
                      to_numpy(scene.tri_p2)[tri],
                      to_numpy(scene.tri_p3)[tri]], axis=1)
        finite = np.isfinite(p).all(axis=(1, 2))
        if not finite.all():
            warnings.warn("Invalid (non-finite) triangle vertices skipped in "
                          "AABB growth (BoundingBox.hpp:57-64)")
        pm = np.where(finite[:, None, None], p, np.inf)
        px = np.where(finite[:, None, None], p, -np.inf)
        mins[tri] = pm.min(axis=1)
        maxs[tri] = px.max(axis=1)

    if (st == PLANE).any():
        warnings.warn("bare Plane shapes have infinite extent and are "
                      "skipped by AABB growth (BoundingBox.hpp:87-95); do "
                      "not put them in a BVH")
    return mins, maxs


def shape_centers(scene: FlatScene) -> np.ndarray:
    """Split-plane centers (src/main.cpp:1127-1153): sphere center,
    (start + end())/2 for walls, centroid for triangles, zeros for planes."""
    st = to_numpy(scene.shape_type)
    n = st.shape[0]
    centers = np.zeros((n, 3), np.float32)
    sph = st == SPHERE
    centers[sph] = to_numpy(scene.sphere_center)[sph]
    wl = st == WALL
    if wl.any():
        start = to_numpy(scene.wall_start)[wl]
        end = np.asarray(wall_end(scene, wl))
        centers[wl] = (start + end) * 0.5
    tri = st == TRIANGLE
    if tri.any():
        centers[tri] = (to_numpy(scene.tri_p1)[tri]
                        + to_numpy(scene.tri_p2)[tri]
                        + to_numpy(scene.tri_p3)[tri]) / 3.0
    return centers
