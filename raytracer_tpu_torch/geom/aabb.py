"""AABB helpers (port of ``raytracer_tpu/geom/aabb.py``, reference
src/BoundingBox.hpp): ``shape_aabbs`` and ``shape_centers`` in numpy on
the host for the BVH build, and ``wall_end_device``, ``shape_aabbs_device``
and ``shape_centers_device`` as tensor code on the tensors' device for the
per-step table refresh and the per-frame LBVH rebuild (``wall_end_jnp``,
``shape_aabbs_jnp``, ``shape_centers_jnp``).

  sphere   -> center +- radius
  wall     -> start and Wall::end() corners
  triangle -> the three vertices (skipped if any coordinate is non-finite)
  plane    -> skipped (infinite extent), with a warning
"""

from __future__ import annotations

import warnings
from typing import Tuple

import numpy as np
import torch

from raytracer_tpu_torch.core.scene import (PLANE, SPHERE, TRIANGLE, WALL,
                                            FlatScene, to_numpy, wall_end)
from raytracer_tpu_torch.geom.direct import div_rn, sqrt_rn


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


def _normalized(v: torch.Tensor) -> torch.Tensor:
    """v / |v| where |v| > 0, else v (zero); |v| is the correctly rounded
    root of x*x + y*y + z*z, as jnp.linalg.norm computes it."""
    n = sqrt_rn(v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1]
                + v[:, 2] * v[:, 2])[:, None]
    return v / torch.where(n > 0, n, 1.0)


def wall_end_device(normal: torch.Tensor, start: torch.Tensor,
                    width: torch.Tensor, height: torch.Tensor
                    ) -> torch.Tensor:
    """``Wall::end()`` (wall.hpp:16-31) as tensor code over (N, 3) / (N,)
    inputs: start + width * t1 + height * t2 with the tangent basis."""
    n = normal
    use_x = torch.abs(n[:, 0]) > torch.abs(n[:, 1])
    zeros = torch.zeros_like(n[:, 0])
    t1 = torch.where(use_x[:, None],
                     torch.stack([-n[:, 2], zeros, n[:, 0]], -1),
                     torch.stack([zeros, -n[:, 2], n[:, 1]], -1))
    t1 = _normalized(t1)
    t2 = _normalized(torch.linalg.cross(n, t1, dim=-1))
    return start + width[:, None] * t1 + height[:, None] * t2


def shape_aabbs_device(scene: FlatScene
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-shape AABBs ((N, 3) min / max) on the scene's device. Planes
    get zero boxes (they must not enter a rebuilt tree)."""
    st = scene.shape_type
    c = scene.sphere_center
    r = scene.sphere_radius[:, None]
    end = wall_end_device(scene.plane_normal, scene.wall_start,
                          scene.wall_width, scene.wall_height)
    p1, p2, p3 = scene.tri_p1, scene.tri_p2, scene.tri_p3
    is_s = (st == SPHERE)[:, None]
    is_w = (st == WALL)[:, None]
    is_t = (st == TRIANGLE)[:, None]
    mins = torch.where(is_s, c - r, torch.where(
        is_w, torch.minimum(scene.wall_start, end), torch.where(
            is_t, torch.minimum(torch.minimum(p1, p2), p3), 0.0)))
    maxs = torch.where(is_s, c + r, torch.where(
        is_w, torch.maximum(scene.wall_start, end), torch.where(
            is_t, torch.maximum(torch.maximum(p1, p2), p3), 0.0)))
    return mins, maxs


def shape_centers_device(scene: FlatScene) -> torch.Tensor:
    """Split / Morton centers ((N, 3), main.cpp:1127-1153 semantics) on the
    scene's device: sphere center, (start + end()) / 2 for walls, the
    vertex mean for triangles, zeros for planes."""
    st = scene.shape_type
    end = wall_end_device(scene.plane_normal, scene.wall_start,
                          scene.wall_width, scene.wall_height)
    wall_c = (scene.wall_start + end) * 0.5
    # IEEE division on both devices (CUDA's division by a Python scalar
    # multiplies by its reciprocal)
    tri_c = div_rn(scene.tri_p1 + scene.tri_p2 + scene.tri_p3, 3.0)
    is_s = (st == SPHERE)[:, None]
    is_w = (st == WALL)[:, None]
    is_t = (st == TRIANGLE)[:, None]
    return torch.where(is_s, scene.sphere_center, torch.where(
        is_w, wall_c, torch.where(is_t, tri_c, 0.0)))
