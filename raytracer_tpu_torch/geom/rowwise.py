"""Packed per-shape geometry rows (port of ``pack_rows`` from
``raytracer_tpu/geom/rowwise.py``; the only part the split scene prep
uses).

Packed row layout (PACK_WIDTH f32 per shape):
  [0]      type tag (0 sphere / 1 plane / 2 wall / 3 triangle)
  [1:4]    sphere center          [4]  sphere radius
  [5:8]    plane normal           [8]  plane d
  [9:12]   V1: wall u      | tri e1
  [12:15]  V2: wall v      | tri e2
  [15:18]  V3: (unused)    | tri p1
  [18]     S0: dot(start,u)| dot(p1,e1)
  [19]     S1: dot(start,v)| dot(p1,e2)
  [20]     S2: width       | d11/denom
  [21]     S3: height      | d01/denom
  [22]     S4: (unused)    | d00/denom
  [23]     W : wall degenerate-basis flag (1.0 -> infinite plane)
"""

from __future__ import annotations

import torch

from raytracer_tpu_torch.core.scene import WALL, FlatScene
from raytracer_tpu_torch.geom.direct import wall_basis

PACK_WIDTH = 24


def pack_rows(scene: FlatScene) -> torch.Tensor:
    """Pack per-shape geometry into (N, PACK_WIDTH) f32."""
    wu, wv, w_deg = wall_basis(scene.plane_normal)
    e1 = scene.tri_p2 - scene.tri_p1
    e2 = scene.tri_p3 - scene.tri_p1
    d00 = torch.sum(e1 * e1, -1)
    d01 = torch.sum(e1 * e2, -1)
    d11 = torch.sum(e2 * e2, -1)
    denom = d00 * d11 - d01 * d01
    safe = torch.where(denom == 0, 1.0, denom)
    r11 = torch.where(denom == 0, 0.0, d11 / safe)
    r01 = torch.where(denom == 0, 0.0, d01 / safe)
    r00 = torch.where(denom == 0, 0.0, d00 / safe)

    is_wall = scene.shape_type == WALL
    v1 = torch.where(is_wall[:, None], wu, e1)
    v2 = torch.where(is_wall[:, None], wv, e2)
    s0 = torch.where(is_wall, torch.sum(scene.wall_start * wu, -1),
                     torch.sum(scene.tri_p1 * e1, -1))
    s1 = torch.where(is_wall, torch.sum(scene.wall_start * wv, -1),
                     torch.sum(scene.tri_p1 * e2, -1))
    s2 = torch.where(is_wall, scene.wall_width, r11)
    s3 = torch.where(is_wall, scene.wall_height, r01)
    s4 = torch.where(is_wall, 0.0, r00)

    return torch.cat([
        scene.shape_type.to(torch.float32)[:, None],
        scene.sphere_center, scene.sphere_radius[:, None],
        scene.plane_normal, scene.plane_d[:, None],
        v1, v2, scene.tri_p1,
        s0[:, None], s1[:, None], s2[:, None], s3[:, None], s4[:, None],
        w_deg.to(torch.float32)[:, None],
    ], dim=1)
