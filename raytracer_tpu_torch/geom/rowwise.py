"""Packed per-shape geometry rows and the row-wise intersection (port of
``raytracer_tpu/geom/rowwise.py``): ``pack_rows`` feeds the split scene
prep and the BVH renderers; ``intersect_rows`` is the per-lane type-union
test that the packet, brute-force and wavefront walks' plain versions
share (reference gpu_shader.comp:242-328).

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

A degenerate triangle (denom == 0) packs S2=S3=S4=0, which yields v = w =
0, u = 1: always "inside" its plane, as the reference's NaN compares are.
"""

from __future__ import annotations

import torch

from raytracer_tpu_torch.core.scene import (PLANE, SPHERE, TRIANGLE, WALL,
                                            FlatScene)
from raytracer_tpu_torch.geom.direct import INF, sqrt_rn, wall_basis

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


def intersect_rows(rows: torch.Tensor, o: torch.Tensor, d: torch.Tensor,
                   use_mt: bool = False):
    """Intersect lane i's ray (o[i], d[i]) with lane i's packed row
    rows[i]: rows (..., PACK_WIDTH), o, d (..., 3), broadcasting. Returns
    (t, inner), t = INF where not inner. Every sum is added left to right
    and every operation rounded on its own, as the CUDA kernels
    (csrc/raytrace.cuh::row_intersect) compute it; the square root is
    correctly rounded (``sqrt_rn``)."""
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    typ = rows[..., 0]

    # sphere
    ocx = ox - rows[..., 1]
    ocy = oy - rows[..., 2]
    ocz = oz - rows[..., 3]
    r = rows[..., 4]
    aa = dx * dx + dy * dy + dz * dz
    bb = 2.0 * (dx * ocx + dy * ocy + dz * ocz)
    cc = ocx * ocx + ocy * ocy + ocz * ocz - r * r
    disc = bb * bb - 4.0 * aa * cc
    sq = sqrt_rn(torch.where(disc > 0, disc, 1.0))
    t_sph = (-bb - sq) / (2.0 * aa)
    v_sph = (disc > 0) & (t_sph > 0)

    # plane family
    nx, ny, nz = rows[..., 5], rows[..., 6], rows[..., 7]
    d_n = dx * nx + dy * ny + dz * nz
    o_n = ox * nx + oy * ny + oz * nz
    t_pl = -(rows[..., 8] + o_n) / torch.where(d_n == 0, 1.0, d_n)
    v_pl = (d_n > 0) & (t_pl > 0)
    tw = torch.where(v_pl, t_pl, 0.0)
    hx, hy, hz = ox + tw * dx, oy + tw * dy, oz + tw * dz

    v1x, v1y, v1z = rows[..., 9], rows[..., 10], rows[..., 11]
    v2x, v2y, v2z = rows[..., 12], rows[..., 13], rows[..., 14]
    s0, s1, s2, s3, s4 = (rows[..., 18], rows[..., 19], rows[..., 20],
                          rows[..., 21], rows[..., 22])

    # wall: V1=u, V2=v, s0=dot(start,u), s1=dot(start,v), s2=w, s3=h
    u_proj = hx * v1x + hy * v1y + hz * v1z - s0
    v_proj = hx * v2x + hy * v2y + hz * v2z - s1
    outside_w = (u_proj < 0) | (u_proj > s2) | (v_proj < 0) | (v_proj > s3)
    v_wall = v_pl & ((rows[..., 23] > 0) | ~outside_w)

    # triangle
    if use_mt:
        smx = ox - rows[..., 15]
        smy = oy - rows[..., 16]
        smz = oz - rows[..., 17]
        hcx = dy * v2z - dz * v2y
        hcy = dz * v2x - dx * v2z
        hcz = dx * v2y - dy * v2x
        a = v1x * hcx + v1y * hcy + v1z * hcz
        ok = torch.abs(a) >= 1e-5
        f = 1.0 / torch.where(ok, a, 1.0)
        u = f * (smx * hcx + smy * hcy + smz * hcz)
        ok = ok & (u >= 0) & (u <= 1)
        qx = smy * v1z - smz * v1y
        qy = smz * v1x - smx * v1z
        qz = smx * v1y - smy * v1x
        v = f * (dx * qx + dy * qy + dz * qz)
        ok = ok & (v >= 0) & (u + v <= 1)
        t_tri = f * (v2x * qx + v2y * qy + v2z * qz)
        v_tri = ok & (t_tri > 0)
    else:
        # barycentric with premultiplied ratios: s0=p1e1, s1=p1e2,
        # s2=d11/denom, s3=d01/denom, s4=d00/denom; (d20, d21) are the
        # wall's (u_proj, v_proj)
        v = s2 * u_proj - s3 * v_proj
        w = s4 * v_proj - s3 * u_proj
        u = 1.0 - v - w
        v_tri = v_pl & ~((u < 0) | (v < 0) | (w < 0))
        t_tri = t_pl

    inner = torch.where(typ == SPHERE, v_sph,
                        torch.where(typ == PLANE, v_pl,
                                    torch.where(typ == WALL, v_wall, v_tri)))
    t = torch.where(typ == SPHERE, t_sph,
                    torch.where(typ == TRIANGLE, t_tri, t_pl))
    return torch.where(inner, t, INF), inner


def slab(box: torch.Tensor, o: torch.Tensor, inv_d: torch.Tensor):
    """Slab test of rays o, 1/d (..., 3) against boxes (..., 6+) (min xyz,
    max xyz): (tmin, tmax). min and max propagate NaN, as jnp.minimum and
    jnp.maximum do, so a NaN ray hits no box; a zero direction component
    gives +-inf (IEEE 1/0)."""
    t0 = (box[..., 0:3] - o) * inv_d
    t1 = (box[..., 3:6] - o) * inv_d
    return (torch.minimum(t0, t1).amax(-1), torch.maximum(t0, t1).amin(-1))
