"""Batched ray-x-shape intersection: every ray against every shape (port
of ``raytracer_tpu/geom/batched.py``), the closest-hit query of the
brute-force oracle (``render/reference.py``) and the CPU fallback.

R rays are tested against N shapes into (R, N) t and hit tensors without
an (R, N, 3) tensor: vectors are held as x/y/z component planes of shape
(R, 1) (rays) and (1, N) (shapes) that broadcast to (R, N), in the JAX
function's formulation and order of operations (which mirror the
reference GLSL, gpu_shader.comp:170-328). A (R,3)@(3,N) matmul is not
used: its expanded quadratic terms (|o|^2 - 2 o.c + |c|^2) cancel
catastrophically at f32 near grazing hits.

Every operation is rounded on its own; sums are added left to right;
square roots are correctly rounded (``sqrt_rn``), so the card and the
CPU compute the same bits. The guards before each square root and
division (``where(disc > 0, disc, 1)``) keep the autograd gradient
finite where a branch is not taken.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from raytracer_tpu_torch.core.scene import (PLANE, SPHERE, TRIANGLE, WALL,
                                            FlatScene)
from raytracer_tpu_torch.geom.direct import INF, sqrt_rn, wall_basis


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis of size 3, added left to right."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


@dataclasses.dataclass
class GeomCache:
    """Per-shape derived tensors; functions of the FlatScene, so that
    gradients flow back to the scene through the cache."""

    n: torch.Tensor            # (N,3) plane normal
    pd: torch.Tensor           # (N,)  plane d
    c: torch.Tensor            # (N,3) sphere centers
    r: torch.Tensor            # (N,)  sphere radii
    wu: torch.Tensor           # (N,3) wall u basis (zeros when degenerate)
    wv: torch.Tensor           # (N,3) wall v basis
    w_deg: torch.Tensor        # (N,)  degenerate-basis mask (-> all inside)
    ws: torch.Tensor           # (N,3) wall start
    ww: torch.Tensor           # (N,)  width
    wh: torch.Tensor           # (N,)  height
    p1: torch.Tensor           # (N,3) triangle p1
    e1: torch.Tensor           # (N,3) p2-p1
    e2: torch.Tensor           # (N,3) p3-p1
    d00: torch.Tensor          # (N,)  dot(e1,e1)
    d01: torch.Tensor          # (N,)  dot(e1,e2)
    d11: torch.Tensor          # (N,)  dot(e2,e2)
    denom: torch.Tensor        # (N,)  d00*d11 - d01^2
    is_sphere: torch.Tensor    # (N,) bool
    is_plane: torch.Tensor
    is_wall: torch.Tensor
    is_tri: torch.Tensor


def precompute(scene: FlatScene) -> GeomCache:
    n = scene.plane_normal
    wu, wv, w_deg = wall_basis(n)
    e1 = scene.tri_p2 - scene.tri_p1
    e2 = scene.tri_p3 - scene.tri_p1
    d00 = _dot(e1, e1)
    d01 = _dot(e1, e2)
    d11 = _dot(e2, e2)
    st = scene.shape_type
    return GeomCache(
        n=n, pd=scene.plane_d,
        c=scene.sphere_center, r=scene.sphere_radius,
        wu=wu, wv=wv, w_deg=w_deg, ws=scene.wall_start,
        ww=scene.wall_width, wh=scene.wall_height,
        p1=scene.tri_p1, e1=e1, e2=e2,
        d00=d00, d01=d01, d11=d11, denom=d00 * d11 - d01 * d01,
        is_sphere=st == SPHERE, is_plane=st == PLANE,
        is_wall=st == WALL, is_tri=st == TRIANGLE,
    )


def _ray_planes(v):
    """Split (R,3) into three (R,1) component planes."""
    return v[:, 0:1], v[:, 1:2], v[:, 2:3]


def _shape_planes(v):
    """Split (N,3) into three (1,N) component planes."""
    return v[None, :, 0], v[None, :, 1], v[None, :, 2]


def intersect_scene(cache: GeomCache, o: torch.Tensor, d: torch.Tensor,
                    use_mt: bool = False,
                    leaf_boxes=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Test R rays against all N shapes. o, d: (R,3) with unit directions.
    Returns (t, inner) of shape (R, N); t = INF where not INNER.

    leaf_boxes: optional ((N,3) min, (N,3) max) per-shape BVH-leaf AABBs
    (``accel.linearize.shape_leaf_boxes``). When given, a shape only
    counts as hit if the ray also passes the slab test of its leaf box:
    this reproduces BVH-traversal visibility exactly (a shape is tested
    iff its leaf box is hit; ancestor boxes contain leaf boxes, so they
    never prune more). That is how the reference's useBVH=true image
    differs from useBVH=false: scene 1's infinite-plane floor wall is
    clipped to its finite leaf box.
    """
    ox, oy, oz = _ray_planes(o)
    dx, dy, dz = _ray_planes(d)

    # --- sphere (gpu_shader.comp:246-271) ---------------------------------
    cx, cy, cz = _shape_planes(cache.c)
    ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
    aa = dx * dx + dy * dy + dz * dz                      # (R,1)
    bb = 2.0 * (dx * ocx + dy * ocy + dz * ocz)           # (R,N)
    r = cache.r[None, :]
    ccq = ocx * ocx + ocy * ocy + ocz * ocz - r * r
    disc = bb * bb - 4.0 * aa * ccq
    sq = sqrt_rn(torch.where(disc > 0, disc, 1.0))
    t_sph = (-bb - sq) / (2.0 * aa)
    v_sph = (disc > 0) & (t_sph > 0)

    # --- plane family base (gpu_shader.comp:272-286) ----------------------
    nx, ny, nz = _shape_planes(cache.n)
    d_n = dx * nx + dy * ny + dz * nz
    o_n = ox * nx + oy * ny + oz * nz
    t_pl = -(cache.pd[None, :] + o_n) / torch.where(d_n == 0, 1.0, d_n)
    v_pl = (d_n > 0) & (t_pl > 0)
    tw = torch.where(v_pl, t_pl, 0.0)
    # plane-family hit point components (shared by wall + barycentric)
    hx, hy, hz = ox + tw * dx, oy + tw * dy, oz + tw * dz

    # --- wall rectangle bound (gpu_shader.comp:287-316) -------------------
    ux, uy, uz = _shape_planes(cache.wu)
    vx, vy, vz = _shape_planes(cache.wv)
    sx, sy, sz = _shape_planes(cache.ws)
    lx, ly, lz = hx - sx, hy - sy, hz - sz
    u_proj = lx * ux + ly * uy + lz * uz
    v_proj = lx * vx + ly * vy + lz * vz
    outside_w = ((u_proj < 0) | (u_proj > cache.ww[None, :])
                 | (v_proj < 0) | (v_proj > cache.wh[None, :]))
    v_wall = v_pl & (cache.w_deg[None, :] | ~outside_w)

    # --- triangle ---------------------------------------------------------
    p1x, p1y, p1z = _shape_planes(cache.p1)
    e1x, e1y, e1z = _shape_planes(cache.e1)
    e2x, e2y, e2z = _shape_planes(cache.e2)
    if use_mt:
        # Moller-Trumbore (gpu_shader.comp:170-195); double-sided.
        hcx = dy * e2z - dz * e2y
        hcy = dz * e2x - dx * e2z
        hcz = dx * e2y - dy * e2x
        a = e1x * hcx + e1y * hcy + e1z * hcz
        ok = torch.abs(a) >= 1e-5
        f = 1.0 / torch.where(ok, a, 1.0)
        smx, smy, smz = ox - p1x, oy - p1y, oz - p1z
        u = f * (smx * hcx + smy * hcy + smz * hcz)
        ok = ok & (u >= 0) & (u <= 1)
        qx = smy * e1z - smz * e1y
        qy = smz * e1x - smx * e1z
        qz = smx * e1y - smy * e1x
        v = f * (dx * qx + dy * qy + dz * qz)
        ok = ok & (v >= 0) & (u + v <= 1)
        t_tri = f * (e2x * qx + e2y * qy + e2z * qz)
        v_tri = ok & (t_tri > 0)
    else:
        # barycentric inside-test on the plane hit (gpu_shader.comp:196-240)
        tpx, tpy, tpz = hx - p1x, hy - p1y, hz - p1z
        d20 = tpx * e1x + tpy * e1y + tpz * e1z
        d21 = tpx * e2x + tpy * e2y + tpz * e2z
        deg = (cache.denom == 0)[None, :]
        safe = torch.where(deg, 1.0, cache.denom[None, :])
        v = (cache.d11[None, :] * d20 - cache.d01[None, :] * d21) / safe
        w = (cache.d00[None, :] * d21 - cache.d01[None, :] * d20) / safe
        u = 1.0 - v - w
        outside_t = (u < 0) | (v < 0) | (w < 0)
        v_tri = v_pl & (deg | ~outside_t)
        t_tri = t_pl

    # --- select by type tag (gpu_shader.comp:242-328) ---------------------
    inner = torch.where(
        cache.is_sphere[None, :], v_sph,
        torch.where(cache.is_plane[None, :], v_pl,
                    torch.where(cache.is_wall[None, :], v_wall, v_tri)))
    t = torch.where(
        cache.is_sphere[None, :], t_sph,
        torch.where(cache.is_tri[None, :], t_tri, t_pl))

    if leaf_boxes is not None:
        bmin, bmax = leaf_boxes
        inv_x = 1.0 / dx
        inv_y = 1.0 / dy
        inv_z = 1.0 / dz
        bx0, by0, bz0 = _shape_planes(bmin)
        bx1, by1, bz1 = _shape_planes(bmax)
        tx0 = (bx0 - ox) * inv_x
        tx1 = (bx1 - ox) * inv_x
        ty0 = (by0 - oy) * inv_y
        ty1 = (by1 - oy) * inv_y
        tz0 = (bz0 - oz) * inv_z
        tz1 = (bz1 - oz) * inv_z
        tmin = torch.maximum(torch.maximum(torch.minimum(tx0, tx1),
                                           torch.minimum(ty0, ty1)),
                             torch.minimum(tz0, tz1))
        tmax = torch.minimum(torch.minimum(torch.maximum(tx0, tx1),
                                           torch.maximum(ty0, ty1)),
                             torch.maximum(tz0, tz1))
        inner = inner & (tmax >= tmin) & (tmax > 0)

    t = torch.where(inner, t, INF)
    return t, inner


def closest_hit(cache: GeomCache, o: torch.Tensor, d: torch.Tensor,
                use_mt: bool = False, leaf_boxes=None):
    """Closest INNER hit per ray (the useBVH=false linear scan,
    gpu_shader.comp:538-554). Returns (t, shape_idx int32, hit), (R,).

    Ties resolve to the lowest shape index, matching the reference's strict
    ``dist < closestDist`` forward scan: ``torch.argmin`` returns the
    first minimum, as ``jnp.argmin`` does (a miss, all INF, gives 0).
    """
    t, inner = intersect_scene(cache, o, d, use_mt, leaf_boxes)
    sid = torch.argmin(t, dim=-1)
    tmin = torch.gather(t, 1, sid[:, None])[:, 0]
    hit = torch.any(inner, dim=-1)
    return tmin, sid.to(torch.int32), hit


def shape_normal(scene: FlatScene, sid: torch.Tensor, point: torch.Tensor
                 ) -> torch.Tensor:
    """getNormalFromShape (gpu_shader.comp:64-71): sphere ->
    normalize(p - center); plane/wall/triangle -> stored plane normal."""
    sid = sid.long()
    st = scene.shape_type.index_select(0, sid)
    center = scene.sphere_center.index_select(0, sid)
    pn = scene.plane_normal.index_select(0, sid)
    rel = point - center
    norm = sqrt_rn(torch.clamp_min(_dot(rel, rel), 1e-30))[..., None]
    sphere_n = rel / norm
    return torch.where((st == SPHERE)[..., None], sphere_n, pn)
