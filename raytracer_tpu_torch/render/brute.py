"""The brute-force renderer (port of
``raytracer_tpu/render/pallas_kernel.py``): every ray against every
shape, the shapes sorted by type (spheres, planes, walls, then
triangles), with an optional gate by each shape's reference leaf box so
that the image matches the BVH renderers; the Whitted loop of
``whitted.trace`` around it.

``brute_hit`` wraps the CUDA kernel ``brute_kernel`` (csrc/raytrace.cu),
which replaces the TPU kernel ``_closest_hit_kernel`` (pallas_kernel.py:
95). On a CPU tensor it runs ``brute_plain``: chunks of rays against all
rows at once, through ``geom.rowwise.intersect_rows``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from raytracer_tpu_torch.accel.linearize import shape_leaf_boxes
from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.core.camera import camera_rays
from raytracer_tpu_torch.core.scene import PLANE, SPHERE, TRIANGLE, WALL
from raytracer_tpu_torch.device import resolve_device
from raytracer_tpu_torch.geom import rowwise
from raytracer_tpu_torch.geom.direct import INF, div_rn
from raytracer_tpu_torch.render import kernels, shading, whitted

# Rows 24-29 of the extended pack: the shape's leaf box (min xyz, max xyz).
F_B0X = rowwise.PACK_WIDTH
PACK_EXT = F_B0X + 6
# Ray x shape pairs per pass of the plain version (bounds its temporaries).
PLAIN_PAIRS = 1 << 22


def sort_scene_by_type(scene) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    """A stable permutation that sorts the shapes by type, and the counts
    of spheres, planes, walls and triangles."""
    st = scene.shape_type.cpu()
    perm = torch.sort(st, stable=True).indices.to(torch.int32)
    counts = tuple(int((st == k).sum()) for k in (SPHERE, PLANE, WALL,
                                                  TRIANGLE))
    return perm, counts


def pack_rows_ext(scene, perm: torch.Tensor, leaf_boxes=None) -> torch.Tensor:
    """(N, PACK_EXT) packed rows in ``perm`` order with the leaf-box
    columns; without leaf boxes the box is [-INF, +INF] (never gates)."""
    rows = rowwise.pack_rows(scene)
    n, dev = rows.shape[0], rows.device
    if leaf_boxes is None:
        bmin = torch.full((n, 3), -INF, dtype=torch.float32, device=dev)
        bmax = torch.full((n, 3), INF, dtype=torch.float32, device=dev)
    else:
        bmin, bmax = (b.to(dev) for b in leaf_boxes)
    rows = torch.cat([rows, bmin, bmax], dim=1)
    return rows[perm.to(dev).long()].contiguous()


def brute_plain(rows_ext: torch.Tensor, counts, o: torch.Tensor,
                d: torch.Tensor, use_mt: bool, gate_boxes: bool):
    """Plain version of ``brute_kernel``: (t, row int32), the type-sorted
    row of the closest inner hit (the first row that attains the least t),
    INF and 0 on a miss. With ``gate_boxes`` a hit counts only where the
    ray hits the row's leaf box. ``counts`` only fixes the row order the
    kernel assumes; the union test reads each row's type."""
    n_rows = sum(counts)
    if rows_ext.shape[0] != n_rows:
        raise ValueError(f"{rows_ext.shape[0]} rows, counts sum to {n_rows}")
    n = o.shape[0]
    t_out = torch.full((n,), INF, dtype=torch.float32, device=o.device)
    row_out = torch.zeros(n, dtype=torch.int32, device=o.device)
    if n_rows == 0:
        return t_out, row_out
    rows = rows_ext[None]
    chunk = max(1, PLAIN_PAIRS // n_rows)
    for c in range(0, n, chunk):
        oc, dc = o[c:c + chunk, None], d[c:c + chunk, None]
        t, inner = rowwise.intersect_rows(rows[..., :F_B0X], oc, dc, use_mt)
        if gate_boxes:
            tmin, tmax = rowwise.slab(rows[..., F_B0X:], oc, 1.0 / dc)
            t = torch.where((tmax >= tmin) & (tmax > 0), t, INF)
        best, j = torch.min(t, dim=1)
        hit = best < INF
        t_out[c:c + chunk] = torch.where(hit, best, INF)
        row_out[c:c + chunk] = torch.where(hit, j, 0).to(torch.int32)
    return t_out, row_out


def brute_hit(rows_ext: torch.Tensor, counts, o: torch.Tensor,
              d: torch.Tensor, use_mt: bool, gate_boxes: bool):
    """Closest hit of R rays o, d (R, 3) f32 over the type-sorted rows:
    (t, row int32). On a CUDA tensor this launches ``brute_kernel``; on a
    CPU tensor it runs ``brute_plain``."""
    dev = o.device
    if dev.type == "cpu":
        return brute_plain(rows_ext, counts, o, d, use_mt, gate_boxes)
    if dev.type != "cuda":
        raise ValueError(f"brute_hit: unsupported device {dev}")
    n = o.shape[0]
    n_sph, n_pl, n_wall, n_tri = counts
    kernels.check_tensor("rows_ext", rows_ext, torch.float32, dev,
                         (sum(counts), PACK_EXT))
    kernels.check_tensor("o", o, torch.float32, dev, (None, 3))
    kernels.check_tensor("d", d, torch.float32, dev, (n, 3))
    t = torch.empty(n, dtype=torch.float32, device=dev)
    row = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return t, row
    status = kernels.library().rt_brute(
        rows_ext.data_ptr(), n_sph, n_pl, n_wall, n_tri, o.data_ptr(),
        d.data_ptr(), n, t.data_ptr(), row.data_ptr(), int(use_mt),
        int(gate_boxes), kernels.stream_ptr(dev))
    kernels.check_status("brute_kernel", status)
    brute_hit.launches += 1
    return t, row


brute_hit.launches = 0


def make_closest_hit(rows_ext: torch.Tensor, perm: torch.Tensor, counts,
                     cfg: RenderConfig, gate_boxes: bool = False):
    """closest_hit(o, d) -> (t, sid, hit) over the type-sorted rows, as
    ``pallas_kernel.make_closest_hit``: sid = perm[row], so a miss gives
    perm[0]."""
    perm = perm.to(device=rows_ext.device, dtype=torch.int64)

    def closest_hit(o, d):
        t, row = brute_hit(rows_ext, counts, o.contiguous(), d.contiguous(),
                           cfg.use_mt, gate_boxes)
        return t, perm[row.long()].to(torch.int32), t < INF

    return closest_hit


def render(scene, bvh, camera, light, cfg: RenderConfig,
           device=None) -> torch.Tensor:
    """Render (H, W, 3) f32 with the brute-force kernel. With a reference
    LinearBVH ``bvh`` and ``cfg.use_bvh``, each shape's leaf box gates its
    hits, so the image matches the BVH renderers. ``device`` None means
    "cuda"; "cpu" runs the plain version."""
    dev = resolve_device(device)
    scene, camera, light = scene.to(dev), camera.to(dev), light.to(dev)
    perm, counts = sort_scene_by_type(scene)
    leaf_boxes = None
    if bvh is not None and cfg.use_bvh:
        leaf_boxes = shape_leaf_boxes(bvh, scene.num_shapes)
    rows_ext = pack_rows_ext(scene, perm, leaf_boxes)
    closest = make_closest_hit(rows_ext, perm, counts, cfg,
                               gate_boxes=leaf_boxes is not None)
    h, w = cfg.height, cfg.width
    o, d = camera_rays(camera, w, h)
    ys = div_rn(torch.arange(h, dtype=torch.float32, device=dev), h)
    bg = torch.broadcast_to(shading.background(ys)[:, None, :], (h, w, 3))
    o, d, bg = (x.reshape(-1, 3).contiguous() for x in (o, d, bg))
    colors = whitted.trace(scene, light, closest, o, d, bg, cfg)
    return colors.reshape(h, w, 3)
