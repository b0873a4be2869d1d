"""The brute-force renderer (port of
``raytracer_tpu/render/pallas_kernel.py``): every ray against every
shape, the shapes sorted by type (spheres, planes, walls, then
triangles), with an optional gate by each shape's reference leaf box so
that the image matches the BVH renderers; the Whitted loop of
``whitted.trace`` around it.

``brute_hit`` wraps the CUDA kernel ``brute_kernel`` (csrc/raytrace.cu),
which replaces the TPU kernel ``_closest_hit_kernel`` (pallas_kernel.py:
95). The kernel gates first, once per run of rows that share a leaf box
(``box_runs``), and tests only the rows whose gate passes. On a CPU tensor
it runs ``brute_plain``: chunks of rays against all rows at once, through
``geom.rowwise.intersect_rows``.
"""

from __future__ import annotations

import itertools
from typing import Optional, Tuple

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
# Columns of the run table (csrc/raytrace.cuh RUN_W): the box min xyz and
# max xyz, the first row and the row count, the last two exact in f32.
RUN_W = 8
MAX_ROWS = 1 << 24


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


def box_runs(rows_ext: torch.Tensor, counts,
             gate_boxes: bool = True) -> torch.Tensor:
    """(R, RUN_W) f32 run table of ``brute_kernel``: the maximal ranges of
    consecutive rows that hold one type (``counts`` in type-sorted order)
    and, with ``gate_boxes``, bitwise-equal leaf-box columns (so a run's
    gate decides for each of its rows); without, each type's rows are one
    run. Each run is its box, its first row and its row count. Tensor ops
    on the rows' device (one host sync, for the count of runs)."""
    n, dev = rows_ext.shape[0], rows_ext.device
    if n != sum(counts):
        raise ValueError(f"{n} rows, counts sum to {sum(counts)}")
    if n >= MAX_ROWS:
        raise ValueError(f"{n} rows: the run table holds row indices "
                         f"below {MAX_ROWS} exactly")
    if n == 0:
        return torch.zeros((0, RUN_W), dtype=torch.float32, device=dev)
    new = torch.zeros(n, dtype=torch.bool, device=dev)
    if gate_boxes:
        bits = rows_ext[:, F_B0X:PACK_EXT].contiguous().view(torch.int32)
        new[1:] = (bits[1:] != bits[:-1]).any(1)
    firsts = [0] + [s for s in itertools.accumulate(counts[:-1]) if s < n]
    new[torch.tensor(firsts, dtype=torch.long, device=dev)] = True
    start = torch.nonzero(new).squeeze(1)
    count = torch.diff(start, append=start.new_tensor([n]))
    return torch.cat([rows_ext[start, F_B0X:PACK_EXT],
                      start[:, None].to(torch.float32),
                      count[:, None].to(torch.float32)], dim=1).contiguous()


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
              d: torch.Tensor, use_mt: bool, gate_boxes: bool,
              runs: Optional[torch.Tensor] = None,
              stats: Optional[torch.Tensor] = None):
    """Closest hit of R rays o, d (R, 3) f32 over the type-sorted rows:
    (t, row int32). On a CUDA tensor this launches ``brute_kernel`` over
    ``runs``, the rows' ``box_runs`` (built here when None); on a CPU
    tensor it runs ``brute_plain``. ``stats``, an int64 (3,) tensor on the
    card, receives the lanes' gate tests and row tests and the warps' row
    steps."""
    dev = o.device
    if dev.type == "cpu":
        return brute_plain(rows_ext, counts, o, d, use_mt, gate_boxes)
    if dev.type != "cuda":
        raise ValueError(f"brute_hit: unsupported device {dev}")
    n = o.shape[0]
    n_sph, n_pl, n_wall, _ = counts
    kernels.check_tensor("rows_ext", rows_ext, torch.float32, dev,
                         (sum(counts), PACK_EXT))
    if runs is None:
        runs = box_runs(rows_ext, counts, gate_boxes)
    kernels.check_tensor("runs", runs, torch.float32, dev, (None, RUN_W))
    kernels.check_tensor("o", o, torch.float32, dev, (None, 3))
    kernels.check_tensor("d", d, torch.float32, dev, (n, 3))
    if stats is not None:
        kernels.check_tensor("stats", stats, torch.int64, dev, (3,))
    t = torch.empty(n, dtype=torch.float32, device=dev)
    row = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return t, row
    kernels.launch(
        "brute_kernel", "rt_brute", dev, rows_ext.data_ptr(), runs.data_ptr(),
        runs.shape[0], n_sph, n_pl, n_wall, o.data_ptr(), d.data_ptr(), n,
        t.data_ptr(), row.data_ptr(), int(use_mt), int(gate_boxes),
        None if stats is None else stats.data_ptr())
    brute_hit.launches += 1
    return t, row


brute_hit.launches = 0


def make_closest_hit(rows_ext: torch.Tensor, perm: torch.Tensor, counts,
                     cfg: RenderConfig, gate_boxes: bool = False):
    """closest_hit(o, d) -> (t, sid, hit) over the type-sorted rows, as
    ``pallas_kernel.make_closest_hit``: sid = perm[row], so a miss gives
    perm[0]."""
    perm = perm.to(device=rows_ext.device, dtype=torch.int64)
    runs = box_runs(rows_ext, counts, gate_boxes)

    def closest_hit(o, d):
        t, row = brute_hit(rows_ext, counts, o.contiguous(), d.contiguous(),
                           cfg.use_mt, gate_boxes, runs)
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
