"""The packet-BVH renderer (port of ``raytracer_tpu/render/pallas_bvh.py``):
the closest hit over the reference median ``LinearBVH`` with a per-ray
leaf-box gate and t-culling on the nodes ``node_cullable_flags`` marks,
and the Whitted loop of ``whitted.trace`` around it.

``packet_hit`` wraps the CUDA kernel ``packet_kernel`` and ``occlusion``
wraps ``occlusion_kernel`` (csrc/raytrace.cu), which replace the TPU
kernels ``_packet_kernel`` (with ``_row_intersect``, pallas_bvh.py:169,
:85) and ``_occlusion_kernel`` (:268). On a CPU tensor they run
``packet_plain`` and ``occlusion_plain``: the wavefront walk
(render/wavefront.py::walk) with culling.

Per packet against per thread. The TPU kernel walks one packet of rays
down the tree, descends where ANY lane probes, and in a leaf lets each
lane test the shapes whose leaf box its own ray hits. Each CUDA thread
walks alone and enters only the nodes its own ray probes. A lane's result
is the same: child boxes nest inside their parents, and a shape contained
in its leaf box has t >= the box's tmin, so a subtree culled for
tmin > t_best holds no better hit. Nodes whose subtree holds a degenerate
(infinite-plane) wall, which can hit outside its box, are not culled.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.core.camera import camera_rays
from raytracer_tpu_torch.core.scene import WALL
from raytracer_tpu_torch.device import resolve_device
from raytracer_tpu_torch.geom import rowwise
from raytracer_tpu_torch.geom.direct import INF, div_rn, wall_basis
from raytracer_tpu_torch.render import kernels, shading, whitted
from raytracer_tpu_torch.render.wavefront import Tree, walk

# The JAX package's switch (pallas_bvh.USE_OCCLUSION, off there): shadow
# rays through the any-hit occlusion_kernel instead of a closest-hit walk.
USE_OCCLUSION = False


def node_cullable_flags(lin, scene) -> np.ndarray:
    """(m,) f32: 1.0 where a node's whole DFS subtree is free of
    degenerate-basis walls (safe for t-culling), else 0.0."""
    _, _, w_deg = wall_basis(scene.plane_normal)
    deg = (w_deg & (scene.shape_type == WALL)).cpu().numpy().astype(np.int64)
    perm = lin.perm.numpy()
    starts = lin.leaf_start.numpy().astype(np.int64)
    counts = lin.leaf_count.numpy().astype(np.int64)
    skip = lin.skip.numpy().astype(np.int64)
    # degenerate walls per leaf, then a prefix over DFS order: the subtree
    # of node i is the DFS range [i, skip[i])
    cum = np.concatenate([[0], np.cumsum(deg[perm])])
    leaf_deg = cum[starts + counts] - cum[starts]
    pref = np.concatenate([[0], np.cumsum(leaf_deg)])
    sub = pref[skip] - pref[np.arange(lin.num_nodes)]
    return (sub == 0).astype(np.float32)


def packet_plain(tree: Tree, o: torch.Tensor, d: torch.Tensor, use_mt: bool,
                 t_cull: bool):
    """Plain version of ``packet_kernel``: (t, row int32), the local row
    (DFS-leaf order) of the closest hit, INF and 0 on a miss."""
    return walk(tree, o, d, use_mt, cull=t_cull)


def occlusion_plain(tree: Tree, o: torch.Tensor, d: torch.Tensor,
                    max_t: torch.Tensor, use_mt: bool, t_cull: bool):
    """Plain version of ``occlusion_kernel``: True where some inner hit
    has t < max_t."""
    return walk(tree, o, d, use_mt, cull=t_cull, max_t=max_t)


def _launch(tree: Tree, o, d, max_t, use_mt, t_cull, stats):
    """Check the arguments and launch ``packet_kernel`` (``max_t`` None)
    or ``occlusion_kernel``; returns (t, row) or the occlusion mask."""
    dev = o.device
    n = o.shape[0]
    kernels.check_tensor("o", o, torch.float32, dev, (None, 3))
    kernels.check_tensor("d", d, torch.float32, dev, (n, 3))
    if max_t is not None:
        kernels.check_tensor("max_t", max_t, torch.float32, dev, (n,))
    if stats is not None:
        kernels.check_tensor("stats", stats, torch.int64, dev, (3,))
    m = tree.m
    for name in ("leaf_start", "leaf_count", "skip"):
        kernels.check_tensor(name, getattr(tree, name), torch.int32, dev,
                             (m,))
    kernels.check_tensor("nodes", tree.nodes, torch.float32, dev, (m, 8))
    kernels.check_tensor("rows", tree.rows, torch.float32, dev,
                         (None, rowwise.PACK_WIDTH))
    t = torch.empty(n, dtype=torch.float32, device=dev)
    row = torch.empty(n, dtype=torch.int32, device=dev)
    occ = torch.empty(n, dtype=torch.bool, device=dev)
    if n:
        status = kernels.library().rt_packet(
            tree.leaf_start.data_ptr(), tree.leaf_count.data_ptr(),
            tree.skip.data_ptr(), tree.nodes.data_ptr(), tree.rows.data_ptr(),
            m, o.data_ptr(), d.data_ptr(),
            None if max_t is None else max_t.data_ptr(), n, t.data_ptr(),
            row.data_ptr(), occ.data_ptr(), int(use_mt), int(t_cull),
            None if stats is None else stats.data_ptr(),
            kernels.stream_ptr(dev))
        kernels.check_status("packet_kernel" if max_t is None
                             else "occlusion_kernel", status)
    return (t, row) if max_t is None else occ


def packet_hit(tree: Tree, o: torch.Tensor, d: torch.Tensor, use_mt: bool,
               t_cull: bool, stats: Optional[torch.Tensor] = None):
    """Closest hit of R rays o, d (R, 3) f32 over ``tree``: (t, row int32).
    On a CUDA tensor this launches ``packet_kernel``; on a CPU tensor it
    runs ``packet_plain``. ``stats``, an int64 (3,) tensor on the card,
    receives the counts of non-triangle row tests, node probes and
    triangle row tests."""
    if o.device.type == "cpu":
        return packet_plain(tree, o, d, use_mt, t_cull)
    if o.device.type != "cuda":
        raise ValueError(f"packet_hit: unsupported device {o.device}")
    out = _launch(tree, o, d, None, use_mt, t_cull, stats)
    if o.shape[0]:
        packet_hit.launches += 1
    return out


packet_hit.launches = 0


def occlusion(tree: Tree, o: torch.Tensor, d: torch.Tensor,
              max_t: torch.Tensor, use_mt: bool, t_cull: bool,
              stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """True where ray o, d (R, 3) f32 has an inner hit at t < max_t (R,).
    On a CUDA tensor this launches ``occlusion_kernel``; on a CPU tensor
    it runs ``occlusion_plain``. ``stats`` as for ``packet_hit``."""
    if o.device.type == "cpu":
        return occlusion_plain(tree, o, d, max_t, use_mt, t_cull)
    if o.device.type != "cuda":
        raise ValueError(f"occlusion: unsupported device {o.device}")
    out = _launch(tree, o, d, max_t, use_mt, t_cull, stats)
    if o.shape[0]:
        occlusion.launches += 1
    return out


occlusion.launches = 0


def make_tree(lin, scene, t_cull: bool = True, cull_flags=None) -> Tree:
    """The kernels' tables on the scene's device: the scene's packed rows
    in DFS-leaf order and the nodes, with the cull flags in column 6 when
    ``t_cull``."""
    rows = rowwise.pack_rows(scene)
    if t_cull and cull_flags is None:
        cull_flags = node_cullable_flags(lin, scene)
    rows_perm = rows[lin.perm.to(rows.device).long()]
    return Tree.make(lin, rows_perm, cull_flags if t_cull else None)


def make_closest_hit(lin, scene, cfg: RenderConfig, t_cull: bool = True,
                     cull_flags=None):
    """closest_hit(o, d) -> (t, sid, hit) plus .occlusion(o, d, max_t) ->
    bool, as ``pallas_bvh.make_closest_hit`` (without its ``rows``
    argument, which no caller here passes): o, d (R, 3) f32 on the scene's
    device; sid = perm[min(row, K-1)], so a miss gives perm[0]."""
    tree = make_tree(lin, scene, t_cull, cull_flags)
    perm = lin.perm.to(device=tree.rows.device, dtype=torch.int64)
    k = perm.shape[0]

    def closest_hit(o, d):
        t, row = packet_hit(tree, o.contiguous(), d.contiguous(), cfg.use_mt,
                            t_cull)
        sid = perm[row.long().clamp(0, k - 1)].to(torch.int32)
        return t, sid, t < INF

    def occluded(o, d, max_t):
        return occlusion(tree, o.contiguous(), d.contiguous(),
                         max_t.contiguous(), cfg.use_mt, t_cull)

    closest_hit.occlusion = occluded
    return closest_hit


def _block_shape(tile: int):
    """Largest power-of-two bh with bh <= tile // bh: square-ish blocks."""
    bh = 1
    while bh * 2 * (bh * 2) <= tile:
        bh *= 2
    return bh, tile // bh


def _render_impl(scene, lin, cull_flags, camera, light, cfg: RenderConfig,
                 t_cull: bool) -> torch.Tensor:
    h, w = cfg.height, cfg.width
    o, d = camera_rays(camera, w, h)
    ys = div_rn(torch.arange(h, dtype=torch.float32, device=o.device), h)
    bg = torch.broadcast_to(shading.background(ys)[:, None, :], (h, w, 3))
    closest = make_closest_hit(lin, scene, cfg, t_cull=t_cull,
                               cull_flags=cull_flags)

    # The JAX package's square-block remap (its USE_REMAP default): the
    # rays are traced in blocks of bh x bw pixels (of one tile_h x tile_w
    # tile's size) rather than in row order, so that neighbouring lanes
    # walk similar nodes; padding rays are parked. Per-ray results do not
    # depend on the order, so the image is the same.
    bh, bw = _block_shape(cfg.tile_h * cfg.tile_w)
    hp, wp = -(-h // bh) * bh, -(-w // bw) * bw

    def to_blocks(x, fill):
        padded = x.new_full((hp, wp, 3), fill)
        padded[:h, :w] = x
        x = padded.reshape(hp // bh, bh, wp // bw, bw, 3)
        return x.transpose(1, 2).reshape(-1, 3).contiguous()

    o_b = to_blocks(o, whitted.PARK_ORIGIN)
    d_b = to_blocks(d, whitted._PARK_DIR)
    bg_b = to_blocks(bg, 0.0)
    occl = closest.occlusion if USE_OCCLUSION else None
    colors = whitted.trace(scene, light, closest, o_b, d_b, bg_b, cfg,
                           occlusion_fn=occl)
    colors = colors.reshape(hp // bh, wp // bw, bh, bw, 3).transpose(1, 2)
    return colors.reshape(hp, wp, 3)[:h, :w]


# Cull flags per tree: host work, not to be redone per frame. Keyed by the
# tree's bounds tensor, which the entry keeps alive, so an id is not
# reused while it is cached.
_FLAGS_CACHE: dict = {}


def render(scene, bvh, camera, light, cfg: RenderConfig, t_cull: bool = True,
           device=None) -> torch.Tensor:
    """Render (H, W, 3) f32 with the packet-BVH kernels. ``bvh`` is the
    reference LinearBVH; ``device`` None means "cuda", "cpu" runs the
    plain versions."""
    dev = resolve_device(device)
    flags = None
    if t_cull:
        hit = _FLAGS_CACHE.get(id(bvh.bounds))
        if hit is None or hit[0] is not bvh.bounds:
            if len(_FLAGS_CACHE) > 16:
                _FLAGS_CACHE.clear()
            hit = (bvh.bounds, node_cullable_flags(bvh, scene))
            _FLAGS_CACHE[id(bvh.bounds)] = hit
        flags = hit[1]
    return _render_impl(scene.to(dev), bvh, flags, camera.to(dev),
                        light.to(dev), cfg, t_cull)
