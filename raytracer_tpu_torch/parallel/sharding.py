"""Multi-device scale-out: the image plane sharded over a mesh of devices
(port of ``raytracer_tpu/parallel/sharding.py``).

Rays are independent, so a frame is cut into shards, one per device of
the mesh, and the scene, the split tables, the camera and the light are
copied once to each distinct device of the mesh. A mesh is an ordered
tuple of ``torch.device``s (``make_mesh``): the first n visible cards, or
n copies of one device, virtual shards (the JAX package's tests shard over
8 virtual CPU devices).

Where the JAX package traces one program per device with ``shard_map``,
the port issues the shards in turn from the host, each under its device's
guard (``render/kernels.device_guard``). Every shard is issued before any
result is gathered, and nothing between two shards waits for a card, so
the cards of a mesh run their shards at the same time. The gather is a
``torch.cat`` on the mesh's first device. Scene tensors reach a shard
through ``Tensor.to``, which autograd differentiates: the gradient of a
scene parameter is the sum of its shards' gradients, the port's
counterpart of the psum that the transpose of ``shard_map`` inserts.

The routes:

- ``trace_sharded`` / ``render_sharded``: ray shards through the
  brute-force oracle (``render/reference.trace_chunked``, with
  ``leaf_boxes`` for the tree's visibility) or, given ``bvh``, the
  wavefront walk;
- ``trace_sharded_split``: ray shards through the per-bounce route
  (``split.trace_rays``: fused_kernel and resolve_kernel, or the
  differentiable closest hit of ``diff/kernel_vjp``);
- ``trace_sharded_strips``: strips of ceil(H / n) whole image rows, each
  shard the single-device whole-frame route (``wholeframe._render_blocks``:
  one launch of wholeframe_kernel, or the sorted-continuation hybrid) on
  its window of rows;
- ``render_sharded_split`` takes the strips wherever ``split.render``
  takes the whole-frame route, else the per-bounce ray shards.

A pixel's colour does not depend on the shard that traced it (the kernels
trace each lane alone, and the hybrid's colour is acc1 + at1 * rel pixel by
pixel), so a strip frame equals the single-device frame bit for bit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.device import resolve_device
from raytracer_tpu_torch.geom import rowwise
from raytracer_tpu_torch.render import kernels, wavefront, whitted, wholeframe
from raytracer_tpu_torch.render import split as split_mod
from raytracer_tpu_torch.render.reference import trace_chunked
from raytracer_tpu_torch.render.split import \
    wholeframe_route_ok as _wholeframe_route_ok

Mesh = Tuple[torch.device, ...]

# Ray shards are cut at multiples of this many rays: an (R, 3) f32 shard
# of 4k rays starts on a 16-byte boundary, as the kernels require.
RAY_ALIGN = 4


def make_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """The mesh: an ordered tuple of devices. Without ``device``, the
    first ``n_devices`` visible cards (all of them by default); raises if
    there is no card or fewer than ``n_devices``. With ``device``
    (``"cpu"``, ``"cuda:0"``), ``n_devices`` (default 1) copies of that
    device: virtual shards, each traced in turn on that device."""
    if device is not None:
        n = 1 if n_devices is None else n_devices
        if n < 1:
            raise ValueError(f"make_mesh: n_devices={n_devices}")
        return (resolve_device(device),) * n
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device is available; pass "
                           "device='cpu' for a mesh of virtual CPU shards")
    count = torch.cuda.device_count()
    n = count if n_devices is None else n_devices
    if not 1 <= n <= count:
        raise ValueError(f"make_mesh: {n_devices} devices asked for, "
                         f"{count} visible")
    return tuple(torch.device("cuda", i) for i in range(n))


def _to(x, dev):
    """``x`` (None, a tensor, a tuple of tensors, or a scene object with
    ``.to``) on ``dev``."""
    if x is None:
        return None
    if isinstance(x, tuple):
        return tuple(v.to(dev) for v in x)
    return x.to(dev)


def _shards(mesh: Mesh, objs, shard) -> torch.Tensor:
    """Copy ``objs`` once to each distinct device of the mesh (all copies
    before any shard, so that no copy waits on a shard's work), then
    issue ``shard(k, *objs on mesh[k])`` for each k under mesh[k]'s
    device guard, and gather the results: torch.cat on mesh[0]."""
    replicas = {}
    for dev in dict.fromkeys(mesh):
        with kernels.device_guard(dev):
            replicas[dev] = [_to(x, dev) for x in objs]
    outs = []
    for k, dev in enumerate(mesh):
        with kernels.device_guard(dev):
            outs.append(shard(k, *replicas[dev]))
    return torch.cat([x.to(mesh[0]) for x in outs])


def _ray_slices(mesh: Mesh, *rays):
    """A function of k: shard k of each of ``rays`` (R rows, R a multiple
    of RAY_ALIGN * len(mesh)) on mesh[k]."""
    n = len(mesh)
    r = rays[0].shape[0]
    if r % (RAY_ALIGN * n):
        raise ValueError(f"{r} rays do not divide into {n} shards of a "
                         f"multiple of {RAY_ALIGN} (callers pad)")
    size = r // n
    return lambda k: [x[k * size:(k + 1) * size].to(mesh[k]) for x in rays]


def trace_sharded(scene, light, o, d, bg, cfg: RenderConfig, mesh: Mesh,
                  bvh=None, leaf_boxes=None) -> torch.Tensor:
    """Trace R rays o, d with backgrounds bg (R, 3) sharded over the mesh:
    the wavefront walk over ``bvh`` (a LinearBVH), else the brute-force
    oracle (with ``leaf_boxes``, the reference tree's visibility). R must
    divide into the mesh's shards (callers pad: ``_frame_rays``).
    Returns (R, 3) on mesh[0]."""
    ray_k = _ray_slices(mesh, o, d, bg)

    def shard(k, scene_, light_, lb_):
        o_, d_, bg_ = ray_k(k)
        if bvh is None:
            return trace_chunked(scene_, light_, o_, d_, bg_, cfg, lb_)
        dev = o_.device
        rows_perm = rowwise.pack_rows(scene_)[bvh.perm.to(dev).long()]
        closest = wavefront.make_closest_hit(bvh, rows_perm, bvh.perm,
                                             cfg.use_mt)
        return whitted.trace(scene_, light_, closest, o_, d_, bg_, cfg)

    return _shards(mesh, (scene, light, leaf_boxes), shard)


def trace_sharded_split(scene, split, light, o, d, bg, cfg: RenderConfig,
                        mesh: Mesh, differentiable: bool = False
                        ) -> torch.Tensor:
    """The per-bounce route (``split.trace_rays``) over ray shards: by
    default fused_kernel and resolve_kernel; with ``differentiable``,
    kernel 2 decides the hits and t is re-derived in autograd, so the
    result carries gradients to the scene's and light's tensors, summed
    over the shards. Shapes as ``trace_sharded``."""
    ray_k = _ray_slices(mesh, o, d, bg)

    def shard(k, scene_, split_, light_):
        return split_mod.trace_rays(scene_, split_, light_, *ray_k(k), cfg,
                                    differentiable=differentiable)

    return _shards(mesh, (scene, split, light), shard)


def trace_sharded_strips(scene, split, camera, light, cfg: RenderConfig,
                         mesh: Mesh) -> torch.Tensor:
    """The whole-frame route over the mesh: the image cut into strips of
    ceil(H / n) whole rows, strip k from image row k * ceil(H / n), each
    shard running the single-device route (``wholeframe._render_blocks``:
    the one-launch frame, or the hybrid with ``cfg.sort_bounces``) on its
    window; the strip's row offset rides slot 20 of the kernel's
    parameter row, so each shard traces its strip's own primary rays and
    backgrounds. The last strip may reach past the image; the frame is
    cropped to (H, W, 3) on mesh[0]."""
    rows = -(-cfg.height // len(mesh))

    def shard(k, scene_, split_, camera_, light_):
        return wholeframe._render_blocks(scene_, split_, camera_, light_,
                                         cfg, rows=rows, y_off=k * rows)

    out = _shards(mesh, (scene, split, camera, light), shard)
    return out[:cfg.height]


def _frame_rays(camera, cfg: RenderConfig, n_dev: int):
    """The frame's flattened (o, d, bg) on the camera's device, padded to
    whole shards of n_dev (o and bg with 0, d with 1.0), and the count
    of the frame's rays."""
    o, d, bg = split_mod.primary_rays(camera, cfg)
    n_rays = o.shape[0]
    return (*whitted.pad_rays(RAY_ALIGN * n_dev, o, d, bg), n_rays)


def render_sharded(scene, camera, light, cfg: RenderConfig, mesh: Mesh,
                   bvh=None, leaf_boxes=None) -> torch.Tensor:
    """Full-frame render with pixels sharded over the mesh (the oracle,
    or the wavefront walk over ``bvh``): (H, W, 3) on mesh[0]."""
    o, d, bg, n_rays = _frame_rays(camera.to(mesh[0]), cfg, len(mesh))
    colors = trace_sharded(scene, light, o, d, bg, cfg, mesh, bvh,
                           leaf_boxes)
    return colors[:n_rays].reshape(cfg.height, cfg.width, 3)


def render_sharded_split(scene, split, camera, light, cfg: RenderConfig,
                         mesh: Mesh, differentiable: bool = False
                         ) -> torch.Tensor:
    """Full-frame production render sharded over the mesh: (H, W, 3) on
    mesh[0]. Routed as ``split.render`` routes: where it takes the
    whole-frame route (the one-launch frame, or the hybrid), the frame is
    strip-sharded (``trace_sharded_strips``); otherwise (``differentiable``,
    ``USE_KERNEL_ATTRS``, ``wholeframe.USE_WHOLEFRAME`` off, or the hybrid
    at 1 bounce) the primary rays go through the per-bounce route in ray
    shards (``trace_sharded_split``)."""
    if _wholeframe_route_ok(cfg, differentiable):
        return trace_sharded_strips(scene, split, camera, light, cfg, mesh)
    o, d, bg, n_rays = _frame_rays(camera.to(mesh[0]), cfg, len(mesh))
    colors = trace_sharded_split(scene, split, light, o, d, bg, cfg, mesh,
                                 differentiable=differentiable)
    return colors[:n_rays].reshape(cfg.height, cfg.width, 3)
