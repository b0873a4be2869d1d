"""The brute-force oracle renderer (port of
``raytracer_tpu/render/reference.py``): tensor ops, no acceleration.

The reference's useBVH=false GPU path (gpu_shader.comp:522-620) — the
closest hit by a linear scan over all shapes (``geom/batched.py``) — with
the shared Whitted loop of ``render/whitted.py``. Differentiable end to
end by autograd; every other renderer is held against it.

Rays are traced in chunks of ``cfg.ray_chunk`` (a Python loop where the
JAX function takes ``lax.map``), so peak memory stays at O(ray_chunk *
num_shapes) whatever the resolution: each (R, N) f32 temporary of a
chunk of 8,192 rays over scene 2's 4,122 shapes is 135 MB.
"""

from __future__ import annotations

import torch

from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.core.camera import camera_rays
from raytracer_tpu_torch.core.scene import FlatScene
from raytracer_tpu_torch.core.types import Camera, Light
from raytracer_tpu_torch.device import resolve_device
from raytracer_tpu_torch.geom import batched
from raytracer_tpu_torch.geom.direct import div_rn
from raytracer_tpu_torch.render import shading, whitted


def trace_chunked(scene: FlatScene, light: Light, o, d, bg,
                  cfg: RenderConfig, leaf_boxes=None) -> torch.Tensor:
    """Trace R rays in ray_chunk-sized chunks. o, d, bg: (R, 3)."""
    cache = batched.precompute(scene)

    def closest(o_, d_):
        return batched.closest_hit(cache, o_, d_, cfg.use_mt, leaf_boxes)

    n_rays = o.shape[0]
    chunk = min(cfg.ray_chunk, n_rays)
    o, d, bg = whitted.pad_rays(chunk, o, d, bg)
    colors = [whitted.trace(scene, light, closest, o[c:c + chunk],
                            d[c:c + chunk], bg[c:c + chunk], cfg)
              for c in range(0, o.shape[0], chunk)]
    return torch.cat(colors)[:n_rays]


def render(scene: FlatScene, camera: Camera, light: Light, cfg: RenderConfig,
           leaf_boxes=None, device=None) -> torch.Tensor:
    """Render an (H, W, 3) image — the oracle path.

    One glDispatchCompute frame (src/main.cpp:352-353) with useBVH=false
    semantics for the closest hit. Pass ``leaf_boxes`` (from
    accel.linearize.shape_leaf_boxes) to reproduce useBVH=true visibility
    exactly with the brute-force scan: the oracle of the BVH renderers.
    cfg.use_bvh also selects the reference's shadow offset (1e-3 vs
    1e-5). ``device`` None means "cuda"; "cpu" runs the same tensor ops
    there.
    """
    dev = resolve_device(device)
    scene, camera, light = scene.to(dev), camera.to(dev), light.to(dev)
    if leaf_boxes is not None:
        leaf_boxes = tuple(b.to(dev) for b in leaf_boxes)
    h, w = cfg.height, cfg.width
    o, d = camera_rays(camera, w, h)
    ys = div_rn(torch.arange(h, dtype=torch.float32, device=dev), h)
    bg = torch.broadcast_to(shading.background(ys)[:, None, :], (h, w, 3))
    colors = trace_chunked(scene, light, o.reshape(-1, 3), d.reshape(-1, 3),
                           bg.reshape(-1, 3), cfg, leaf_boxes)
    return colors.reshape(h, w, 3)
