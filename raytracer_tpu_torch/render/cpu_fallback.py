"""Parity port of the reference's slow CPU renderer (port of
``raytracer_tpu/render/cpu_fallback.py``).

Reference: cpuRayTracer (src/main.cpp:848-894) + the CPU phong
(main.cpp:553-581). Semantics differ from the GPU kernel on purpose:
single primary bounce, NO shadows, NO reflections, NO light attenuation,
black (not gradient) background. Kept because the reference exposes it as
a user-facing mode (the ImGui ``rtxon`` toggle, main.cpp:377) and as a
second cross-check implementation. (The name is the reference's: it runs
on the device it is given.)
"""

from __future__ import annotations

import torch

from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.core.camera import camera_rays
from raytracer_tpu_torch.core.scene import FlatScene
from raytracer_tpu_torch.core.types import Camera, Light
from raytracer_tpu_torch.device import resolve_device
from raytracer_tpu_torch.geom import batched
from raytracer_tpu_torch.render import shading, whitted


def render(scene: FlatScene, camera: Camera, light: Light,
           cfg: RenderConfig, device=None) -> torch.Tensor:
    """Single-bounce unshadowed Phong, black background. (H, W, 3).
    ``device`` None means "cuda"."""
    dev = resolve_device(device)
    scene, camera, light = scene.to(dev), camera.to(dev), light.to(dev)
    h, w = cfg.height, cfg.width
    o, d = camera_rays(camera, w, h)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    cache = batched.precompute(scene)
    n_rays = o.shape[0]
    chunk = min(cfg.ray_chunk, n_rays)
    o, d = whitted.pad_rays(chunk, o, d)

    def body(o_, d_):
        t, sid, hit = batched.closest_hit(cache, o_, d_, cfg.use_mt)
        p = o_ + t[:, None] * d_
        n = batched.shape_normal(scene, sid, p)
        sid = sid.long()
        color = shading.phong(
            p, n, d_, light.position, light.color,
            scene.mat_color.index_select(0, sid),
            scene.mat_ambient.index_select(0, sid),
            scene.mat_diffuse.index_select(0, sid),
            scene.mat_specular.index_select(0, sid),
            scene.mat_shininess.index_select(0, sid),
            attenuate=False)  # CPU phong has no 1/d attenuation
        return torch.where(hit[:, None], color, 0.0)

    colors = [body(o[c:c + chunk], d[c:c + chunk])
              for c in range(0, o.shape[0], chunk)]
    return torch.cat(colors)[:n_rays].reshape(h, w, 3)
