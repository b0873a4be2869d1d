"""The animated frame loop (port of ``raytracer_tpu/render/dynamic.py``):
animate -> refresh or rebuild -> render, one call per frame.

The reference animates by mutating its shapes, re-serializing the changed
ones (updateScene, src/main.cpp:981-992) and grow-refitting the BVH
(updateBVH, main.cpp:1068-1077) on the CPU every frame. Here every step
is tensor code on the card: the bounce and wheel transforms (anim/), then
either the split tables' refresh (``update_pre_rows`` / ``update_dynamic``,
for the production split route) or per-shape AABBs and centers and a full
LBVH rebuild (accel/lbvh.py), then the renderer. Up to the render, a frame
copies nothing to the host, so it never waits for the card there.
"""

from __future__ import annotations

from typing import Callable

from raytracer_tpu_torch.accel import build_bvh, linearize
from raytracer_tpu_torch.accel.lbvh import (build_lbvh,
                                            node_cullable_flags_device)
from raytracer_tpu_torch.anim.animation import (bounce_spheres,
                                                device_bounce,
                                                device_wheels, rotate_wheels)
from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.core.scene import WALL
from raytracer_tpu_torch.device import resolve_device
from raytracer_tpu_torch.geom.aabb import (shape_aabbs_device,
                                           shape_centers_device)
from raytracer_tpu_torch.geom.direct import wall_basis
from raytracer_tpu_torch.render import packet, split, split_scene, wavefront

RENDERERS = ("split", "pallas", "wavefront")


def make_frame_fn(scene_meta, cfg: RenderConfig, renderer: str = "wavefront",
                  device=None) -> Callable:
    """frame(flat, camera, light, elapsed_t, delta_t) -> (image, flat'):
    one animated frame on ``device`` (None means "cuda"; "cpu" runs the
    plain versions).

    ``scene_meta``: a scenes.Scene (its flat, bvh_max_depth, bounce_params
    and wheels). ``renderer``:
    - "split", the production route: ``prepare`` once from the reference
      median tree; each frame refreshes the pre-pass rows (bounce only) or
      both row tables with the triangle tree refit (wheels) and renders
      with ``split._render_impl`` (the one-launch frame, or the hybrid
      with ``cfg.sort_bounces``);
    - "pallas": an LBVH rebuilt each frame, its cull flags, and the
      packet renderer (packet_kernel; occlusion_kernel with
      ``packet.USE_OCCLUSION``);
    - "wavefront": the same LBVH through the tensor-op oracle.

    ``frame.update(flat, elapsed_t, delta_t)`` runs the steps before the
    render and returns (flat', tables): the refreshed SplitScene, or the
    LBVH with its cull flags (None for "wavefront")."""
    if renderer not in RENDERERS:
        raise ValueError(f"renderer {renderer!r}: one of {RENDERERS}")
    dev = resolve_device(device)
    # the animation's parameters go to the card once, not per frame
    bounce = (device_bounce(scene_meta.bounce_params, dev)
              if scene_meta.bounce_params else None)
    wheels = device_wheels(scene_meta.wheels, dev)

    def animate(flat, elapsed_t, delta_t):
        flat = flat.to(dev)
        if bounce is not None:
            flat = bounce_spheres(flat, bounce, elapsed_t)
        if wheels:
            flat = rotate_wheels(flat, wheels, delta_t)
        return flat

    if renderer == "split":
        ref_lin = linearize(build_bvh(scene_meta.flat,
                                      scene_meta.bvh_max_depth))
        split0 = split_scene.prepare(scene_meta.flat, ref_lin, device=dev)
        # triangles move with the wheels: both tables, with the refit
        refresh = (split_scene.update_dynamic if wheels
                   else split_scene.update_pre_rows)

        def update(flat, elapsed_t, delta_t):
            flat = animate(flat, elapsed_t, delta_t)
            return flat, refresh(split0, flat)

        def draw(flat, tables, camera, light):
            return split._render_impl(flat, tables, camera, light, cfg)
    else:
        def update(flat, elapsed_t, delta_t):
            flat = animate(flat, elapsed_t, delta_t)
            mins, maxs = shape_aabbs_device(flat)
            lin = build_lbvh(mins, maxs, shape_centers_device(flat))
            if renderer == "wavefront":
                return flat, (lin, None)
            _, _, w_deg = wall_basis(flat.plane_normal)
            return flat, (lin, node_cullable_flags_device(
                lin, w_deg & (flat.shape_type == WALL)))

        def draw(flat, tables, camera, light):
            lin, flags = tables
            if renderer == "pallas":
                return packet._render_impl(flat, lin, flags, camera, light,
                                           cfg, True)
            return wavefront.render(flat, lin, camera, light, cfg,
                                    device=dev)

    def frame(flat, camera, light, elapsed_t, delta_t):
        flat, tables = update(flat, elapsed_t, delta_t)
        return draw(flat, tables, camera.to(dev), light.to(dev)), flat

    frame.update = update
    return frame
