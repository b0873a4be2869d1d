"""The system under test, as the benchmark drives it: the port's public
scene builder, tree, split tables, camera and renderers
(``raytracer_tpu_torch``). Everything the benchmark hands the port goes
through here; nothing here measures.

A traffic mix names its route by data: ``renderer``, a module of
``raytracer_tpu_torch.render`` whose ``render(flat, bvh, camera, light,
cfg, device=...)`` draws the frame (default ``split``, the production
route, whose tables the fits' kernel renderer uses too). Where that
``render`` takes ``split``, the set-up prepares the split tables
(``split_scene.prepare``) and hands them to it."""

from __future__ import annotations

import dataclasses
import importlib
import inspect

import torch

from raytracer_tpu_torch.accel import build_bvh, linearize
from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.core import camera as cam_ops
from raytracer_tpu_torch.core.scene import SceneBuilder
from raytracer_tpu_torch.core.types import Light, Material
from raytracer_tpu_torch.render.split_scene import prepare


@dataclasses.dataclass
class PortScene:
    flat: object          # FlatScene on the card
    bvh: object           # the port's median tree, linearized
    split: object         # SplitScene tables on the card, or None
    light: Light
    cfg: RenderConfig
    renderer: object      # the route's module


def build_flat(items, device):
    """The scene maker's pushes through ``SceneBuilder``."""
    b = SceneBuilder()
    for it in items:
        mat = Material(**it.material)
        g = it.geom
        if it.kind == "sphere":
            b.add_sphere(g["center"], g["radius"], mat, animated=it.animated)
        elif it.kind == "wall":
            b.add_wall(g["start"], g["width"], g["height"], g["normal"], mat,
                       animated=it.animated)
        elif it.kind == "triangle":
            b.add_triangle(g["p1"], g["p2"], g["p3"], mat,
                           invert_normal=bool(g.get("invert_normal")),
                           animated=it.animated)
        else:
            b.add_triangles(g["vertices"], mat,
                            flip_toward_center=g["flip_toward_center"],
                            animated=it.animated)
    return b.build(device)


def render_config(config: dict, traffic: dict) -> RenderConfig:
    r = config["render"]
    return RenderConfig(
        width=int(traffic["width"]), height=int(traffic["height"]),
        max_bounces=int(traffic.get("max_bounces", r["max_bounces"])),
        use_bvh=r["use_bvh"], use_fresnel=r["use_fresnel"],
        use_mt=r["use_mt"], use_gram_tri=r["use_gram_tri"],
        enable_shadows=r["enable_shadows"],
        sort_bounces=bool(traffic.get("sort_bounces", False)))


def build(spec, config: dict, traffic: dict, device) -> PortScene:
    """Scene, tree and the route's tables on ``device`` (the host prep of
    the set-up)."""
    mod = importlib.import_module("raytracer_tpu_torch.render."
                                  + traffic.get("renderer", "split"))
    flat = build_flat(spec.items, device)
    bvh = linearize(build_bvh(flat, spec.bvh_max_depth))
    split = prepare(flat, bvh, device=device) \
        if "split" in inspect.signature(mod.render).parameters else None
    lt = spec.light
    light = Light(lt["position"], lt["color"], lt["intensity"], device=device)
    return PortScene(flat, bvh, split, light, render_config(config, traffic),
                     mod)


def camera(pose: torch.Tensor, consts: dict):
    """A camera from one row of a pose table on the card (x, y, z, yaw,
    pitch) through ``from_euler``; ``consts`` holds fov, aspect and the
    world's up as tensors on the card, so that nothing is copied from the
    host."""
    return cam_ops.from_euler(position=pose[0:3], yaw=pose[3],
                              pitch=pose[4], fov_deg=consts["fov"],
                              aspect=consts["aspect"],
                              world_up=consts["up"])


def camera_consts(fov_deg: float, aspect: float, device) -> dict:
    f32 = dict(dtype=torch.float32, device=device)
    return {"fov": torch.tensor(fov_deg, **f32),
            "aspect": torch.tensor(aspect, **f32),
            "up": torch.tensor([0.0, 1.0, 0.0], **f32)}


def render(ps: PortScene, cam) -> torch.Tensor:
    """One frame of the mix's route."""
    extra = {} if ps.split is None else {"split": ps.split}
    return ps.renderer.render(ps.flat, ps.bvh, cam, ps.light, ps.cfg,
                              device=ps.flat.device, **extra)
