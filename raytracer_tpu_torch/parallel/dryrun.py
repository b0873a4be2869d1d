"""The multi-device dry run: one sharded training step and the sharded
production frames against a one-device mesh (port of
``__graft_entry__.py::dryrun_multichip``).

    python -m raytracer_tpu_torch.parallel.dryrun [N] [--device DEV]

runs it over the first N cards (default: all visible), or over N virtual
shards of DEV (``--device cpu``, ``--device cuda:0``).
"""

from __future__ import annotations

import argparse
import math

import torch

from raytracer_tpu_torch.accel import build_bvh, linearize
from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.core import camera as cam_ops
from raytracer_tpu_torch.core.scene import SceneBuilder
from raytracer_tpu_torch.core.types import Light, Material
from raytracer_tpu_torch.parallel.sharding import (make_mesh, render_sharded,
                                                   render_sharded_split)
from raytracer_tpu_torch.render.split_scene import prepare
from raytracer_tpu_torch.scenes import generate_scene1, generate_scene2


def dryrun_multichip(n_devices=None, device=None) -> dict:
    """The full training step over a mesh of ``n_devices`` (``make_mesh``:
    the cards, or virtual shards of ``device``), then the production
    frames under it, in the JAX dry run's order:

    1. one SGD step (lr 0.05) of the sharded oracle render's MSE with
       respect to the sphere centres and the colours (4 shapes, 32x24,
       2 bounces): a finite loss and update;
    2. the loss and centre gradient of the sharded differentiable split
       route: finite and nonzero;
    3. scene 1 at 160x96 x 2 bounces (the one-launch frame in strips) on
       the mesh against a one-device mesh: max-abs <= 1e-6;
    4. scene 2's sort_bounces hybrid at 128x64 x 2 bounces under the mesh
       against the one-device mesh: max-abs <= 1e-6.

    Raises on a failed check; returns the losses and differences."""
    mesh = make_mesh(n_devices, device)
    one = (mesh[0],)
    dev = mesh[0]
    cfg = RenderConfig(width=32, height=24, max_bounces=2, use_bvh=False,
                       ray_chunk=256)

    b = SceneBuilder()
    b.add_sphere((0, 0, -5), 1.0, Material(color=(1, 0, 0)))
    b.add_sphere((2, 1, -7), 0.7, Material(color=(0, 1, 0)))
    b.add_wall((-20, 2, -20), 40, 40, (0, 1, 0))
    b.add_triangle((-2, 0, -4), (-1, 0, -4), (-1.5, -1, -4))
    scene = b.build(device=dev)
    camera = cam_ops.from_euler(position=(0, 0, 0), fov_deg=60,
                                aspect=cfg.width / cfg.height, device=dev)
    light = Light((0, 3, 0), (1, 1, 1), 5.0, device=dev)

    with torch.no_grad():
        target = render_sharded(scene, camera, light, cfg, mesh)

    # -- the oracle's training step ----------------------------------------
    params = {"center": (scene.sphere_center + 0.1).requires_grad_(True),
              "color": scene.mat_color.clone().requires_grad_(True)}
    s = scene.replace(sphere_center=params["center"],
                      mat_color=params["color"])
    val = torch.mean((render_sharded(s, camera, light, cfg, mesh)
                      - target) ** 2)
    grads = torch.autograd.grad(val, list(params.values()))
    with torch.no_grad():
        new = {k: v - 0.05 * g for (k, v), g in zip(params.items(), grads)}
    val = float(val.detach())
    _check(math.isfinite(val), f"oracle loss {val}")
    _check(bool(torch.isfinite(new["center"] - params["center"]).all()),
           "non-finite oracle update")

    # -- the production path: the differentiable split route ---------------
    cfg_p = cfg.replace(use_bvh=True, tile_h=8, tile_w=128)
    bvh = linearize(build_bvh(scene, 8))
    split = prepare(scene, bvh, device=dev)
    center = params["center"].detach().clone().requires_grad_(True)
    img = render_sharded_split(scene.replace(sphere_center=center), split,
                               camera, light, cfg_p, mesh,
                               differentiable=True)
    val_p = torch.mean((img - target) ** 2)
    (g_p,) = torch.autograd.grad(val_p, [center])
    val_p = float(val_p.detach())
    _check(math.isfinite(val_p), f"split-route loss {val_p}")
    _check(bool(torch.isfinite(g_p).all()), "non-finite split-route grad")
    _check(float(g_p.abs().sum()) > 0, "zero split-route grad")

    # -- scene 1 under the mesh against one device -------------------------
    sc1 = generate_scene1(device=dev)
    cfg1 = RenderConfig(width=160, height=96, max_bounces=2, use_bvh=True,
                        tile_h=8, tile_w=128)
    split1 = prepare(sc1.flat, linearize(build_bvh(sc1.flat,
                                                   sc1.bvh_max_depth)),
                     device=dev)
    img_mesh = render_sharded_split(sc1.flat, split1, sc1.camera, sc1.light,
                                    cfg1, mesh)
    img_one = render_sharded_split(sc1.flat, split1, sc1.camera, sc1.light,
                                   cfg1, one)
    _check(bool(torch.isfinite(img_mesh).all()), "non-finite scene-1 frame")
    diff1 = float((img_mesh - img_one).abs().max())
    _check(diff1 <= 1e-6, f"mesh-vs-1dev full-scene divergence: {diff1}")

    # -- scene 2's hybrid under the mesh against one device ----------------
    sc2 = generate_scene2(aspect=128 / 64, device=dev)
    cfg2 = RenderConfig(width=128, height=64, max_bounces=2, use_bvh=True,
                        tile_h=8, tile_w=128, sort_bounces=True)
    split2 = prepare(sc2.flat, linearize(build_bvh(sc2.flat,
                                                   sc2.bvh_max_depth)),
                     device=dev)
    img2_mesh = render_sharded_split(sc2.flat, split2, sc2.camera,
                                     sc2.light, cfg2, mesh)
    img2_one = render_sharded_split(sc2.flat, split2, sc2.camera, sc2.light,
                                    cfg2, one)
    _check(bool(torch.isfinite(img2_mesh).all()),
           "non-finite scene-2 frame")
    diff2 = float((img2_mesh - img2_one).abs().max())
    _check(diff2 <= 1e-6, f"hybrid mesh-vs-1dev divergence: {diff2}")
    out = dict(n_devices=len(mesh), devices=[str(d) for d in mesh],
               oracle_loss=val, split_loss=val_p, scene1_max_abs=diff1,
               scene2_hybrid_max_abs=diff2)
    print(f"dryrun_multichip({len(mesh)}): oracle loss={val:.6f} "
          f"split-kernel loss={val_p:.6f} full-scene mesh-vs-1dev "
          f"max|diff|={diff1:.2e} scene2-hybrid mesh-vs-1dev "
          f"max|diff|={diff2:.2e} ok")
    return out


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_devices", type=int, nargs="?", default=None)
    ap.add_argument("--device", default=None,
                    help="virtual shards of this device (default: the "
                         "visible cards)")
    args = ap.parse_args()
    dryrun_multichip(args.n_devices, args.device)
