"""Gradients of the port's differentiable route (``render(differentiable=
True, device="cpu")``: kernel 2's plain version decides the hits, t is
re-derived in autograd) against the JAX package's kernel path
(``pallas_split.render(..., differentiable=True)``, its Pallas kernel in
interpret mode) on tests/test_grad.py's scenes at 24x18 with 2 bounces.

One ``jax.grad`` per scene over a dict of every field checked (the
kernel-path grads cost tens of seconds each to trace on the CPU); each
field is a case of its own. The bar is tests/test_grad.py's: rtol 1e-3,
atol 1e-5, and every gradient finite."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.accel import build_bvh, linearize
from raytracer_tpu.config import RenderConfig as JaxConfig
from raytracer_tpu.core.types import Camera as JaxCamera
from raytracer_tpu.core.types import Light as JaxLight
from raytracer_tpu.render import pallas_split
from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.core.types import Camera, Light
from raytracer_tpu_torch.render import split as split_mod
from raytracer_tpu_torch.render.split import render

from test_grad import _scene, _tri_scene
from torch_port_common import interpret_unroll, port

JAX_CFG = JaxConfig(width=24, height=18, max_bounces=2, use_bvh=True,
                    ray_chunk=432, tile_h=8, tile_w=128)
CFG = RenderConfig(width=24, height=18, max_bounces=2, use_bvh=True)

# scene: (its function in test_grad.py, the fields checked, whether the
# triangle planes are recomputed from the vertices)
SCENES = {
    "spheres": (_scene, ("mat_color", "sphere_center", "sphere_radius",
                         "light_position", "camera_position"), False),
    "triangle": (_tri_scene, ("tri_p1", "tri_p2", "tri_p3"), True),
}
CASES = [(name, f) for name, (_, fields, _) in SCENES.items()
         for f in fields]


def _make(scene, cam, light, params, planes, light_cls, camera_cls,
          **cam_kw):
    """The scene, camera and light with ``params`` in place."""
    s = scene.replace(**{k: v for k, v in params.items()
                         if k not in ("light_position", "camera_position")})
    if planes:
        s = s.recompute_tri_planes()
    lt = light_cls(params.get("light_position", light.position),
                   light.base_color, light.intensity)
    cm = camera_cls(params.get("camera_position", cam.position), cam.front,
                    cam.up, cam.right, cam.fov_deg, cam.aspect, **cam_kw)
    return s, cm, lt


def _values(scene, cam, light, fields):
    """The JAX values of ``fields``."""
    return {f: light.position if f == "light_position" else
            cam.position if f == "camera_position" else getattr(scene, f)
            for f in fields}


@functools.lru_cache(maxsize=None)
def _grads(name):
    """(JAX gradients, port gradients) of the summed image over every
    field of scene ``name``."""
    build, fields, planes = SCENES[name]
    scene, cam, light = build()
    bvh = linearize(build_bvh(scene, 4))
    split = pallas_split.prepare(scene, bvh)

    def loss_jax(params):
        s, cm, lt = _make(scene, cam, light, params, planes, JaxLight,
                          JaxCamera)
        return jnp.sum(pallas_split.render(s, bvh, cm, lt, JAX_CFG,
                                           split=split,
                                           differentiable=True))

    with interpret_unroll():
        want = jax.grad(loss_jax)(_values(scene, cam, light, fields))
    p = port(scene, split, cam, light)
    params = {f: torch.from_numpy(np.array(v)).requires_grad_(True)
              for f, v in _values(scene, cam, light, fields).items()}
    s, cm, lt = _make(p.flat, p.camera, p.light, params, planes, Light,
                      Camera, half_h=p.camera.half_h)
    img = render(s, None, cm, lt, CFG, split=p.split, differentiable=True,
                 device="cpu")
    got = torch.autograd.grad(img.sum(), list(params.values()))
    return ({f: np.asarray(v) for f, v in want.items()},
            dict(zip(params, (g.numpy() for g in got))))


@pytest.mark.parametrize("name,field", CASES)
def test_kernel_path_grads_match_jax(name, field):
    want, got = _grads(name)
    g = got[field]
    assert np.isfinite(g).all()
    np.testing.assert_allclose(g, want[field], rtol=1e-3, atol=1e-5)


def test_grads_carry_signal():
    """The checked gradients are not all zero: the light, the sphere
    materials and the triangle row move the image."""
    want, got = _grads("spheres")
    assert np.abs(got["light_position"]).max() > 0
    assert np.abs(got["mat_color"][:2]).max() > 0
    _, got = _grads("triangle")
    assert np.abs(got["tri_p1"][2]).max() > 0


def test_differentiable_route_launches_kernel_2(monkeypatch):
    """The route of pallas_split.py:1206-1209: the differentiable closest
    hit for every query (kernel 2's plain version here), no fused, no
    resolve and no attribute kernel, and the image equals the plain
    per-bounce frame's."""
    calls = []
    for name in ("closest_hit_plain", "fused_plain", "resolve_plain",
                 "closest_hit_attrs_plain"):
        fn = getattr(split_mod, name)
        monkeypatch.setattr(split_mod, name, functools.partial(
            lambda fn, name, *a, **k: calls.append(name) or fn(*a, **k),
            fn, name))
    scene, cam, light = _scene()
    bvh = linearize(build_bvh(scene, 4))
    p = port(scene, pallas_split.prepare(scene, bvh), cam, light)
    img = render(p.flat, None, p.camera, p.light, CFG, split=p.split,
                 differentiable=True, device="cpu")
    assert calls == ["closest_hit_plain"] * (2 * CFG.max_bounces)
    from raytracer_tpu_torch.render import wholeframe
    monkeypatch.setattr(wholeframe, "USE_WHOLEFRAME", False)
    ref = render(p.flat, None, p.camera, p.light, CFG, split=p.split,
                 device="cpu")
    np.testing.assert_allclose(img.detach().numpy(), ref.numpy(), rtol=0,
                               atol=1e-6)
