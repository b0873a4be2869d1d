"""Kernel 4 of the port (``closest_hit_attrs``: the closest hit with the
shading attributes of the winning shape; its plain version on the CPU)
against the JAX package's ``make_closest_hit(...).with_attrs`` (the Pallas
kernel ``_split_kernel_attrs`` in interpret mode), and the
``USE_KERNEL_ATTRS`` route of ``render()`` against the JAX package's."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.accel.linearize import shape_leaf_boxes
from raytracer_tpu.config import RenderConfig as JaxConfig
from raytracer_tpu.geom import batched
from raytracer_tpu.render import pallas_split, split_scene
from raytracer_tpu.render.reference import render as render_ref
from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.render import split as split_mod
from raytracer_tpu_torch.render import wholeframe
from raytracer_tpu_torch.render.split import (closest_hit_attrs_plain,
                                              make_closest_hit, render)

from torch_port_common import (held, held_lazily, interpret_unroll,
                               op_by_op, port, ported, query_rays,
                               small_scene, typed_scene)

JAX_KERNEL_CFG = JaxConfig(width=24, height=18, tile_h=8, tile_w=128)
# The sphere normal: the port divides by a correctly rounded root, the JAX
# kernel multiplies by lax.rsqrt (as tests/test_torch_bounce.py).
NORMAL_ATOL = 2.5e-7


@functools.lru_cache(maxsize=None)
def _scenes():
    """name -> (JAX flat, reference tree, SplitScene, camera; the port's
    objects)."""
    (flat, lin, split, cam, light), p = small_scene()
    (tflat, tlin, tcam), _ = typed_scene()
    tsplit = split_scene.prepare(tflat, tlin)
    return {"small": (flat, lin, split, cam, p),
            "typed": (tflat, tlin, tsplit, tcam,
                      port(tflat, tsplit, tcam, light))}


@pytest.mark.parametrize("name", ["small", "typed"])
def test_closest_attrs_matches_jax(name):
    """hit and sid equal; t held at the closest-hit bar (rtol 1e-5, see
    ``held``); the 8 material columns equal and the normals within
    NORMAL_ATOL on hits; every attribute 0 on misses, in both."""
    flat, lin, split, cam, p = _scenes()[name]

    class _Sc:   # query_rays reads the camera only
        camera = cam

    o, d = query_rays(_Sc, n=512, seed=5)
    with interpret_unroll():
        t, sid, hit, a = pallas_split.make_closest_hit(
            split, JAX_KERNEL_CFG).with_attrs(jnp.asarray(o), jnp.asarray(d))
    t, sid, hit = (np.asarray(x) for x in (t, sid, hit))
    want = np.concatenate([np.asarray(a["normal"]), np.asarray(a["color"]),
                           np.stack([np.asarray(a[k]) for k in (
                               "ambient", "diffuse", "specular", "fresnel",
                               "shininess")], 1)], 1)
    pt, psid, phit, pa = make_closest_hit(p.split, RenderConfig()) \
        .with_attrs(torch.from_numpy(o), torch.from_numpy(d))
    got = torch.cat([pa[0], pa[1], torch.stack(pa[2:], 1)], 1).numpy()
    pt, psid, phit = pt.numpy(), psid.numpy(), phit.numpy()
    assert hit.sum() >= 100 and (~hit).sum() >= 100
    np.testing.assert_array_equal(phit, hit)
    np.testing.assert_array_equal(psid, sid)
    t_op, _, _ = op_by_op(batched.closest_hit, batched.precompute(flat),
                          jnp.asarray(o), jnp.asarray(d), False,
                          shape_leaf_boxes(lin, flat.num_shapes))
    beyond, _ = held(pt[hit], t[hit], t_op[hit], atol=0, rtol=1e-5)
    assert not beyond.any(), np.nonzero(beyond)
    # a sphere's normal comes from its hit point, so it is held like t:
    # against the normal at the op-by-op t where XLA's FMAs moved t
    n_op = want[:, :3].copy()
    sph = hit & (np.asarray(flat.shape_type)[sid] == 0)
    rel = (o[sph] + t_op[sph, None] * d[sph]
           - np.asarray(flat.sphere_center)[sid[sph]])
    n_op[sph] = rel * (np.float32(1.0) / np.sqrt(
        rel[:, 0] * rel[:, 0] + rel[:, 1] * rel[:, 1]
        + rel[:, 2] * rel[:, 2] + np.float32(1e-30)))[:, None]
    assert sph.sum() >= 10
    beyond, _ = held(got[hit, :3], want[hit, :3], n_op[hit],
                     atol=NORMAL_ATOL)
    assert not beyond.any(), np.nonzero(beyond)
    np.testing.assert_array_equal(got[hit, 3:], want[hit, 3:])
    assert not got[~hit].any() and not want[~hit].any()
    # the plain version's raw outputs: gid -1 and t INF on a miss
    t_raw, gid_raw, a_raw = closest_hit_attrs_plain(
        p.split, torch.from_numpy(o), torch.from_numpy(d),
        RenderConfig().tri_mode)
    assert a_raw.shape == (11, o.shape[0])
    assert (gid_raw.numpy()[~hit] == -1).all()
    assert (t_raw.numpy()[~hit] == 1e30).all()


def test_kernel_attrs_frame_matches_jax(monkeypatch):
    """The port's USE_KERNEL_ATTRS frame of the small scene against the
    JAX package's at 24x18x2 (its kernel in interpret mode): every pixel
    within atol 1e-4 but at most 2 (the Gram test's edge flips), held
    against the op-by-op JAX oracle where XLA's FMAs moved a pixel
    (``held_lazily``). ``_render_impl`` is jitted on ``cfg`` only, so its
    cache is cleared around the flipped JAX switch."""
    (flat, lin, split, cam, light), p = small_scene()
    jcfg = JAX_KERNEL_CFG.replace(max_bounces=2)
    monkeypatch.setattr(pallas_split, "USE_KERNEL_ATTRS", True)
    with interpret_unroll():
        jitted = np.asarray(pallas_split.render(flat, lin, cam, light, jcfg,
                                                split=split))
    monkeypatch.setattr(split_mod, "USE_KERNEL_ATTRS", True)
    img = render(p.flat, None, p.camera, p.light,
                 RenderConfig(width=24, height=18, max_bounces=2),
                 split=p.split, device="cpu").numpy()
    assert img.shape == (18, 24, 3) and np.isfinite(img).all()
    ocfg = JaxConfig(width=24, height=18, max_bounces=2, ray_chunk=24 * 18)
    assert held_lazily(img, jitted, lambda: op_by_op(
        render_ref, flat, cam, light, ocfg,
        leaf_boxes=shape_leaf_boxes(lin, flat.num_shapes)), 1e-4, axis=-1,
        allowed=2) <= 2


def _port_attrs_frame(monkeypatch, which, cfg):
    monkeypatch.setattr(split_mod, "USE_KERNEL_ATTRS", True)
    p = ported(which)
    return render(p.flat, None, p.camera, p.light, cfg, split=p.split,
                  device="cpu").numpy()


@pytest.mark.parametrize("variant", [
    {}, {"use_fresnel": True}, {"enable_shadows": False},
    {"use_gram_tri": False}, {"use_mt": True}])
@pytest.mark.parametrize("which", [1, 2])
def test_kernel_attrs_route(monkeypatch, which, variant):
    """The USE_KERNEL_ATTRS route launches no fused and no resolve kernel,
    the attribute kernel once a bounce and kernel 2 once a bounce for the
    shadow rays (none without shadows); its frame equals the per-bounce
    route's (fused + resolve), since both shade the same hits with the
    same formulas."""
    calls = []
    for name in ("closest_hit_plain", "fused_plain", "resolve_plain",
                 "closest_hit_attrs_plain"):
        fn = getattr(split_mod, name)
        monkeypatch.setattr(split_mod, name, functools.partial(
            lambda fn, name, *a, **k: calls.append(name) or fn(*a, **k),
            fn, name))
    cfg = RenderConfig(width=24, height=18, max_bounces=3).replace(**variant)
    img = _port_attrs_frame(monkeypatch, which, cfg)
    b = cfg.max_bounces
    assert calls.count("closest_hit_attrs_plain") == b
    assert calls.count("closest_hit_plain") == (b if cfg.enable_shadows
                                                else 0)
    assert len(calls) == b + calls.count("closest_hit_plain")
    monkeypatch.setattr(split_mod, "USE_KERNEL_ATTRS", False)
    monkeypatch.setattr(wholeframe, "USE_WHOLEFRAME", False)
    p = ported(which)
    ref = render(p.flat, None, p.camera, p.light, cfg, split=p.split,
                 device="cpu").numpy()
    assert np.isfinite(img).all()
    np.testing.assert_allclose(img, ref, rtol=0, atol=1e-6)
