"""The port's per-bounce route (``whitted.trace`` with the fused
closest+shadow query and the attribute resolve; plain versions on the
CPU): ``fused_shadow`` against the JAX package's fused Pallas kernel in
interpret mode on a small scene, ``make_attr_resolver`` against the JAX
resolver's formula (pallas_split.py:1020-1030) in plain jnp, and the
per-bounce ``render()`` against the JAX oracle ``reference.render`` with
the reference tree's leaf boxes on scenes 1 and 2."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.accel.linearize import shape_leaf_boxes
from raytracer_tpu.config import RenderConfig as JaxConfig
from raytracer_tpu.geom import batched
from raytracer_tpu.render import pallas_split
from raytracer_tpu.render import whitted as jax_whitted
from raytracer_tpu.render.reference import render as render_ref
from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.render import whitted, wholeframe
from raytracer_tpu_torch.render.split import (make_attr_resolver,
                                              make_closest_hit, render)

from torch_port_common import (held, interpret_unroll, jax_scene, op_by_op,
                               ported, small_scene)

JAX_KERNEL_CFG = JaxConfig(width=24, height=18, tile_h=8, tile_w=128)
# The sphere normal: the port divides by a correctly rounded root, the JAX
# kernel multiplies by lax.rsqrt; 1.2e-7 is the largest difference seen on
# these inputs (an ulp of a unit component).
NORMAL_ATOL = 2.5e-7


def _fused_rays():
    """256 seeded rays at the small scene: 128 from the camera toward its
    objects, 96 from random points in random directions (mostly misses),
    32 parked."""
    rng = np.random.default_rng(11)
    target = rng.uniform((-2.5, -1.5, -7.0), (2.5, 1.5, -3.0), (128, 3))
    d_cam = target / np.linalg.norm(target, axis=1, keepdims=True)
    o_rnd = rng.uniform(-4.0, 4.0, (96, 3))
    d_rnd = rng.normal(size=(96, 3))
    d_rnd /= np.linalg.norm(d_rnd, axis=1, keepdims=True)
    o = np.concatenate([np.zeros((128, 3)), o_rnd,
                        np.full((32, 3), whitted.PARK_ORIGIN)])
    d = np.concatenate([d_cam, d_rnd, np.full((32, 3), whitted._PARK_DIR)])
    perm = rng.permutation(256)
    return o[perm].astype(np.float32), d[perm].astype(np.float32)


def test_fused_shadow_matches_jax():
    """gid, hit and in_shadow agree exactly with the JAX fused kernel; t is
    held at the closest-hit bar (rtol 1e-5, see ``held``). Parked rays
    come out as unshadowed misses."""
    (flat, lin, split, _, light), p = small_scene()
    o, d = _fused_rays()
    with interpret_unroll():
        want = pallas_split.make_closest_hit(split, JAX_KERNEL_CFG) \
            .fused_shadow(jnp.asarray(o), jnp.asarray(d), light.position)
    t, sid, hit, shadow = (np.asarray(x) for x in want)
    got = make_closest_hit(p.split, RenderConfig()).fused_shadow(
        torch.from_numpy(o), torch.from_numpy(d), p.light.position)
    pt, psid, phit, pshadow = (x.numpy() for x in got)
    assert hit.sum() >= 64 and shadow.sum() >= 8 and (~hit).sum() >= 64
    np.testing.assert_array_equal(phit, hit)
    np.testing.assert_array_equal(psid, sid)
    np.testing.assert_array_equal(pshadow, shadow)
    parked = o[:, 0] >= 1e30
    assert not phit[parked].any() and not pshadow[parked].any()
    t_op, _, _ = op_by_op(batched.closest_hit, batched.precompute(flat),
                          jnp.asarray(o), jnp.asarray(d), False,
                          shape_leaf_boxes(lin, flat.num_shapes))
    beyond, _ = held(pt[hit], t[hit], t_op[hit], atol=0, rtol=1e-5)
    assert not beyond.any(), np.nonzero(beyond)


def _jax_resolve(attr_tab, gid, p):
    """The JAX resolver's arithmetic (``_resolve_kernel``,
    pallas_split.py:1020-1030), with an XLA row gather in place of the
    kernel's loop over the distinct shape ids."""
    row = jnp.take(attr_tab, jnp.maximum(gid, 0.0).astype(jnp.int32), axis=0)
    is_s = row[:, 14]
    rx, ry, rz = (p[:, k] - row[:, 11 + k] for k in range(3))
    inv = jax.lax.rsqrt(rx * rx + ry * ry + rz * rz + 1e-30)
    n = jnp.stack([is_s * (r * inv) + (1.0 - is_s) * row[:, k]
                   for k, r in enumerate((rx, ry, rz))], -1)
    return (n, row[:, 3:6], row[:, 6], row[:, 7], row[:, 8], row[:, 9],
            row[:, 10])


def test_attr_resolver_matches_jax():
    """Material columns equal; normals within NORMAL_ATOL (IEEE 1/sqrt
    against lax.rsqrt). gid -1 resolves as row 0."""
    (flat, _, _, _, _), p = small_scene()
    rng = np.random.default_rng(12)
    gid = rng.choice([-1, 0, 1, 2, 3], 256).astype(np.float32)
    pts = rng.uniform(-3.0, 3.0, (256, 3)).astype(np.float32)
    want = _jax_resolve(jax_whitted._attr_table(flat), jnp.asarray(gid),
                        jnp.asarray(pts))
    got = make_attr_resolver(RenderConfig())(
        p.attr_tab, torch.from_numpy(gid), torch.from_numpy(pts))
    want = [np.asarray(x) for x in want]
    got = [x.numpy() for x in got]
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=NORMAL_ATOL)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)
    is_sph = p.attr_tab[np.maximum(gid, 0).astype(np.int64), 14].numpy() > 0
    assert 0 < is_sph.sum() < 256
    np.testing.assert_allclose(np.linalg.norm(got[0][is_sph], axis=1), 1.0,
                               atol=1e-6)


@functools.lru_cache(maxsize=None)
def _reference(which, max_bounces, enable_shadows):
    """The JAX oracle at 24x18 (jitted, and one operation at a time)."""
    sc, lin, _ = jax_scene(which)
    lb = shape_leaf_boxes(lin, sc.num_shapes)
    cfg = JaxConfig(width=24, height=18, max_bounces=max_bounces,
                    enable_shadows=enable_shadows, ray_chunk=24 * 18)
    jitted = np.asarray(render_ref(sc.flat, sc.camera, sc.light, cfg,
                                   leaf_boxes=lb))
    opbyop = op_by_op(render_ref, sc.flat, sc.camera, sc.light, cfg,
                      leaf_boxes=lb)
    return jitted, opbyop


# route: (config changes, wholeframe flags)
ROUTES = {
    "per-bounce": ({}, {"USE_WHOLEFRAME": False}),
    "per-bounce-sorted": ({"sort_bounces": True}, {"USE_WHOLEFRAME": False}),
    "sorted-1-bounce": ({"sort_bounces": True, "max_bounces": 1}, {}),
    # the closest-hit launch in place of the fused one
    "per-bounce-unshadowed": ({"enable_shadows": False},
                              {"USE_WHOLEFRAME": False}),
}


@pytest.mark.parametrize("which", [1, 2])
@pytest.mark.parametrize("route", list(ROUTES))
def test_per_bounce_render_matches_oracle(monkeypatch, which, route):
    """At 24x18 (3 bounces, or 1), every pixel within atol 1e-4 but at
    most 2 (the Gram test's edge flips, as in tests/test_torch_render.py).
    The sorted variants re-associate only, so they are held against the
    unsorted oracle."""
    kw, wf_flags = ROUTES[route]
    for name, value in wf_flags.items():
        monkeypatch.setattr(wholeframe, name, value)
    cfg = RenderConfig(width=24, height=18, max_bounces=3).replace(**kw)
    p = ported(which)
    img = render(p.flat, None, p.camera, p.light, cfg, split=p.split,
                 device="cpu").numpy()
    jitted, opbyop = _reference(which, cfg.max_bounces, cfg.enable_shadows)
    assert img.shape == (18, 24, 3) and np.isfinite(img).all()
    beyond, _ = held(img, jitted, opbyop, atol=1e-4, axis=-1)
    assert beyond.sum() <= 2, f"{beyond.sum()} pixels beyond 1e-4"
