"""The port's brute-force oracle (``geom/batched.py``,
``render/reference.py``), its CPU fallback (``render/cpu_fallback.py``)
and the oracle default of ``diff.make_loss_fn`` against the JAX package
on the same inputs; and the renderers' settings that no other port test
reaches (MT with Fresnel through ``split.render``, ``use_bvh=False``
through ``brute.render`` and ``split.render``, shadows off on the
one-launch frame, 17x11 at 5 bounces), held against the JAX oracle with
the reference tree's leaf boxes. Scenes: ``torch_port_common.typed_scene`` (every shape type) and
``small_scene`` (every shadow interaction) at 24x18.

Bars: the shape id and hit mask exact and t within 1e-5 relative of the
jitted JAX query (XLA's contracted FMAs move t by at most 7e-6 on these
rays); frames 1e-4 per pixel through ``torch_port_common.held_lazily``
(the jitted JAX frame, and the op-by-op one where XLA's FMAs moved it),
the CPU fallback's unattenuated frame also 1e-4 relative; gradients within 1e-4 of the largest component of each
field."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.accel.linearize import shape_leaf_boxes as jax_leaf_boxes
from raytracer_tpu.config import RenderConfig as JaxConfig
from raytracer_tpu.core.scene import SceneBuilder as JaxBuilder
from raytracer_tpu.core.types import Light as JaxLight
from raytracer_tpu.diff import inverse as jax_inverse
from raytracer_tpu.geom import batched as jax_batched
from raytracer_tpu.render import cpu_fallback as jax_cpu
from raytracer_tpu.render import reference as jax_reference
from raytracer_tpu_torch import diff
from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.core.scene import SceneBuilder
from raytracer_tpu_torch.geom import batched
from raytracer_tpu_torch.render import brute, cpu_fallback, reference
from raytracer_tpu_torch.render import split as split_mod
from torch_port_common import (held_lazily, op_by_op, port, query_rays,
                               small_scene, typed_scene)

W, H = 24, 18
JAX_CFG = JaxConfig(width=W, height=H)


_jax_closest = jax.jit(jax_batched.closest_hit, static_argnums=(3,))


def _boxes(lin, n):
    """The reference tree's leaf boxes for both packages."""
    jb = jax_leaf_boxes(lin, n)
    return jb, tuple(torch.from_numpy(np.asarray(b)) for b in jb)


@pytest.mark.parametrize("use_mt", [False, True])
def test_closest_hit_matches_jax(use_mt):
    """Every shape type (typed_scene), seeded rays with parked, NaN and
    zero-direction ones, with and without the leaf-box gate."""
    (flat, lin, cam), p = typed_scene()
    o, d = query_rays(SimpleNamespace(camera=cam), n=512, seed=5)
    jb, pb = _boxes(lin, flat.num_shapes)
    cache_j = jax_batched.precompute(flat)
    cache_p = batched.precompute(p.flat)
    for gate in (False, True):
        tj, sj, hj = (np.asarray(x) for x in _jax_closest(
            cache_j, jnp.asarray(o), jnp.asarray(d), use_mt,
            jb if gate else None))
        tp, sp, hp = batched.closest_hit(
            cache_p, torch.from_numpy(o), torch.from_numpy(d), use_mt,
            pb if gate else None)
        assert sp.dtype == torch.int32
        np.testing.assert_array_equal(hp.numpy(), hj)
        np.testing.assert_array_equal(sp.numpy()[hj], sj[hj])
        np.testing.assert_allclose(tp.numpy(), tj, rtol=1e-5)
        assert hj.sum() > 50


def _typed_light():
    """typed_scene's JAX light (the port's is ``typed_scene()[1].light``)."""
    return JaxLight((0, 4, -2), (1, 1, 1), 6.0)


def test_closest_hit_ties_to_lowest_index():
    """Two identical spheres (ids 1 and 3) tie on every ray that hits
    them: both packages pick id 1, as the reference's strict-< scan."""
    shapes = [((0, 0, -5), 1.0), ((0, 0, -4), 0.5), ((3, 0, -8), 1.0),
              ((0, 0, -4), 0.5)]
    flats = []
    for cls in (JaxBuilder, SceneBuilder):
        b = cls()
        for c, r in shapes:
            b.add_sphere(c, r)
        flats.append(b.build() if cls is JaxBuilder else b.build("cpu"))
    g = np.linspace(-0.07, 0.07, 9)
    ys, xs = np.meshgrid(g, g)
    d = np.stack([xs.ravel(), ys.ravel(), -np.ones(81)], 1)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    o = np.zeros_like(d)
    tj, sj, hj = (np.asarray(x) for x in _jax_closest(
        jax_batched.precompute(flats[0]), jnp.asarray(o), jnp.asarray(d)))
    tp, sp, hp = batched.closest_hit(batched.precompute(flats[1]),
                                     torch.from_numpy(o), torch.from_numpy(d))
    assert hj.all() and (sj == 1).all()
    np.testing.assert_array_equal(sp.numpy(), sj)
    np.testing.assert_allclose(tp.numpy(), tj, rtol=1e-5)


def test_reference_render_matches_jax():
    """The typed scene's oracle frame with the reference tree's leaf
    boxes, traced in chunks of 100 rays (so the last chunk is padded)."""
    (flat, lin, cam), p = typed_scene()
    light = _typed_light()
    jb, pb = _boxes(lin, flat.num_shapes)
    want = np.asarray(jax_reference.render(flat, cam, light, JAX_CFG,
                                           leaf_boxes=jb))
    got = reference.render(p.flat, p.camera, p.light,
                           RenderConfig(width=W, height=H, ray_chunk=100),
                           leaf_boxes=pb, device="cpu")
    assert got.shape == (H, W, 3) and got.dtype == torch.float32
    assert held_lazily(got.numpy(), want, lambda: op_by_op(
        jax_reference.render, flat, cam, light, JAX_CFG, leaf_boxes=jb),
        1e-4, axis=-1) == 0


def test_cpu_fallback_matches_jax():
    (flat, lin, cam), p = typed_scene()
    light = _typed_light()
    want = np.asarray(jax_cpu.render(flat, cam, light, JAX_CFG))
    got = cpu_fallback.render(p.flat, p.camera, p.light,
                              RenderConfig(width=W, height=H), device="cpu")
    assert held_lazily(got.numpy(), want, lambda: op_by_op(
        jax_cpu.render, flat, cam, light, JAX_CFG), 1e-4, rtol=1e-4,
        axis=-1) == 0


def test_loss_fn_oracle_grads_match_jax():
    """make_loss_fn without a renderer (the oracle): the MSE's gradients
    of the spheres' centres and radii and every material colour, against
    one jax.grad over the same fields."""
    (flat, _, _, cam, light), p = small_scene()
    fields = ("sphere_center", "sphere_radius", "mat_color")
    jcfg = JaxConfig(width=W, height=H, max_bounces=2)
    target = np.full((H, W, 3), 0.25, np.float32)
    loss_j = jax_inverse.make_loss_fn(flat, cam, light, jcfg,
                                      jnp.asarray(target), fields)
    want = jax.grad(loss_j)({f: getattr(flat, f) for f in fields})
    loss_p = diff.make_loss_fn(p.flat, p.camera, p.light,
                               RenderConfig(width=W, height=H, max_bounces=2),
                               torch.from_numpy(target), fields)
    params = {f: getattr(p.flat, f).clone().requires_grad_(True)
              for f in fields}
    got = torch.autograd.grad(loss_p(params), list(params.values()))
    for f, g in zip(fields, got):
        w = np.asarray(want[f])
        assert np.isfinite(g.numpy()).all() and np.abs(w).max() > 0
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=f)


def _split(p, lin, cfg):
    return [split_mod.render(p.flat, lin, p.camera, p.light, cfg,
                             split=p.split, device="cpu")]


def _no_bvh(p, lin, cfg):
    """The brute-force frame without leaf boxes, and the one-launch frame
    over split tables prepared without the reference tree."""
    return [brute.render(p.flat, lin, p.camera, p.light, cfg, device="cpu"),
            split_mod.render(p.flat, None, p.camera, p.light, cfg,
                             device="cpu")]


# name: (the port's frames, their settings, the oracle's leaf boxes on)
GAPS = {
    "split_mt_fresnel": (_split, dict(use_mt=True, use_fresnel=True), True),
    "no_bvh": (_no_bvh, dict(use_bvh=False), False),
    "one_launch_no_shadows": (_split, dict(enable_shadows=False), True),
    "one_launch_17x11x5": (_split, dict(width=17, height=11, max_bounces=5),
                           True),
}


@pytest.mark.parametrize("name", list(GAPS))
def test_renderer_settings_match_oracle(name):
    """The small scene (two spheres, one with Fresnel and a mirror term, a
    triangle, the degenerate-basis floor wall that BVH visibility clips)
    through a renderer with settings no other port test holds against
    the JAX package."""
    frame, kw, gated = GAPS[name]
    (flat, lin, split, cam, light), _ = small_scene()
    p = port(flat, split, cam, light, lin)
    jcfg = JAX_CFG.replace(**kw)
    cfg = RenderConfig(width=W, height=H).replace(**kw)
    jb = jax_leaf_boxes(lin, flat.num_shapes) if gated else None
    want = np.asarray(jax_reference.render(flat, cam, light, jcfg,
                                           leaf_boxes=jb))
    for img in frame(p, p.lin, cfg):
        assert img.shape == (cfg.height, cfg.width, 3)
        assert held_lazily(img.numpy(), want, lambda: op_by_op(
            jax_reference.render, flat, cam, light, jcfg, leaf_boxes=jb),
            1e-4, axis=-1) == 0
