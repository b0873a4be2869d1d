"""The port's animated frame loop (render/dynamic.py::make_frame_fn) on the
CPU, with the JAX package's bars (tests/test_dynamic.py): the split route
against a static render of the same animated scene, the sorted hybrid
against the unsorted frame, the wheel animation against a fresh prepare,
the LBVH wavefront frame against JAX's, and the packet frame against the
wavefront frame."""

import copy
import functools
import types

import numpy as np
import pytest
import torch

from raytracer_tpu.config import RenderConfig as JaxConfig
from raytracer_tpu.render.dynamic import make_frame_fn as jax_make_frame_fn
from raytracer_tpu_torch.accel import build_bvh, linearize, refit_grow
from raytracer_tpu_torch.anim import bounce_spheres, rotate_wheels
from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.render import packet, split
from raytracer_tpu_torch.render.dynamic import make_frame_fn

from torch_port_common import jax_scene_bvh, ported_bvh

KW = dict(width=32, height=24, max_bounces=2, ray_chunk=768, tile_h=8,
          tile_w=128)
CFG = RenderConfig(**KW)
DT = 1 / 30


def _meta(which):
    """The JAX scene's animation metadata over the port's scene (the JAX
    package's tables carried across)."""
    sc, _ = jax_scene_bvh(which)
    p = ported_bvh(which)
    return types.SimpleNamespace(
        flat=p.flat, bvh_max_depth=sc.bvh_max_depth,
        bounce_params=list(sc.bounce_params), wheels=list(sc.wheels)), p


def _within_bars(img, ref):
    """tests/test_dynamic.py:68-69: a 1-ulp move of an animated centre or
    vertex may flip the winner at a silhouette pixel, so a handful of
    pixels may differ, the rest stay bit-tight."""
    d = np.abs(np.asarray(img) - np.asarray(ref)).max(axis=-1)
    assert (d > 1e-4).mean() < 0.005, (d.max(), (d > 1e-4).sum())
    assert np.median(d) <= 1e-6


def test_split_frame_matches_refit_oracle():
    """Scene 1's bouncing spheres through the split route (the pre-pass
    rows refreshed on the device) against a static split render over the
    grow-refit (updateBVH, main.cpp:1068-1077) of the reference tree."""
    meta, p = _meta(1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_frame_fn(meta, CFG, renderer="split")
    with pytest.raises(ValueError, match="renderer"):
        make_frame_fn(meta, CFG, renderer="reference", device="cpu")
    frame = make_frame_fn(meta, CFG, renderer="split", device="cpu")
    base = build_bvh(p.flat, meta.bvh_max_depth)
    images = []
    for t in (0.0, 0.5, 1.3):
        flat_t = bounce_spheres(p.flat, meta.bounce_params, t)
        lin_t = linearize(refit_grow(copy.deepcopy(base), flat_t))
        oracle = split.render(flat_t, lin_t, p.camera, p.light, CFG,
                              device="cpu")
        img, out = frame(p.flat, p.camera, p.light, t, DT)
        assert torch.equal(out.sphere_center, flat_t.sphere_center)
        _within_bars(img, oracle)
        images.append(img)
    assert (images[0] - images[2]).abs().max() > 1e-3   # spheres moved


def test_sorted_hybrid_matches_unsorted():
    """The sorted-continuation hybrid after the device refresh: the same
    hits, colours up to f32 re-association, over 2 chained frames."""
    meta, p = _meta(1)
    plain = make_frame_fn(meta, CFG, renderer="split", device="cpu")
    hybrid = make_frame_fn(meta, CFG.replace(sort_bounces=True),
                           renderer="split", device="cpu")
    cur_p = cur_s = p.flat
    for k in range(2):
        img_p, cur_p = plain(cur_p, p.camera, p.light, k * DT, DT)
        img_s, cur_s = hybrid(cur_s, p.camera, p.light, k * DT, DT)
    torch.testing.assert_close(img_s, img_p, rtol=0, atol=1e-6)


def test_wheel_split_matches_fresh_prepare():
    """Scene 2's first two wheels and a quarter of the other shapes
    (FlatScene.take, as tests/test_dynamic.py:105-144) over 3 frames:
    the device refresh with the triangle tree's refit against a fresh
    host prepare of the same rotated geometry."""
    sc, _ = jax_scene_bvh(2)
    p = ported_bvh(2)
    st = p.flat.shape_type.numpy()
    wheel_ids = sorted({int(i) for w in sc.wheels[:2] for i in w["indices"]})
    keep = np.unique(np.concatenate([np.flatnonzero(st != 3)[::4],
                                     np.asarray(wheel_ids, np.int64)]))
    remap = {int(g): i for i, g in enumerate(keep)}
    flat = p.flat.take(keep)
    wheels = [dict(w, indices=[remap[int(i)] for i in w["indices"]])
              for w in sc.wheels[:2]]
    meta = types.SimpleNamespace(flat=flat, bvh_max_depth=8,
                                 bounce_params=[], wheels=wheels)
    frame = make_frame_fn(meta, CFG, renderer="split", device="cpu")
    cur = host = flat
    for k in range(3):
        img, cur = frame(cur, p.camera, p.light, k * DT, DT)
        host = rotate_wheels(host, wheels, DT)
    assert torch.equal(cur.tri_p1, host.tri_p1)
    oracle = split.render(host, linearize(build_bvh(host, 8)), p.camera,
                          p.light, CFG, device="cpu")
    _within_bars(img, oracle)
    assert (cur.tri_p1 - flat.tri_p1).abs().max() > 1e-3


@functools.lru_cache(maxsize=None)
def _wavefront_frame(t: float):
    meta, p = _meta(1)
    frame = make_frame_fn(meta, CFG, renderer="wavefront", device="cpu")
    return frame(p.flat, p.camera, p.light, t, DT)[0]


def test_wavefront_frame_matches_jax():
    """Scene 1 at t = 0.5 over an LBVH rebuilt from the animated scene,
    against JAX's make_frame_fn(renderer="wavefront"). The animated
    centres differ by ulps (test_torch_anim.py), so the bars are the
    animated frames'."""
    sc, _ = jax_scene_bvh(1)
    want, _ = jax_make_frame_fn(sc, JaxConfig(**KW), renderer="wavefront")(
        sc.flat, sc.camera, sc.light, 0.5, DT)
    img = _wavefront_frame(0.5)
    assert img.shape == (24, 32, 3) and torch.isfinite(img).all()
    _within_bars(img, want)


def test_pallas_frame_matches_wavefront():
    """The packet renderer over the rebuilt LBVH (its cull flags from
    node_cullable_flags_device), with the closest-hit shadow walk and
    with USE_OCCLUSION, against the wavefront frame of the same tree
    (tests/test_dynamic.py:38's bar)."""
    meta, p = _meta(1)
    frame = make_frame_fn(meta, CFG, renderer="pallas", device="cpu")
    want = _wavefront_frame(0.5)
    for occlusion in (False, True):
        packet.USE_OCCLUSION = occlusion
        try:
            img, _ = frame(p.flat, p.camera, p.light, 0.5, DT)
        finally:
            packet.USE_OCCLUSION = False
        torch.testing.assert_close(img, want, rtol=0, atol=2e-5)
