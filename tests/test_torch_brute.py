"""The port's brute-force renderer (render/brute.py; the plain version on
the CPU) against the JAX package's ``pallas_kernel`` in interpret mode:
the type sort and the extended rows, the closest-hit query on seeded rays
(a tenth parked, some NaN, some with a zero direction) without the
leaf-box gate and with it and Moller-Trumbore, and the frames of scenes
1-3."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.accel.linearize import shape_leaf_boxes
from raytracer_tpu.config import RenderConfig as JaxConfig
from raytracer_tpu.geom import batched
from raytracer_tpu.render import pallas_kernel
from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.render import brute

from torch_port_common import (held_lazily, jax_scene_bvh, op_by_op,
                               pixels_held, ported_bvh, query_rays,
                               typed_scene)

KW = dict(width=24, height=18, max_bounces=3, tile_h=8, tile_w=128)


@pytest.mark.parametrize("which", [1, 2, 3])
def test_type_sort_and_extended_rows_match_jax(which):
    sc, lin = jax_scene_bvh(which)
    p = ported_bvh(which)
    perm_j, counts_j = pallas_kernel.sort_scene_by_type(sc.flat)
    perm, counts = brute.sort_scene_by_type(p.flat)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(perm_j))
    assert counts == counts_j
    for boxes in (None, shape_leaf_boxes(lin, sc.num_shapes)):
        want = pallas_kernel.pack_rows_ext(sc.flat, perm_j, boxes)
        got = brute.pack_rows_ext(
            p.flat, perm, None if boxes is None else
            tuple(torch.tensor(np.asarray(b)) for b in boxes))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("gate,use_mt", [(False, False), (True, True)])
def test_brute_query_matches_jax(gate, use_mt):
    """On a scene with every shape type: hit and sid equal to the JAX
    kernel's (at most 1 disagreement), t held at rtol 1e-5 against the
    oracle's op-by-op value where XLA's FMAs move it; parked, NaN and
    zero-direction rays miss."""
    (flat, lin, cam), p = typed_scene()
    o, d = query_rays(types.SimpleNamespace(camera=cam), 256, seed=1)
    boxes = shape_leaf_boxes(lin, flat.num_shapes) if gate else None
    perm_j, counts = pallas_kernel.sort_scene_by_type(flat)
    assert all(counts)
    closest = pallas_kernel.make_closest_hit(
        pallas_kernel.pack_rows_ext(flat, perm_j, boxes), perm_j, counts,
        JaxConfig(use_mt=use_mt, **KW), gate_boxes=gate)
    t, sid, hit = (np.asarray(x) for x in closest(jnp.asarray(o),
                                                  jnp.asarray(d)))
    perm, counts = brute.sort_scene_by_type(p.flat)
    rows = brute.pack_rows_ext(
        p.flat, perm, None if boxes is None else
        tuple(torch.tensor(np.asarray(b)) for b in boxes))
    got = brute.make_closest_hit(rows, perm, counts,
                                 RenderConfig(use_mt=use_mt), gate)(
        torch.from_numpy(o), torch.from_numpy(d))
    pt, psid, phit = (x.numpy() for x in got)
    assert hit.sum() >= 64 and (~hit).sum() >= 32
    # every typed loop finds hits (the barycentric test is single-sided,
    # and these triangles face away from most of the rays)
    hit_types = set(np.asarray(flat.shape_type)[sid[hit]].tolist())
    assert {0, 1, 2} <= hit_types and (3 in hit_types or not use_mt)
    assert (phit != hit).sum() <= 1 and (psid != sid).sum() <= 1
    dead = ~np.isfinite(o).all(1) | (o[:, 0] >= 1e30) | (d == 0).all(1)
    assert dead.sum() >= 16 and not phit[dead].any()
    both = hit & phit
    assert held_lazily(pt[both], t[both], lambda: op_by_op(
        batched.closest_hit, batched.precompute(flat), jnp.asarray(o),
        jnp.asarray(d), use_mt, boxes)[0][both], atol=0, rtol=1e-5) == 0


@pytest.mark.parametrize("which", [1, 2, 3])
def test_brute_render_matches_jax(which):
    """The frame at 24x18x3, the BVH's leaf boxes gating the hits: every
    pixel within atol 1e-4 of the JAX frame (or of the op-by-op oracle
    where XLA's FMAs move it) but at most 2."""
    sc, lin = jax_scene_bvh(which)
    p = ported_bvh(which)
    img = brute.render(p.flat, p.lin, p.camera, p.light, RenderConfig(**KW),
                       device="cpu").numpy()
    assert img.shape == (18, 24, 3) and np.isfinite(img).all()
    cfg = JaxConfig(ray_chunk=24 * 18, **KW)
    n = pixels_held(img, np.asarray(pallas_kernel.render(
        sc.flat, lin, sc.camera, sc.light, cfg)), which, cfg)
    assert n <= 2, f"{n} pixels beyond 1e-4"
