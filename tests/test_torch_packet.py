"""The port's packet-BVH renderer (render/packet.py; plain versions on the
CPU) against the JAX package's ``pallas_bvh`` in interpret mode: the
closest-hit and occlusion queries on seeded rays (a tenth parked, some
NaN, some with a zero direction), the cull flags, and the frame on scenes
1 and 2, also with the any-hit shadow query (``USE_OCCLUSION``)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.accel.linearize import shape_leaf_boxes
from raytracer_tpu.config import RenderConfig as JaxConfig
from raytracer_tpu.geom import batched
from raytracer_tpu.render import pallas_bvh
from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.render import packet

from torch_port_common import (held_lazily, jax_scene_bvh, op_by_op,
                               pixels_held, ported_bvh, query_rays)

# The JAX kernels' tiles in interpret mode, and the frames of the tests.
KW = dict(width=24, height=18, max_bounces=3, tile_h=8, tile_w=128)
# Query rays: as many as a frame's pixels, so that the op-by-op oracle's
# per-operation compiles serve both the queries and the frames.
N_QUERY = 24 * 18


@functools.lru_cache(maxsize=None)
def _jax_queries(t_cull):
    """The JAX kernels' answers on scene 1's query rays: closest hits
    (t, sid, hit), and the occlusion mask against seeded limits."""
    sc, lin = jax_scene_bvh(1)
    o, d = query_rays(sc, N_QUERY)
    closest = pallas_bvh.make_closest_hit(lin, sc.flat, JaxConfig(**KW),
                                          t_cull=t_cull)
    t, sid, hit = (np.asarray(x) for x in closest(jnp.asarray(o),
                                                  jnp.asarray(d)))
    u = np.random.default_rng(5).uniform(size=t.shape).astype(np.float32)
    max_t = np.where(hit, t * (0.5 + u), 100 * u).astype(np.float32)
    max_t[:4], max_t[4:8] = np.inf, np.nan
    occ = np.asarray(closest.occlusion(jnp.asarray(o), jnp.asarray(d),
                                       jnp.asarray(max_t)))
    return o, d, (t, sid, hit), max_t, occ


@functools.lru_cache(maxsize=None)
def _t_opbyop():
    """The oracle's closest t on the query rays, one operation at a time."""
    sc, lin = jax_scene_bvh(1)
    o, d = query_rays(sc, N_QUERY)
    t, _, _ = op_by_op(batched.closest_hit, batched.precompute(sc.flat),
                       jnp.asarray(o), jnp.asarray(d), False,
                       shape_leaf_boxes(lin, sc.num_shapes))
    return t


def _port_query(o, d, t_cull):
    p = ported_bvh(1)
    closest = packet.make_closest_hit(p.lin, p.flat, RenderConfig(),
                                      t_cull=t_cull)
    return [x.numpy() for x in closest(torch.from_numpy(o),
                                       torch.from_numpy(d))]


@pytest.mark.parametrize("t_cull", [False, True])
def test_packet_query_matches_jax(t_cull):
    """hit and sid equal to the JAX kernel's (at most 1 disagreement), t
    held at rtol 1e-5 against the oracle's op-by-op value where XLA's
    FMAs move it; parked, NaN and zero-direction rays miss; t_cull on and
    off agree per ray."""
    o, d, (t, sid, hit), _, _ = _jax_queries(t_cull)
    pt, psid, phit = _port_query(o, d, t_cull)
    assert hit.sum() >= 128 and (~hit).sum() >= 64
    assert (phit != hit).sum() <= 1 and (psid != sid).sum() <= 1
    dead = ~np.isfinite(o).all(1) | (o[:, 0] >= 1e30) | (d == 0).all(1)
    assert dead.sum() >= 32 and not phit[dead].any()
    both = hit & phit
    assert held_lazily(pt[both], t[both], lambda: _t_opbyop()[both], atol=0,
                       rtol=1e-5) == 0
    other_t, other_sid, _ = _port_query(o, d, not t_cull)
    np.testing.assert_array_equal(other_t, pt)
    np.testing.assert_array_equal(other_sid, psid)


def test_occlusion_query_matches_jax():
    """The any-hit query equals the JAX occlusion kernel's and the
    closest hit's ``hit & (t < max_t)`` (at most 1 disagreement each),
    with infinite and NaN limits among them."""
    o, d, (t, _, hit), max_t, occ = _jax_queries(True)
    p = ported_bvh(1)
    closest = packet.make_closest_hit(p.lin, p.flat, RenderConfig())
    got = closest.occlusion(torch.from_numpy(o), torch.from_numpy(d),
                            torch.from_numpy(max_t)).numpy()
    assert 32 <= occ.sum() <= occ.size - 32
    assert (got != occ).sum() <= 1
    assert (got != (hit & (t < max_t))).sum() <= 1
    assert not got[4:8].any()


@functools.lru_cache(maxsize=None)
def _jax_frame(which, occlusion):
    sc, lin = jax_scene_bvh(which)
    old = pallas_bvh.USE_OCCLUSION
    pallas_bvh.USE_OCCLUSION = occlusion
    try:
        return np.asarray(pallas_bvh.render(
            sc.flat, lin, sc.camera, sc.light,
            JaxConfig(ray_chunk=24 * 18, **KW)))
    finally:
        pallas_bvh.USE_OCCLUSION = old


@pytest.mark.parametrize("which,occlusion", [(1, False), (2, False),
                                             (1, True)])
def test_packet_render_matches_jax(monkeypatch, which, occlusion):
    """The frame at 24x18x3: every pixel within atol 1e-4 of the JAX
    frame (or of the op-by-op oracle where XLA's FMAs move it) but at
    most 2."""
    monkeypatch.setattr(packet, "USE_OCCLUSION", occlusion)
    p = ported_bvh(which)
    img = packet.render(p.flat, p.lin, p.camera, p.light, RenderConfig(**KW),
                        device="cpu").numpy()
    assert img.shape == (18, 24, 3) and np.isfinite(img).all()
    n = pixels_held(img, _jax_frame(which, occlusion), which,
                    JaxConfig(ray_chunk=24 * 18, **KW))
    assert n <= 2, f"{n} pixels beyond 1e-4"


def test_node_cullable_flags_match_jax():
    """Scene 1: all nodes but the two over the degenerate floor wall."""
    sc, lin = jax_scene_bvh(1)
    p = ported_bvh(1)
    flags = packet.node_cullable_flags(p.lin, p.flat)
    np.testing.assert_array_equal(flags,
                                  pallas_bvh.node_cullable_flags(lin,
                                                                 sc.flat))
    assert flags.sum() == flags.size - 2
