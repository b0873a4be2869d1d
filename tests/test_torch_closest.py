"""The port's closest-hit query (``make_closest_hit``, plain version on the
CPU) against the JAX package's ``pallas_split.make_closest_hit`` in Pallas
interpret mode, on random rays and on camera rays of scene 1."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.config import RenderConfig as JaxConfig
from raytracer_tpu.core.camera import get_rays
from raytracer_tpu.geom import batched
from raytracer_tpu.render import pallas_split
from raytracer_tpu.accel.linearize import shape_leaf_boxes
from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.render.split import make_closest_hit

from torch_port_common import held, jax_scene, op_by_op, ported

N_RAYS = 256


@pytest.fixture(scope="module")
def queries():
    """256 seeded random rays and 256 camera rays through seeded pixels of
    the 800x600 frame, and JAX's closest hits and occlusion answers."""
    sc, lin, split = jax_scene(1)
    rng = np.random.default_rng(7)
    ro = rng.uniform(-40, 40, (N_RAYS, 3)).astype(np.float32)
    rd = rng.normal(size=(N_RAYS, 3))
    rd = (rd / np.linalg.norm(rd, axis=1, keepdims=True)).astype(np.float32)
    pix = rng.integers(0, 800 * 600, N_RAYS)
    ndc_x = jnp.asarray(2.0 * (pix % 800) / 800 - 1.0, jnp.float32)
    ndc_y = jnp.asarray(1.0 - 2.0 * (pix // 800) / 600, jnp.float32)
    so, sd = (np.asarray(a) for a in get_rays(sc.camera, ndc_x, ndc_y))
    o = np.concatenate([ro, so])
    d = np.concatenate([rd, sd])

    closest = pallas_split.make_closest_hit(
        split, JaxConfig(width=24, height=18, tile_h=8, tile_w=128))
    t, sid, hit = (np.asarray(x) for x in closest(jnp.asarray(o),
                                                  jnp.asarray(d)))
    limit = np.where(hit, t * rng.uniform(0.5, 1.5, 2 * N_RAYS),
                     rng.uniform(0, 100, 2 * N_RAYS)).astype(np.float32)
    occ = np.asarray(closest.occlusion(jnp.asarray(o), jnp.asarray(d),
                                       jnp.asarray(limit)))
    # the same closest hits, one JAX operation at a time (the oracle)
    t_op, sid_op, hit_op = op_by_op(
        batched.closest_hit, batched.precompute(sc.flat), jnp.asarray(o),
        jnp.asarray(d), False, shape_leaf_boxes(lin, sc.num_shapes))
    return dict(o=o, d=d, t=t, sid=sid, hit=hit, limit=limit, occ=occ,
                t_op=t_op, sid_op=sid_op)


@pytest.fixture(scope="module")
def port_closest():
    return make_closest_hit(ported(1).split, RenderConfig())


@pytest.mark.parametrize("rays", ["random", "camera"])
def test_closest_hit_matches_jax(queries, port_closest, rays):
    sl = slice(0, N_RAYS) if rays == "random" else slice(N_RAYS, None)
    q = {k: v[sl] for k, v in queries.items()}
    t, sid, hit = (x.numpy() for x in port_closest(torch.from_numpy(q["o"]),
                                                   torch.from_numpy(q["d"])))
    assert hit.sum() > N_RAYS // 4
    agree = (sid == q["sid"]) & (hit == q["hit"])
    assert (~agree).sum() <= 1, np.nonzero(~agree)
    both = agree & hit
    beyond, _ = held(t[both], q["t"][both], q["t_op"][both], atol=0,
                     rtol=1e-5)
    assert not beyond.any(), np.nonzero(beyond)


@pytest.mark.parametrize("rays", ["random", "camera"])
def test_occlusion_matches_jax(queries, port_closest, rays):
    sl = slice(0, N_RAYS) if rays == "random" else slice(N_RAYS, None)
    q = {k: v[sl] for k, v in queries.items()}
    occ = port_closest.occlusion(torch.from_numpy(q["o"]),
                                 torch.from_numpy(q["d"]),
                                 torch.from_numpy(q["limit"])).numpy()
    assert 0 < q["occ"].sum() < N_RAYS
    assert (occ != q["occ"]).sum() <= 1


@pytest.mark.parametrize("mode", ["raw", "gram", "mt"])
def test_triangle_tests_match_the_oracle(queries, mode):
    """Every triangle test of the walk against the JAX oracle's brute-force
    closest hit (barycentric or Moller-Trumbore), one operation at a
    time."""
    sc, lin, _ = jax_scene(1)
    use_mt = mode == "mt"
    o, d = queries["o"], queries["d"]
    t_op, sid_op, hit_op = op_by_op(
        batched.closest_hit, batched.precompute(sc.flat), jnp.asarray(o),
        jnp.asarray(d), use_mt, shape_leaf_boxes(lin, sc.num_shapes))
    cfg = RenderConfig(use_mt=use_mt, use_gram_tri=mode == "gram")
    t, sid, hit = (x.numpy() for x in make_closest_hit(ported(1).split, cfg)(
        torch.from_numpy(o), torch.from_numpy(d)))
    agree = (sid == sid_op) & (hit == hit_op)
    assert (~agree).sum() <= 1, np.nonzero(~agree)
    both = agree & hit
    np.testing.assert_allclose(t[both], t_op[both], rtol=1e-5, atol=0)
