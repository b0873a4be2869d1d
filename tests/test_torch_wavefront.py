"""The port's wavefront renderer (render/wavefront.py, PyTorch tensor ops;
the oracle of the packet and brute-force kernels on the card) against the
JAX package's ``wavefront``, and the row-wise union test that its walk,
the packet walk's plain version and the brute-force plain version share
(geom/rowwise.py) against the JAX ``intersect_rows``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.config import RenderConfig as JaxConfig
from raytracer_tpu.geom import rowwise as jax_rowwise
from raytracer_tpu.render import wavefront as jax_wavefront
from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.geom import rowwise
from raytracer_tpu_torch.render import wavefront

from torch_port_common import (held_lazily, jax_scene_bvh, op_by_op,
                               pixels_held, ported_bvh, query_rays)

KW = dict(width=24, height=18, max_bounces=3, ray_chunk=24 * 18)


@pytest.mark.parametrize("use_mt", [False, True])
def test_intersect_rows_matches_jax(use_mt):
    """Each lane's ray against its own row of scene 1 (spheres, walls and
    triangles): inner equal, t held at rtol 1e-5 against the jitted JAX
    value, or the op-by-op one where XLA's contracted FMAs move it."""
    sc, _ = jax_scene_bvh(1)
    rng = np.random.default_rng(3)
    rows_j = jax_rowwise.pack_rows(sc.flat)
    types = np.asarray(sc.flat.shape_type)
    pick = np.concatenate([rng.choice(np.nonzero(types == k)[0], 128)
                           for k in (0, 2, 3)])
    o, d = query_rays(sc, pick.size, seed=4)
    rows = rows_j[pick]
    t_j, inner_j = (np.asarray(x) for x in jax_rowwise.intersect_rows(
        rows, jnp.asarray(o), jnp.asarray(d), use_mt))
    t, inner = rowwise.intersect_rows(torch.from_numpy(np.array(rows)),
                                      torch.from_numpy(o),
                                      torch.from_numpy(d), use_mt)
    assert inner_j.sum() >= 32
    np.testing.assert_array_equal(inner.numpy(), inner_j)
    assert held_lazily(t.numpy()[inner_j], t_j[inner_j], lambda: op_by_op(
        jax_rowwise.intersect_rows, rows, jnp.asarray(o), jnp.asarray(d),
        use_mt)[0][inner_j], atol=0, rtol=1e-5) == 0


@pytest.mark.parametrize("which", [1, 2, 3])
def test_wavefront_render_matches_jax(which):
    """The frame at 24x18x3, traced as one wave: every pixel within atol
    1e-4 of the JAX frame (or of the op-by-op oracle where XLA's FMAs move
    it) but at most 2."""
    sc, lin = jax_scene_bvh(which)
    p = ported_bvh(which)
    img = wavefront.render(p.flat, p.lin, p.camera, p.light,
                           RenderConfig(**KW), device="cpu").numpy()
    assert img.shape == (18, 24, 3) and np.isfinite(img).all()
    cfg = JaxConfig(**KW)
    n = pixels_held(img, np.asarray(jax_wavefront.render(
        sc.flat, lin, sc.camera, sc.light, cfg)), which, cfg)
    assert n <= 2, f"{n} pixels beyond 1e-4"
