"""The port's sorted-continuation hybrid (``render(sort_bounces=True)``, the
plain versions of the whole-frame kernel's emit and consume modes on the
CPU): the bounce-sort key against the JAX package's, the hybrid against
the port's own one-launch frame on scenes 1 and 2, and against the JAX
package's hybrid (the whole-frame Pallas kernel in interpret mode) on a
small scene."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.accel.linearize import shape_leaf_boxes
from raytracer_tpu.config import RenderConfig as JaxConfig
from raytracer_tpu.render import pallas_split
from raytracer_tpu.render import whitted as jax_whitted
from raytracer_tpu.render.reference import render as render_ref
from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.render import whitted
from raytracer_tpu_torch.render.split import render

from torch_port_common import (held, interpret_unroll, op_by_op, ported,
                               small_scene)


def _rays(n_live, n_parked, seed):
    """Seeded origins and unit directions; parked rows as the kernels park
    them, spread through the array."""
    rng = np.random.default_rng(seed)
    n = n_live + n_parked
    o = rng.normal(0.0, 20.0, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    live = np.ones(n, bool)
    live[rng.permutation(n)[:n_parked]] = False
    o[~live] = whitted.PARK_ORIGIN
    d[~live] = whitted._PARK_DIR
    return o, d, live


@pytest.mark.parametrize("n_live,n_parked", [(1000, 0), (700, 300), (0, 64)])
def test_bounce_sort_key_matches_jax(n_live, n_parked):
    """Equal keys on seeded rays, with parked rows and all parked (where
    the live box is empty and falls back to [0, 1])."""
    o, d, live = _rays(n_live, n_parked, seed=n_live + n_parked)
    args = (jnp.asarray(o), jnp.asarray(d), jnp.asarray(live))
    jitted = np.asarray(jax.jit(jax_whitted._bounce_sort_key)(*args))
    opbyop = op_by_op(jax_whitted._bounce_sort_key, *args)
    key = whitted._bounce_sort_key(torch.from_numpy(o), torch.from_numpy(d),
                                   torch.from_numpy(live))
    assert key.dtype == torch.int32
    key = key.numpy()
    beyond, _ = held(key, jitted, opbyop, atol=0)
    assert not beyond.any(), np.nonzero(beyond)
    assert (key[~live] == 1 << 30).all() and (key[live] < 1 << 24).all()


@pytest.mark.parametrize("which", [1, 2])
@pytest.mark.parametrize("kw", [
    {},
    {"second_sort": True},
    {"second_sort": True, "max_bounces": 2},
    {"max_bounces": 2},
], ids=["slim", "second_sort", "second_sort-2-bounces", "slim-2-bounces"])
def test_hybrid_matches_the_one_launch_frame(which, kw):
    """The hybrid traces the same hits as the one-launch frame; colours
    differ only by f32 re-association: atol 1e-6 (the JAX package's bar,
    tests/test_pallas_bvh.py)."""
    p = ported(which)
    cfg = RenderConfig(width=24, height=18, max_bounces=3).replace(**kw)
    one = render(p.flat, None, p.camera, p.light, cfg, split=p.split,
                 device="cpu").numpy()
    hybrid = render(p.flat, None, p.camera, p.light,
                    cfg.replace(sort_bounces=True), split=p.split,
                    device="cpu").numpy()
    assert hybrid.shape == (18, 24, 3) and np.isfinite(hybrid).all()
    np.testing.assert_allclose(hybrid, one, rtol=0, atol=1e-6)


def test_hybrid_matches_the_jax_hybrid_on_a_small_scene():
    """The JAX package's hybrid (its whole-frame kernel's emit and consume
    launches in interpret mode, with its 8-column sort) at 24x18 with 2
    bounces, every pixel within atol 1e-4 (see ``held``; the kernel is
    traced at ``INTERPRET_TRI_UNROLL``)."""
    (flat, lin, split, cam, light), p = small_scene()
    kw = dict(width=24, height=18, max_bounces=2, sort_bounces=True)
    with interpret_unroll():
        kernel = np.asarray(pallas_split.render(
            flat, lin, cam, light, JaxConfig(tile_h=8, tile_w=128, **kw),
            split=split))
    opbyop = op_by_op(render_ref, flat, cam, light,
                      JaxConfig(ray_chunk=24 * 18, **kw),
                      leaf_boxes=shape_leaf_boxes(lin, flat.num_shapes))
    img = render(p.flat, None, p.camera, p.light, RenderConfig(**kw),
                 split=p.split, device="cpu").numpy()
    beyond, _ = held(img, kernel, opbyop, atol=1e-4, axis=-1)
    assert not beyond.any(), np.argwhere(beyond)
    assert img.std() > 1e-2
