"""The port's ``render()`` on the CPU (the plain version of the whole-frame
kernel) against the JAX oracle ``reference.render`` with the reference
tree's leaf boxes, at 24x18 with 3 bounces on scenes 1 and 2."""

import numpy as np
import pytest

from raytracer_tpu.accel.linearize import shape_leaf_boxes
from raytracer_tpu.config import RenderConfig as JaxConfig
from raytracer_tpu.render.reference import render as render_ref
from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.render.split import render

from torch_port_common import held, jax_scene, op_by_op, ported

KW = dict(width=24, height=18, max_bounces=3, tile_h=8, tile_w=128)


def _images(which, use_gram_tri):
    sc, lin, _ = jax_scene(which)
    lb = shape_leaf_boxes(lin, sc.num_shapes)
    cfg = JaxConfig(ray_chunk=24 * 18, use_gram_tri=use_gram_tri, **KW)
    jitted = np.asarray(render_ref(sc.flat, sc.camera, sc.light, cfg,
                                   leaf_boxes=lb))
    opbyop = op_by_op(render_ref, sc.flat, sc.camera, sc.light, cfg,
                      leaf_boxes=lb)
    p = ported(which)
    img = render(p.flat, None, p.camera, p.light,
                 RenderConfig(use_gram_tri=use_gram_tri, **KW),
                 split=p.split, device="cpu").numpy()
    return img, jitted, opbyop


@pytest.mark.parametrize("which", [1, 2])
def test_render_raw_triangle_test_matches_oracle(which):
    """The raw barycentric test is the oracle's formulation: every pixel
    within atol 1e-4 (the bar of tests/test_scene2_parity.py)."""
    img, jitted, opbyop = _images(which, use_gram_tri=False)
    assert img.shape == (18, 24, 3) and np.isfinite(img).all()
    beyond, _ = held(img, jitted, opbyop, atol=1e-4, axis=-1)
    assert not beyond.any(), np.argwhere(beyond)


@pytest.mark.parametrize("which", [1, 2])
def test_render_gram_triangle_test_matches_oracle(which):
    """The default Gram-fused test reassociates f32 sums, which can flip an
    accept exactly on a triangle edge: every pixel within atol 1e-4 but at
    most 2 (the flips are counted in the assertion message)."""
    img, jitted, opbyop = _images(which, use_gram_tri=True)
    beyond, _ = held(img, jitted, opbyop, atol=1e-4, axis=-1)
    assert beyond.sum() <= 2, f"{beyond.sum()} pixels beyond 1e-4"
