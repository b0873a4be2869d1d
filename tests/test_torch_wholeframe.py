"""The port's whole frame (plain version of ``wholeframe_kernel``) against
the JAX package's production route, ``pallas_split.render`` — the
whole-frame Pallas kernel in interpret mode — on scene 1 at 24x18."""

import numpy as np
import torch

from raytracer_tpu.accel.linearize import shape_leaf_boxes
from raytracer_tpu.config import RenderConfig as JaxConfig
from raytracer_tpu.render import pallas_split
from raytracer_tpu.render.reference import render as render_ref
from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.render import wholeframe
from raytracer_tpu_torch.render.split import render

from torch_port_common import held, jax_scene, op_by_op, ported

# one bounce: the interpret-mode kernel costs ~30 s per bounce on the CPU
KW = dict(width=24, height=18, max_bounces=1, tile_h=8, tile_w=128)


def test_render_matches_the_interpret_mode_kernel():
    sc, lin, split = jax_scene(1)
    cfg = JaxConfig(ray_chunk=24 * 18, **KW)
    kernel = np.asarray(pallas_split.render(sc.flat, lin, sc.camera,
                                            sc.light, cfg, split=split))
    # the same frame one JAX operation at a time (the oracle; see held)
    opbyop = op_by_op(render_ref, sc.flat, sc.camera, sc.light, cfg,
                      leaf_boxes=shape_leaf_boxes(lin, sc.num_shapes))
    p = ported(1)
    img = render(p.flat, None, p.camera, p.light, RenderConfig(**KW),
                 split=p.split, device="cpu").numpy()
    beyond, _ = held(img, kernel, opbyop, atol=1e-4, axis=-1)
    assert not beyond.any(), np.argwhere(beyond)

    # a list of pixels traces exactly what the whole frame does
    pix = torch.tensor([0, 5, 24 * 9 + 12, 24 * 18 - 1])
    par = wholeframe.make_params(p.camera, p.light)
    some = wholeframe.wholeframe_plain(p.split, p.attr_tab, par,
                                       RenderConfig(**KW), pixels=pix)
    np.testing.assert_array_equal(some.numpy(),
                                  img.reshape(-1, 3)[pix.numpy()])
