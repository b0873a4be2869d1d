"""The port's strip-sharded multi-device route (``parallel/sharding.py``)
on meshes of virtual CPU shards, and the window mode of the whole-frame
kernel's plain version that the strips run on.

- the window: strips (rows, y_off) of a 24x18 frame put together equal the
  whole frame, bit for bit, in raygen mode and in emit + consume;
- ``render_sharded_split`` on 2 and 3 strips equals the port's own
  ``split.render`` bit for bit, with and without ``sort_bounces``;
- the strips against the JAX package's ``render_sharded_split`` on a
  2-device mesh (its whole-frame kernel in interpret mode), 1e-4 a pixel
  through ``held_lazily``;
- the sharded oracle (``render_sharded`` with leaf boxes) and its sphere
  centre gradient against JAX ``render_sharded`` / ``jax.grad`` on a
  2-device mesh: the frame at 1e-6 through ``held_lazily``, the gradient
  at tests/test_dist.py's rtol 1e-4 / atol 1e-7;
- the wavefront walk over ray shards against ``wavefront.render``; the
  sharded differentiable split route's gradients against the port's
  single-device ones; ``dryrun_multichip(4, device="cpu")``; and
  ``make_mesh()`` raising without a card.

The JAX side runs one interpret-mode Pallas compile here, at
``INTERPRET_TRI_UNROLL``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.accel.linearize import shape_leaf_boxes
from raytracer_tpu.config import RenderConfig as JaxConfig
from raytracer_tpu.parallel import make_mesh as jax_mesh
from raytracer_tpu.parallel import render_sharded as jax_render_sharded
from raytracer_tpu.parallel.sharding import \
    render_sharded_split as jax_render_sharded_split
from raytracer_tpu.render.reference import render as render_ref
from raytracer_tpu_torch.accel import build_bvh, linearize
from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.parallel import (make_mesh, render_sharded,
                                          render_sharded_split)
from raytracer_tpu_torch.parallel.dryrun import dryrun_multichip
from raytracer_tpu_torch.render import wavefront
from raytracer_tpu_torch.render import wholeframe as wf
from raytracer_tpu_torch.render.split import render
from raytracer_tpu_torch.render.whitted import _attr_table

from torch_port_common import (held_lazily, interpret_unroll, op_by_op,
                               small_scene)

W, H = 24, 18


def _strips(rows):
    """(rows of each strip, y_off) of an H-row frame cut into strips of
    ``rows`` rows, the last one cut at H."""
    return [(min(rows, H - y), y) for y in range(0, H, rows)]


@pytest.mark.parametrize("mode", ["raygen", "emit+consume"])
def test_window_strips_equal_the_whole_frame(mode):
    """``wholeframe_plain`` on windows (rows, y_off) of a 24x18 frame, put
    together, equals the whole frame bit for bit: in raygen mode the
    frame; in emit + consume the bounce-1 colours and continuation state
    and the continuation over the strip's own rays (window-order ret)."""
    _, p = small_scene()
    cfg = RenderConfig(width=W, height=H, max_bounces=3)
    tab = _attr_table(p.flat)
    whole = wf.make_params(p.camera, p.light)
    for rows in (7, 5):
        parts = []
        for n, y in _strips(rows):
            par = wf.make_params(p.camera, p.light, y_off=y)
            if mode == "raygen":
                parts.append(wf.wholeframe_plain(p.split, tab, par, cfg,
                                                 rows=n))
                continue
            acc, state = wf.wholeframe_plain(p.split, tab, par, cfg,
                                             bounces=1, emit_state=True,
                                             rows=n)
            rays, perm = wf._repack(state, 9)
            rel = wf.wholeframe_plain(p.split, tab, par, cfg, bounces=2,
                                      rays=rays, ret=perm.to(torch.int32),
                                      rows=n)
            parts.append((acc, state, wf._unsort(rel, perm)))
        if mode == "raygen":
            assert torch.equal(torch.cat(parts),
                               wf.wholeframe_plain(p.split, tab, whole, cfg))
            continue
        acc, state = wf.wholeframe_plain(p.split, tab, whole, cfg,
                                         bounces=1, emit_state=True)
        rays, perm = wf._repack(state, 9)
        rel = wf.wholeframe_plain(p.split, tab, whole, cfg, bounces=2,
                                  rays=rays, ret=perm.to(torch.int32))
        assert torch.equal(torch.cat([a.reshape(-1, 3) for a, _, _ in parts]),
                           acc.reshape(-1, 3))
        assert torch.equal(torch.cat([s for _, s, _ in parts], dim=1), state)
        assert torch.equal(torch.cat([r for _, _, r in parts]),
                           wf._unsort(rel, perm))


@pytest.mark.parametrize("n", [2, 3])
def test_strip_frames_equal_split_render(n):
    """``render_sharded_split`` on n virtual CPU shards equals the port's
    single-device ``split.render`` bit for bit: the one-launch frame and
    the sort_bounces hybrid (whose re-sort runs within each strip)."""
    _, p = small_scene()
    for sort in (False, True):
        cfg = RenderConfig(width=W, height=H, max_bounces=3,
                           sort_bounces=sort)
        one = render(p.flat, None, p.camera, p.light, cfg, split=p.split,
                     device="cpu")
        img = render_sharded_split(p.flat, p.split, p.camera, p.light, cfg,
                                   make_mesh(n, device="cpu"))
        assert img.shape == (H, W, 3) and img.std() > 1e-2
        assert torch.equal(img, one), (n, sort)


def test_strip_frame_matches_jax_sharded_split():
    """The port's 2-strip frame against the JAX package's
    ``render_sharded_split`` on a 2-device mesh (strips of its
    whole-frame kernel in interpret mode) at 24x18 with 1 bounce (each
    bounce adds seconds to the interpret-mode compile; the strips'
    reflections are held bit for bit against the port's own frame
    above): every pixel within 1e-4 (``held_lazily``, the op-by-op value
    of the JAX oracle with leaf boxes where XLA's FMAs moved the jitted
    one)."""
    (flat, lin, split, cam, light), p = small_scene()
    kw = dict(width=W, height=H, max_bounces=1)
    with interpret_unroll():
        jitted = np.asarray(jax_render_sharded_split(
            flat, split, cam, light, JaxConfig(**kw), jax_mesh(2)))
    img = render_sharded_split(p.flat, p.split, p.camera, p.light,
                               RenderConfig(**kw), make_mesh(2, device="cpu"))
    beyond = held_lazily(img.numpy(), jitted, lambda: op_by_op(
        render_ref, flat, cam, light, JaxConfig(ray_chunk=W * H, **kw),
        leaf_boxes=shape_leaf_boxes(lin, flat.num_shapes)), atol=1e-4,
        axis=-1)
    assert beyond == 0


def _oracle_loss(center, render_fn, target):
    """(the mean squared error against ``target``, the image) of
    ``render_fn(center)``."""
    img = render_fn(center)
    return ((img - target) ** 2).mean(), img


def test_sharded_oracle_frame_and_gradient_match_jax():
    """``render_sharded`` (the brute-force oracle with leaf boxes) on two
    virtual shards against JAX ``render_sharded`` on a 2-device mesh at
    24x18 with 1 bounce: the frame within 1e-6 (``held_lazily``) and the
    gradient of the MSE with respect to every sphere centre within rtol
    1e-4, atol 1e-7 (tests/test_dist.py's bar), from one jax.grad."""
    (flat, lin, _, cam, light), p = small_scene()
    lb = shape_leaf_boxes(lin, flat.num_shapes)
    kw = dict(width=W, height=H, max_bounces=1, ray_chunk=96)
    target = np.full((H, W, 3), 0.2, np.float32)

    def jax_frame(c):
        return jax_render_sharded(flat.replace(sphere_center=c), cam, light,
                                  JaxConfig(**kw), jax_mesh(2),
                                  leaf_boxes=lb)

    (_, want), g_want = jax.value_and_grad(
        lambda c: _oracle_loss(c, jax_frame, jnp.asarray(target)),
        has_aux=True)(flat.sphere_center)

    center = p.flat.sphere_center.clone().requires_grad_(True)
    plb = tuple(torch.from_numpy(np.array(b)) for b in lb)
    val, img = _oracle_loss(center, lambda c: render_sharded(
        p.flat.replace(sphere_center=c), p.camera, p.light,
        RenderConfig(**kw), make_mesh(2, device="cpu"), leaf_boxes=plb),
        torch.from_numpy(target))
    (g,) = torch.autograd.grad(val, [center])
    beyond = held_lazily(img.detach().numpy(), np.asarray(want),
                         lambda: op_by_op(render_ref, flat, cam, light,
                                          JaxConfig(**{**kw, "ray_chunk":
                                                       W * H}),
                                          leaf_boxes=lb),
                         atol=1e-6)
    assert beyond == 0
    assert torch.isfinite(g).all() and g.abs().sum() > 0
    np.testing.assert_allclose(g.numpy(), np.asarray(g_want), rtol=1e-4,
                               atol=1e-7)


def test_sharded_wavefront_equals_wavefront_render():
    """``render_sharded`` with a tree (the wavefront walk over ray shards)
    on 3 virtual shards equals the port's single-device
    ``wavefront.render`` bit for bit (tests/test_dist.py's sharded-BVH
    case)."""
    _, p = small_scene()
    lin = linearize(build_bvh(p.flat, 8))
    cfg = RenderConfig(width=W, height=H, max_bounces=2, ray_chunk=W * H)
    img = render_sharded(p.flat, p.camera, p.light, cfg,
                         make_mesh(3, device="cpu"), bvh=lin)
    one = wavefront.render(p.flat, lin, p.camera, p.light, cfg,
                           device="cpu")
    assert img.std() > 1e-2 and torch.equal(img, one)


def test_sharded_differentiable_split_gradients_match_one_device():
    """The sharded differentiable split route (the per-bounce route in ray
    shards, gradients summed over the shards through ``Tensor.to``)
    gives the loss and sphere-centre and colour gradients of the
    single-device route: 3 shards against 1, within rtol 1e-5."""
    _, p = small_scene()
    cfg = RenderConfig(width=W, height=H, max_bounces=2)
    target = torch.full((H, W, 3), 0.3)
    out = []
    for n in (1, 3):
        c = p.flat.sphere_center.clone().requires_grad_(True)
        m = p.flat.mat_color.clone().requires_grad_(True)
        img = render_sharded_split(
            p.flat.replace(sphere_center=c, mat_color=m), p.split, p.camera,
            p.light, cfg, make_mesh(n, device="cpu"), differentiable=True)
        val = ((img - target) ** 2).mean()
        out.append((val.detach(), *torch.autograd.grad(val, [c, m])))
    one = render(p.flat, None, p.camera, p.light, cfg, split=p.split,
                 differentiable=True, device="cpu")
    assert torch.equal(((one - target) ** 2).mean().detach(), out[0][0])
    for a, b in zip(out[0], out[1]):
        assert torch.isfinite(b).all()
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5,
                                   atol=1e-9)
    assert out[1][1].abs().sum() > 0


def test_dryrun_multichip_on_four_virtual_shards():
    """The dry run: the sharded oracle's SGD step, the sharded
    differentiable split route's loss and gradient, and scene 1 and scene
    2's hybrid on 4 shards against 1 (max-abs 0 here)."""
    out = dryrun_multichip(4, device="cpu")
    assert out["devices"] == ["cpu"] * 4
    assert out["scene1_max_abs"] == 0 and out["scene2_hybrid_max_abs"] == 0
    assert np.isfinite(out["oracle_loss"]) and out["split_loss"] > 0


def test_make_mesh_needs_a_card():
    """``make_mesh()`` takes the visible cards and raises without one; a
    mesh of virtual shards names its device n times."""
    assert make_mesh(3, device="cpu") == (torch.device("cpu"),) * 3
    with pytest.raises(ValueError):
        make_mesh(0, device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a card is visible: make_mesh() succeeds")
    for n in (None, 1):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh(n)
    with pytest.raises(RuntimeError):
        make_mesh(2, device="cuda")
