"""The port's table refreshers and inverse fit against the JAX package:
``split_scene.update_dynamic`` (tensor code) after moving a sphere and
translating a triangle, the refit metadata of ``prepare``,
``diff.image_loss_pyramid``, and the first SGD steps of
``diff.fit_scene_params`` through ``diff.make_kernel_renderer`` on
tests/test_inverse_kernel.py's first scene at 32x24 with 2 bounces."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.accel import build_bvh, linearize
from raytracer_tpu.config import RenderConfig as JaxConfig
from raytracer_tpu.core import camera as cam_ops
from raytracer_tpu.core.scene import SceneBuilder
from raytracer_tpu.core.types import Light, Material
from raytracer_tpu.diff import inverse as jax_inverse
from raytracer_tpu.render import pallas_split
from raytracer_tpu.render import split_scene as jax_split_scene
from raytracer_tpu_torch import diff
from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.render import split_scene

from torch_port_common import (held, interpret_unroll, jax_scene, port,
                               ported, ported_bvh, refit_numpy, small_scene)


def _moved(flat):
    """The JAX scene with its first sphere moved and every triangle
    translated, triangle planes recomputed."""
    st = np.asarray(flat.shape_type)
    si = int(np.nonzero(st == 0)[0][0])
    ti = np.nonzero(st == 3)[0]
    shift = jnp.array([0.05, 0.1, -0.07], jnp.float32)
    return flat.replace(
        sphere_center=flat.sphere_center.at[si].add(
            jnp.array([0.3, -0.2, 0.1], jnp.float32)),
        tri_p1=flat.tri_p1.at[ti].add(shift),
        tri_p2=flat.tri_p2.at[ti].add(shift),
        tri_p3=flat.tri_p3.at[ti].add(shift)).recompute_tri_planes()


@pytest.mark.parametrize("which", ["small", 1])
def test_update_dynamic_matches_jax(which):
    """Every refreshed table equals the JAX function's, held through
    ``held`` with no tolerance: against the jitted value (as
    make_kernel_renderer runs it), and against the value computed one
    operation at a time where XLA's contracted FMAs (d00*d11 - d01*d01
    and the Gram constants) moved it."""
    if which == "small":
        (flat, _, split, cam, light), p = small_scene()
    else:
        sc, _, split = jax_scene(which)
        flat, cam, light, p = sc.flat, sc.camera, sc.light, ported(which)
    moved = _moved(flat)
    jitted = jax.jit(jax_split_scene.update_dynamic)(split, moved)
    opbyop = jax_split_scene.update_dynamic(split, moved)   # not jitted
    got = split_scene.update_dynamic(p.split,
                                     port(moved, None, cam, light).flat)
    for name, n in (("nodes", split.m), ("pre_rows", split.n_other),
                    ("tri_rows", split.n_tri)):
        g = getattr(got, name)
        assert not g.requires_grad and g.is_contiguous()
        beyond, _ = held(g[:n].numpy(), np.asarray(getattr(jitted, name))[:n],
                         np.asarray(getattr(opbyop, name))[:n], atol=0)
        assert not beyond.any(), (name, np.argwhere(beyond)[:5])
    # the tables moved, and the int tables and ids are the same objects
    assert not torch.equal(got.pre_rows, p.split.pre_rows)
    assert not torch.equal(got.tri_rows, p.split.tri_rows)
    assert got.skip is p.split.skip and got.max_id == p.split.max_id


@pytest.mark.parametrize("which", [1, 2])
def test_prepare_refit_metadata_matches_jax(which):
    """``prepare`` stores the JAX SplitScene's refit metadata, and a
    refresh of an unchanged scene keeps the triangle rows and the refit
    node boxes as ``prepare`` built them."""
    _, _, split = jax_scene(which)
    pb = ported_bvh(which)
    sp = split_scene.prepare(pb.flat, pb.lin)
    for name, want in refit_numpy(split).items():
        got = getattr(sp, name)
        np.testing.assert_array_equal(
            got.numpy() if isinstance(got, torch.Tensor) else got, want,
            err_msg=name)
    again = split_scene.update_dynamic(sp, pb.flat)
    assert torch.equal(again.tri_rows, sp.tri_rows)
    assert torch.equal(again.nodes, sp.nodes)


def test_image_loss_pyramid_matches_jax():
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 1, (37, 53, 3)).astype(np.float32)
    tgt = rng.uniform(0, 1, (37, 53, 3)).astype(np.float32)
    for scales in ((1, 4, 16), (1,), (2, 5)):
        want = float(jax_inverse.image_loss_pyramid(
            jnp.asarray(img), jnp.asarray(tgt), scales))
        got = diff.image_loss_pyramid(torch.from_numpy(img),
                                      torch.from_numpy(tgt), scales)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=1e-6)


def test_loss_fn_needs_a_renderer():
    p = ported(1)
    with pytest.raises(NotImplementedError, match="reference"):
        diff.make_loss_fn(p.flat, p.camera, p.light, RenderConfig(),
                          torch.zeros(1), ["mat_color"])


JAX_CFG = JaxConfig(width=32, height=24, max_bounces=2, use_bvh=True,
                    ray_chunk=768, tile_h=8, tile_w=128)
CFG = RenderConfig(width=32, height=24, max_bounces=2, use_bvh=True)
STEPS, LR = 3, 4.0


@functools.lru_cache(maxsize=None)
def _setup():
    """tests/test_inverse_kernel.py's first fit: the JAX scene, camera,
    light, reference tree, SplitScene and initial parameters, and the
    port's objects."""
    b = SceneBuilder()
    b.add_sphere((0.2, -0.1, -5.0), 1.0,
                 Material(color=(0.9, 0.2, 0.1), fresnel=0, specular=0.2))
    b.add_wall((-20, 2, -20), 40, 40, (0, 1, 0),
               Material(color=(0.4, 0.4, 0.7), specular=0))
    scene = b.build()
    cam = cam_ops.from_euler(position=(0, 0, 0), fov_deg=60,
                             aspect=JAX_CFG.width / JAX_CFG.height)
    light = Light((0, -3, 0), (1, 1, 1), 6.0)
    bvh = linearize(build_bvh(scene, 4))
    split = pallas_split.prepare(scene, bvh)
    init = {
        "sphere_center": scene.sphere_center.at[0].set(
            jnp.array([-0.5, 0.4, -4.4], jnp.float32)),
        "mat_color": scene.mat_color.at[0].set(
            jnp.array([0.3, 0.6, 0.7], jnp.float32)),
    }
    return scene, cam, light, bvh, split, init, port(scene, split, cam,
                                                      light, bvh)


@functools.lru_cache(maxsize=None)
def _fits():
    """(JAX target, params after each step, loss history; the port's
    image of the true scene, params after each step and loss history,
    fitted to the JAX target)."""
    scene, cam, light, bvh, split, init, p = _setup()
    with interpret_unroll():
        renderer = jax_inverse.make_kernel_renderer(bvh, split)
        target = renderer(scene, cam, light, JAX_CFG)
        # fit_scene_params' SGD loop, one step at a time to see each
        # step's parameters (one loss function: one trace)
        loss_fn = jax_inverse.make_loss_fn(scene, cam, light, JAX_CFG,
                                           target, init.keys(),
                                           renderer=renderer)
        params, want_params, want_hist = dict(init), [], []
        for _ in range(STEPS):
            params, val = jax_inverse._sgd_step(loss_fn, params, LR)
            want_params.append({k: np.asarray(v) for k, v in params.items()})
            want_hist.append(float(val))

    p_renderer = diff.make_kernel_renderer(p.lin, p.split, device="cpu")
    own_target = p_renderer(p.flat, p.camera, p.light, CFG)
    params = {k: torch.from_numpy(np.array(v)) for k, v in init.items()}
    got_params, got_hist = [], []
    for _ in range(STEPS):
        params, hist = diff.fit_scene_params(
            p.flat, p.camera, p.light, CFG,
            torch.from_numpy(np.array(target)), params, steps=1, lr=LR,
            renderer=p_renderer)
        got_params.append({k: v.numpy() for k, v in params.items()})
        got_hist += hist
    return (np.asarray(target), want_params, want_hist,
            own_target.detach().numpy(), got_params, got_hist)


def test_kernel_renderer_target_matches_jax():
    """The port's make_kernel_renderer image of the true scene equals the
    JAX one within atol 1e-4 (a sphere over a wall at 32x24)."""
    target, _, _, own, _, _ = _fits()
    assert own.shape == (24, 32, 3)
    np.testing.assert_allclose(own, target, rtol=0, atol=1e-4)


def test_fit_steps_match_jax():
    """Loss history and the parameters after each of the first 3 SGD
    steps (lr 4.0) equal the JAX fit's: the losses within rtol 1e-4 and
    the parameters within atol 1e-5; and the loss falls."""
    _, want_params, want_hist, _, got_params, got_hist = _fits()
    np.testing.assert_allclose(got_hist, want_hist, rtol=1e-4)
    assert got_hist[-1] < got_hist[0]
    for step, (g, w) in enumerate(zip(got_params, want_params)):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-5,
                                       err_msg=f"{k} after step {step + 1}")


def test_fit_with_an_optimizer_factory():
    """``optimizer`` takes a torch.optim factory (in place of optax's
    transformations): with plain SGD at the same rate it takes the steps
    of the default loop."""
    target, _, _, _, got_params, got_hist = _fits()
    _, _, _, _, _, init, p = _setup()
    params, hist = diff.fit_scene_params(
        p.flat, p.camera, p.light, CFG, torch.from_numpy(np.array(target)),
        {k: torch.from_numpy(np.array(v)) for k, v in init.items()},
        steps=2, optimizer=lambda ps: torch.optim.SGD(ps, lr=LR),
        renderer=diff.make_kernel_renderer(p.lin, p.split, device="cpu"))
    np.testing.assert_allclose(hist, got_hist[:2], rtol=1e-6)
    for k, v in params.items():
        np.testing.assert_allclose(v.numpy(), got_params[1][k], rtol=0,
                                   atol=1e-6)
