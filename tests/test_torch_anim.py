"""The port's animation, device AABB centres, LBVH, cull flags, grow-refit,
material refresh and scene subsetting against the JAX package, on the
same inputs carried across as numpy arrays."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu import anim as jax_anim
from raytracer_tpu.accel import build_bvh as jax_build_bvh
from raytracer_tpu.accel import lbvh as jax_lbvh
from raytracer_tpu.accel.bvh import refit_grow as jax_refit_grow
from raytracer_tpu.core import scene as jax_scene_mod
from raytracer_tpu.core.types import Material as JaxMaterial
from raytracer_tpu.geom import aabb as jax_aabb
from raytracer_tpu.geom.direct import wall_basis as jax_wall_basis
from raytracer_tpu.render import split_scene as jax_split_scene
from raytracer_tpu_torch import anim, interop
from raytracer_tpu_torch.accel import build_bvh, lbvh, refit_grow
from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.core import scene as scene_mod
from raytracer_tpu_torch.core.types import Material
from raytracer_tpu_torch.geom import aabb
from raytracer_tpu_torch.geom.direct import wall_basis
from raytracer_tpu_torch.render import split, split_scene

from torch_port_common import (jax_scene_bvh, lin_numpy, op_by_op, port,
                               ported_bvh, small_scene, typed_scene)

LIN_FIELDS = ("bounds", "leaf_start", "leaf_count", "skip", "perm")
FLAT_FIELDS = scene_mod._FIELDS


def _port_flat(flat):
    """A JAX FlatScene as the port's, on the CPU."""
    return interop.from_numpy(flat={f: np.asarray(getattr(flat, f))
                                    for f in FLAT_FIELDS},
                              device="cpu").flat


def _flat_equal(port_flat, jax_flat):
    for f in FLAT_FIELDS:
        assert np.array_equal(getattr(port_flat, f).numpy(),
                              np.asarray(getattr(jax_flat, f))), f


def test_bounce_spheres_match_jax():
    """Scene 1's three bouncing spheres at several t against the jitted
    JAX transform: the y of a bounced centre within 4e-6 (XLA's sin and
    its fused multiply-add differ from PyTorch's by ulps; 1.9e-6 at most
    over 51 t in [0, 5] on this CPU), every other value bit-equal."""
    sc, _ = jax_scene_bvh(1)
    p = ported_bvh(1)
    params = tuple(sc.bounce_params)
    jitted = jax.jit(lambda fl, t: jax_anim.bounce_spheres(fl, params, t))
    idx = [i for i, _, _ in params]
    others = np.setdiff1d(np.arange(sc.num_shapes), idx)
    dev_params = anim.animation.device_bounce(params, "cpu")
    for t in (0.0, 0.37, 1.7, 4.9):
        want = np.asarray(jitted(sc.flat, t).sphere_center)
        for given in (params, dev_params):
            got = anim.bounce_spheres(p.flat, given, t).sphere_center.numpy()
            np.testing.assert_allclose(got[idx, 1], want[idx, 1], rtol=0,
                                       atol=4e-6)
            assert np.array_equal(got[idx][:, ::2], want[idx][:, ::2])
            assert np.array_equal(got[others], want[others])
    moved = anim.bounce_spheres(p.flat, params, 0.8)
    assert (moved.sphere_center - p.flat.sphere_center).abs().max() > 1e-3
    assert anim.animate_scene(sc, p.flat, 0.8, 1 / 30).sphere_center.equal(
        moved.sphere_center)


def test_rotate_wheels_match_jax():
    """Scene 2's four wheels over 3 chained frames of 1/30 s against the
    jitted JAX transform. The vertices agree within 1e-6 (4.8e-7 measured:
    XLA's cos / sin and its matmul against PyTorch's, each rounded op at a
    time). The stale-plane quirk: plane_normal and plane_d are the input's
    bit for bit. With refresh_planes the recomputed planes agree within
    4e-6 (normal) and 2e-5 (d; 1.2e-6 and 9.2e-6 measured)."""
    sc, _ = jax_scene_bvh(2)
    p = ported_bvh(2)
    dt = 1 / 30
    for refresh in (False, True):
        step = jax.jit(lambda fl: jax_anim.rotate_wheels(
            fl, sc.wheels, dt, refresh_planes=refresh))
        fj, ft = sc.flat, p.flat
        for _ in range(3):
            fj = step(fj)
            ft = anim.rotate_wheels(ft, sc.wheels, dt,
                                    refresh_planes=refresh)
        for f in ("tri_p1", "tri_p2", "tri_p3"):
            np.testing.assert_allclose(getattr(ft, f).numpy(),
                                       np.asarray(getattr(fj, f)), rtol=0,
                                       atol=1e-6, err_msg=f)
        if refresh:
            np.testing.assert_allclose(ft.plane_normal.numpy(),
                                       np.asarray(fj.plane_normal), rtol=0,
                                       atol=4e-6)
            np.testing.assert_allclose(ft.plane_d.numpy(),
                                       np.asarray(fj.plane_d), rtol=0,
                                       atol=2e-5)
        else:
            assert torch.equal(ft.plane_normal, p.flat.plane_normal)
            assert torch.equal(ft.plane_d, p.flat.plane_d)
    idx = np.asarray(sc.wheels[0]["indices"])
    assert (ft.tri_p1[idx] - p.flat.tri_p1[idx]).abs().max() > 1e-3
    body = np.arange(2000)   # the car body does not move
    assert torch.equal(ft.tri_p1[body], p.flat.tri_p1[body])


def test_shape_centers_device_match_jax():
    """Every shape type. XLA rewrites the jitted triangle centre's division
    by 3 into a product with 1/3; the port divides, as the JAX function
    does evaluated one operation at a time, and equals that value bit for
    bit."""
    (flat_t, _, _), p_t = typed_scene()
    cases = [(jax_scene_bvh(1)[0].flat, ported_bvh(1).flat),
             (jax_scene_bvh(2)[0].flat, ported_bvh(2).flat),
             (flat_t, p_t.flat)]
    for flat_j, flat_p in cases:
        got = aabb.shape_centers_device(flat_p).numpy()
        assert np.array_equal(got, op_by_op(jax_aabb.shape_centers_jnp,
                                            flat_j))
        jitted = np.asarray(jax.jit(jax_aabb.shape_centers_jnp)(flat_j))
        st = np.asarray(flat_j.shape_type)
        # only the triangle centres move under the rewrite, by an ulp
        assert np.array_equal(got[st != 3], jitted[st != 3])
        np.testing.assert_allclose(got, jitted, rtol=1e-6, atol=0)


def _cloud_inputs(n=37, seed=0):
    """A sphere cloud in which groups of shapes share a centre (equal
    Morton codes): the tree then depends on the sort's stability and on
    delta's tie-break by sorted position."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    c[5:12] = c[4]
    c[20:23] = c[19]
    c[30:32] = c[0]
    r = rng.uniform(0.3, 1.0, (n, 1)).astype(np.float32)
    return c - r, c + r, c


def _lbvh_inputs(which):
    if which == "cloud":
        return _cloud_inputs()
    flat = jax_scene_bvh(which)[0].flat
    mins, maxs = jax.jit(jax_aabb.shape_aabbs_jnp)(flat)
    cen = jax.jit(jax_aabb.shape_centers_jnp)(flat)
    return tuple(np.array(x) for x in (mins, maxs, cen))


def _lbvh_equal(mins, maxs, cen):
    want = lin_numpy(jax_lbvh.build_lbvh(*(jnp.asarray(x)
                                           for x in (mins, maxs, cen))))
    got = lbvh.build_lbvh(*(torch.from_numpy(x) for x in (mins, maxs, cen)))
    for f in LIN_FIELDS:
        w = torch.from_numpy(np.array(want[f]))
        assert torch.equal(getattr(got, f), w), f
    return got


@pytest.mark.parametrize("which", [1, 2, "cloud"])
def test_build_lbvh_matches_jax(which):
    """All five tables equal to the jitted JAX build from the same numpy
    inputs: scenes 1 and 2 (2479 and 8243 nodes; scene 2 has 28
    duplicated Morton codes) and a 37-sphere cloud with shared centres;
    with the cloud, also its first one and two shapes (n = 1 returns the
    single-node tree)."""
    mins, maxs, cen = _lbvh_inputs(which)
    got = _lbvh_equal(mins, maxs, cen)
    n = cen.shape[0]
    assert got.num_nodes == 2 * n - 1
    codes = lbvh.morton_codes(torch.from_numpy(cen),
                              torch.from_numpy(mins).amin(0),
                              torch.from_numpy(maxs).amax(0))
    if which == "cloud":
        assert codes.unique().numel() < n   # the ties are there
        for k in (1, 2):
            _lbvh_equal(mins[:k], maxs[:k], cen[:k])
    # the sparse table's level: JAX's f32 floor(log2(span)) is the exact
    # integer one for every span the scenes' trees can have
    span = torch.arange(1, 2 * 4122 + 1)
    assert torch.equal(
        torch.floor(torch.log2(span.to(torch.float32))).to(torch.int64),
        torch.tensor([int(s).bit_length() - 1 for s in span]))


def test_node_cullable_flags_device_match_jax():
    """Scene 1's LBVH: every node but those over the degenerate floor wall
    (the root among them) may be culled."""
    mins, maxs, cen = _lbvh_inputs(1)
    flat = jax_scene_bvh(1)[0].flat
    lin_j = jax_lbvh.build_lbvh(*(jnp.asarray(x) for x in (mins, maxs, cen)))
    _, _, wdeg = jax_wall_basis(flat.plane_normal)
    want = np.array(jax_lbvh.node_cullable_flags_device(
        lin_j, wdeg & (flat.shape_type == jax_scene_mod.WALL)))
    p = ported_bvh(1)
    lin_t = lbvh.build_lbvh(*(torch.from_numpy(x) for x in (mins, maxs, cen)))
    _, _, wdeg_t = wall_basis(p.flat.plane_normal)
    got = lbvh.node_cullable_flags_device(
        lin_t, wdeg_t & (p.flat.shape_type == scene_mod.WALL))
    assert torch.equal(got, torch.from_numpy(want))
    assert got[0] == 0 and 0 < int((got == 0).sum()) < got.numel() // 10


def test_refit_grow_matches_jax():
    """Grow-only refit of scene 1's median tree after a bounce, from the
    same bounced scene (JAX's, carried across): equal node boxes."""
    sc, _ = jax_scene_bvh(1)
    bounced = jax_anim.bounce_spheres(sc.flat, tuple(sc.bounce_params), 1.3)
    want = jax_refit_grow(jax_build_bvh(sc.flat, sc.bvh_max_depth), bounced)
    got = refit_grow(build_bvh(ported_bvh(1).flat, sc.bvh_max_depth),
                     _port_flat(bounced))
    assert np.array_equal(got.bounds_min, want.bounds_min)
    assert np.array_equal(got.bounds_max, want.bounds_max)
    before = build_bvh(ported_bvh(1).flat, sc.bvh_max_depth)
    assert not (np.array_equal(got.bounds_min, before.bounds_min)
                and np.array_equal(got.bounds_max, before.bounds_max))


def _edited_scene(builder_cls, material_cls, **build_kw):
    """A copy of ``torch_port_common.small_scene``'s shapes (the triangle
    and the wall share the default material, one resolve group), with the
    triangle's material edited through ``set_material``."""
    b = builder_cls()
    b.add_sphere((0, -0.6, -4), 0.7, material_cls(color=(0.9, 0.2, 0.2),
                 specular=0.6, fresnel=0.5))
    b.add_sphere((1.2, 0.5, -6), 0.8, material_cls(color=(0.2, 0.9, 0.3)))
    b.add_triangle((-2.5, -1, -5), (-0.5, -1, -5), (-1.5, 1.2, -5))
    b.add_wall((-20, 2, -20), 40, 40, (0, 1, 0))
    b.set_material(2, material_cls(color=(0.4, 0.4, 0.9), diffuse=0.05,
                                   ambient=0.9))
    return b.build(**build_kw)


def test_update_materials_after_set_material():
    """A material edit (SceneBuilder.set_material) refreshed into prepared
    tables: both row tables and rid_values equal JAX's update_materials;
    the frame over the refreshed tables is a fresh prepare's."""
    (_, lin_j, split_j, cam_j, light_j), _ = small_scene()
    edited_j = _edited_scene(jax_scene_mod.SceneBuilder, JaxMaterial)
    edited_t = _edited_scene(scene_mod.SceneBuilder, Material, device="cpu")
    _flat_equal(edited_t, edited_j)
    want = jax_split_scene.update_materials(split_j, edited_j)
    p = port(edited_j, split_j, cam_j, light_j, lin_j)
    got = split_scene.update_materials(p.split, p.flat)
    assert got.rid_values == want.rid_values != split_j.rid_values
    for name in ("pre_rows", "tri_rows"):
        assert torch.equal(getattr(got, name),
                           torch.from_numpy(np.array(getattr(want, name))))
    cfg = RenderConfig(width=24, height=18, max_bounces=2)
    img = split.render(p.flat, p.lin, p.camera, p.light, cfg, split=got,
                       device="cpu")
    fresh = split.render(p.flat, p.lin, p.camera, p.light, cfg,
                         device="cpu")
    torch.testing.assert_close(img, fresh, rtol=0, atol=2e-5)


def test_take_and_pad_to_match_jax():
    sc, _ = jax_scene_bvh(2)
    p = ported_bvh(2)
    idx = np.r_[np.arange(4000, 4122, 3), 7, 2100, 7]
    _flat_equal(p.flat.take(idx), sc.flat.take(idx))
    _flat_equal(p.flat.take(torch.from_numpy(idx)), sc.flat.take(idx))
    sub_j, sub_t = sc.flat.take(idx[:5]), p.flat.take(idx[:5])
    for pad_type in (scene_mod.SPHERE, scene_mod.TRIANGLE):
        _flat_equal(sub_t.pad_to(9, pad_type), sub_j.pad_to(9, pad_type))
    assert sub_t.pad_to(5) is sub_t
    with pytest.raises(ValueError):
        sub_t.pad_to(4)
