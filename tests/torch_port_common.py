"""Shared set-up of the tests that hold the PyTorch port against the JAX
package: the JAX side's scenes and tables, carried across with
``raytracer_tpu_torch.interop.from_numpy``, and the comparison rule.

Why two JAX evaluations: XLA on the CPU contracts multiply-adds into fused
multiply-adds inside jitted code. The port's plain versions (and its CUDA
kernels, built with -fmad=false) round every operation separately. Both
are the same formula, but where the formula is ill-conditioned — a
sphere's discriminant b^2 - 4ac near a tangent hit cancels — the jitted
value moves by much more than the tolerance. ``held`` therefore holds the
port against the jitted JAX value, and, only where that value differs from
the same JAX function evaluated one operation at a time
(``jax.disable_jit()``), against the op-by-op value.
"""

from __future__ import annotations

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np

from raytracer_tpu.accel import build_bvh, linearize
from raytracer_tpu.accel.linearize import shape_leaf_boxes
from raytracer_tpu.core import camera as cam_ops
from raytracer_tpu.core.scene import SceneBuilder
from raytracer_tpu.core.types import Light, Material
from raytracer_tpu.render import split_scene, whitted
from raytracer_tpu.render.reference import render as render_ref
from raytracer_tpu.scenes import generate_scene
from raytracer_tpu_torch import interop
from raytracer_tpu_torch.render.split_scene import REFIT_FIELDS

CAMERA_FIELDS = ("position", "front", "up", "right", "fov_deg", "aspect")


@functools.lru_cache(maxsize=None)
def jax_scene_bvh(which: int):
    """(Scene, reference LinearBVH) of the JAX package: what the packet,
    brute-force and wavefront renderers take (the split tables, seconds of
    host prep, are not built)."""
    sc = generate_scene(which)
    return sc, linearize(build_bvh(sc.flat, sc.bvh_max_depth))


@functools.lru_cache(maxsize=None)
def jax_scene(which: int):
    """(Scene, reference LinearBVH, SplitScene) of the JAX package."""
    sc, lin = jax_scene_bvh(which)
    return sc, lin, split_scene.prepare(sc.flat, lin)


def camera_numpy(cam) -> dict:
    out = {f: np.asarray(getattr(cam, f)) for f in CAMERA_FIELDS}
    # the image plane's half height as the JAX package derives it (its f32
    # tan(30 deg) is one ulp above PyTorch's), so both trace the same rays
    out["half_h"] = np.asarray(jnp.tan(jnp.deg2rad(cam.fov_deg / 2.0)))
    return out


def light_numpy(light) -> dict:
    return {f: np.asarray(getattr(light, f))
            for f in ("position", "base_color", "intensity")}


def lin_numpy(lin) -> dict:
    return {f: np.asarray(getattr(lin, f))
            for f in ("bounds", "leaf_start", "leaf_count", "skip", "perm")}


def refit_numpy(split) -> dict:
    """The JAX SplitScene's refit metadata, for ``interop.from_numpy``."""
    return {f: np.asarray(getattr(split, f)) for f in REFIT_FIELDS}


def port(flat, split, camera, light, lin=None):
    """A JAX FlatScene, its SplitScene (or None), camera and light (and
    reference LinearBVH) as the port's objects on the CPU."""
    return interop.from_numpy(
        flat={f: np.asarray(getattr(flat, f))
              for f in flat.__dataclass_fields__},
        split_args=None if split is None else
        [np.asarray(a) for a in split.device_args()],
        **({} if split is None else dict(
            m=split.m, n_other=split.n_other, n_sph=split.n_sph,
            rid_values=split.rid_values, refit=refit_numpy(split))),
        attr_tab=np.asarray(whitted._attr_table(flat)),
        camera=camera_numpy(camera), light=light_numpy(light),
        lin=None if lin is None else lin_numpy(lin), device="cpu")


@functools.lru_cache(maxsize=None)
def ported(which: int):
    """The JAX package's scene, tables, camera and light as the port's
    objects on the CPU."""
    sc, _, split = jax_scene(which)
    return port(sc.flat, split, sc.camera, sc.light)


@functools.lru_cache(maxsize=None)
def ported_bvh(which: int):
    """The JAX package's scene, reference tree, camera and light as the
    port's objects on the CPU (no split tables)."""
    sc, lin = jax_scene_bvh(which)
    return port(sc.flat, None, sc.camera, sc.light, lin)


def query_rays(sc, n: int = 512, seed: int = 0):
    """n seeded f32 rays at a JAX scene: half from random points in random
    directions, half primary rays through random pixels of a 24x18 frame;
    then a tenth parked, 8 with a NaN component and 8 with a zero
    direction (the shadow rays of lanes that ended: their distance to the
    light overflows, so the normalised direction is 0)."""
    rng = np.random.default_rng(seed)
    half = n // 2
    o = rng.uniform(-10.0, 10.0, (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    co, cd = (np.asarray(x).reshape(-1, 3)
              for x in cam_ops.camera_rays(sc.camera, 24, 18))
    pix = rng.integers(0, 24 * 18, n - half)
    o[half:], d[half:] = co[pix], cd[pix]
    o, d = o.astype(np.float32), d.astype(np.float32)
    parked = rng.permutation(n)[:n // 10]
    o[parked], d[parked] = whitted.PARK_ORIGIN, whitted._PARK_DIR
    o[parked[:8], 1] = np.nan
    o[parked[8:16]] = rng.uniform(-2e30, 2e30, (8, 3))
    d[parked[8:16]] = 0.0
    return o, d


@functools.lru_cache(maxsize=None)
def oracle_opbyop(which: int, cfg):
    """The JAX oracle's frame of scene ``which`` (``reference.render``
    with the reference tree's leaf boxes, which the JAX tests hold every
    renderer to), evaluated one operation at a time."""
    sc, lin = jax_scene_bvh(which)
    return op_by_op(render_ref, sc.flat, sc.camera, sc.light, cfg,
                    leaf_boxes=shape_leaf_boxes(lin, sc.num_shapes))


def held_lazily(port, jitted, opbyop, atol, rtol=0.0, axis=None,
                allowed=0):
    """The count of elements of ``port`` beyond tolerance through ``held``,
    with ``opbyop()`` (a callable: the op-by-op JAX value costs seconds of
    per-operation compiles) evaluated only where the jitted value alone
    leaves more than ``allowed`` elements beyond; the op-by-op value
    replaces the jitted one only where XLA's contracted FMAs moved it."""
    beyond, _ = held(port, jitted, jitted, atol, rtol, axis)
    if beyond.sum() <= allowed:
        return int(beyond.sum())
    beyond, _ = held(port, jitted, opbyop(), atol, rtol, axis)
    return int(beyond.sum())


def pixels_held(img, jitted, which: int, cfg, atol=1e-4):
    """``held_lazily`` of a port frame of scene ``which`` against a jitted
    JAX frame, pixels reduced over channels, at most 2 allowed, with the
    op-by-op JAX oracle's frame as the op-by-op value."""
    return held_lazily(img, jitted, lambda: oracle_opbyop(which, cfg), atol,
                       axis=-1, allowed=2)


@functools.lru_cache(maxsize=None)
def typed_scene():
    """A few shapes of every type (spheres, a plane, a finite and a
    degenerate-basis wall, triangles; no reference scene has a plane) with
    a camera, for the type-sorted brute-force query. Returns (flat,
    reference LinearBVH, camera) of the JAX package, and the port's."""
    b = SceneBuilder()
    b.add_sphere((0, -0.6, -4), 0.7)
    b.add_sphere((1.2, 0.5, -6), 0.8)
    b.add_plane((0, 0, -1), (0, 0, -9))
    b.add_wall((-3, -2, -7), 2, 3, (-1, 0, -1))
    b.add_wall((-20, 2, -20), 40, 40, (0, 1, 0))
    b.add_triangle((-2.5, -1, -5), (-0.5, -1, -5), (-1.5, 1.2, -5))
    b.add_triangle((1, -1, -3), (2, -1, -3.5), (1.5, 0, -3.2))
    b.add_triangle((-1, 1, -5), (0, 1, -5), (-0.5, 1, -5))   # degenerate
    flat = b.build()
    cam = cam_ops.from_euler(position=(0, 0, 0), fov_deg=60, aspect=4 / 3)
    lin = linearize(build_bvh(flat, 3))
    light = Light((0, 4, -2), (1, 1, 1), 6.0)
    return (flat, lin, cam), port(flat, None, cam, light, lin)


@functools.lru_cache(maxsize=None)
def small_scene():
    """Two spheres, a triangle and a wall with a shadow-casting layout (a
    copy of tests/test_fused_shadow.py::_small_scene): every shadow
    interaction at a fraction of scene 1's interpret-mode cost. Returns
    (flat, reference LinearBVH, SplitScene, camera, light) of the JAX
    package and the same as the port's objects."""
    b = SceneBuilder()
    b.add_sphere((0, -0.6, -4), 0.7, Material(color=(0.9, 0.2, 0.2),
                 specular=0.6, fresnel=0.5))
    b.add_sphere((1.2, 0.5, -6), 0.8, Material(color=(0.2, 0.9, 0.3)))
    b.add_triangle((-2.5, -1, -5), (-0.5, -1, -5), (-1.5, 1.2, -5))
    b.add_wall((-20, 2, -20), 40, 40, (0, 1, 0))
    flat = b.build()
    cam = cam_ops.from_euler(position=(0, 0, 0), fov_deg=60, aspect=4 / 3)
    light = Light((0, 4, -2), (1, 1, 1), 6.0)
    lin = linearize(build_bvh(flat, 8))
    split = split_scene.prepare(flat, lin)
    return (flat, lin, split, cam, light), port(flat, split, cam, light)


# The JAX package's triangle unroll for the interpret-mode kernels of the
# port's tests. TRI_UNROLL (48 by default) is a TPU speed knob, bit-exact
# at any value (pallas_split.py:91-107); the interpret-mode compile grows
# with it (the small scene's hybrid frame: ~49 s at 48, ~10 s at 8 on the
# CPU), so these tests trace the kernels at 8.
INTERPRET_TRI_UNROLL = 8


@contextlib.contextmanager
def interpret_unroll():
    """Run the JAX package's Pallas kernels at ``INTERPRET_TRI_UNROLL``,
    restoring the unroll and clearing the render cache after."""
    from raytracer_tpu.render import pallas_split
    old = pallas_split.TRI_UNROLL
    pallas_split.TRI_UNROLL = INTERPRET_TRI_UNROLL
    pallas_split._render_impl.clear_cache()
    try:
        yield
    finally:
        pallas_split.TRI_UNROLL = old
        pallas_split._render_impl.clear_cache()


def op_by_op(fn, *args, **kw):
    """``fn`` evaluated one JAX operation at a time (no XLA fusion)."""
    with jax.disable_jit():
        return jax.tree_util.tree_map(np.asarray, fn(*args, **kw))


def held(port, jitted, opbyop, atol, rtol=0.0, axis=None):
    """Compare ``port`` with the JAX values: against ``jitted`` wherever it
    agrees with ``opbyop`` within the tolerance, else against ``opbyop``.
    With ``axis``, elements are reduced by max over that axis (pixels over
    channels). Returns (the elements beyond tolerance, the count held
    against the op-by-op value)."""
    port, jitted, opbyop = (np.asarray(x, np.float64)
                            for x in (port, jitted, opbyop))

    def beyond(a, ref):
        err = np.abs(a - ref) - (atol + rtol * np.abs(ref))
        return (err if axis is None else err.max(axis)) > 0

    contracted = beyond(jitted, opbyop)
    sel = contracted if axis is None else contracted[..., None]
    ref = np.where(sel, opbyop, jitted)
    return beyond(port, ref), int(contracted.sum())
