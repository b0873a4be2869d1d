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
from raytracer_tpu.core import camera as cam_ops
from raytracer_tpu.core.scene import SceneBuilder
from raytracer_tpu.core.types import Light, Material
from raytracer_tpu.render import split_scene, whitted
from raytracer_tpu.scenes import generate_scene
from raytracer_tpu_torch import interop

CAMERA_FIELDS = ("position", "front", "up", "right", "fov_deg", "aspect")


@functools.lru_cache(maxsize=None)
def jax_scene(which: int):
    """(Scene, reference LinearBVH, SplitScene) of the JAX package."""
    sc = generate_scene(which)
    lin = linearize(build_bvh(sc.flat, sc.bvh_max_depth))
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


def port(flat, split, camera, light):
    """A JAX FlatScene, its SplitScene, camera and light as the port's
    objects on the CPU."""
    return interop.from_numpy(
        flat={f: np.asarray(getattr(flat, f))
              for f in flat.__dataclass_fields__},
        split_args=[np.asarray(a) for a in split.device_args()],
        m=split.m, n_other=split.n_other, n_sph=split.n_sph,
        rid_values=split.rid_values,
        attr_tab=np.asarray(whitted._attr_table(flat)),
        camera=camera_numpy(camera), light=light_numpy(light),
        device="cpu")


@functools.lru_cache(maxsize=None)
def ported(which: int):
    """The JAX package's scene, tables, camera and light as the port's
    objects on the CPU."""
    sc, _, split = jax_scene(which)
    return port(sc.flat, split, sc.camera, sc.light)


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
