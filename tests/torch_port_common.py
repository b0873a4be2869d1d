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

import functools

import jax
import jax.numpy as jnp
import numpy as np

from raytracer_tpu.accel import build_bvh, linearize
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


@functools.lru_cache(maxsize=None)
def ported(which: int):
    """The JAX package's scene, tables, camera and light as the port's
    objects on the CPU."""
    sc, _, split = jax_scene(which)
    return interop.from_numpy(
        flat={f: np.asarray(getattr(sc.flat, f))
              for f in sc.flat.__dataclass_fields__},
        split_args=[np.asarray(a) for a in split.device_args()],
        m=split.m, n_other=split.n_other, n_sph=split.n_sph,
        rid_values=split.rid_values,
        attr_tab=np.asarray(whitted._attr_table(sc.flat)),
        camera=camera_numpy(sc.camera), light=light_numpy(sc.light),
        device="cpu")


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
