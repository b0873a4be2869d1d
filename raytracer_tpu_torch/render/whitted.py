"""The Whitted bounce loop over a wavefront of rays (port of
``raytracer_tpu/render/whitted.py``; reference gpu_shader.comp:446-620),
plus the parked-ray constants, the packed shading-attribute table and the
bounce-sort key that the whole-frame hybrid shares.

``trace`` is the JAX function's bounce loop, shared by the renderers: per
bounce one closest-hit query, the shading attributes of the hits, the
shadow answer, then Phong, shadows and the reflection as tensor ops. The
per-bounce route of ``render()`` passes ``fused_fn`` (closest hit and
shadow in one launch of ``fused_kernel``) and ``resolve_fn`` (a launch of
``resolve_kernel``); with ``split.USE_KERNEL_ATTRS`` it passes a closest
hit that provides the attributes (``closest_attrs_kernel``) and neither;
the differentiable route and the packet, brute-force and wavefront
renderers pass neither, and take the JAX function's row gather and
closest-hit shadow ray (or, for the packet renderer's any-hit variant,
``occlusion_fn``).

Quirks preserved (the JAX module's checklist): a miss adds attenuation x
background and ends the ray; shadows darken x0.3; reflection only where
specularStrength > 0, with attenuation *= specularStrength, or, with
Fresnel, mix(hitColor, 1, w) plus the reference's extra, unattenuated
(1-w)*hitColor*phongColor term; ``viewDir`` is ray.dir.
"""

from __future__ import annotations

import functools

import torch

from raytracer_tpu_torch.core.scene import SPHERE, FlatScene
from raytracer_tpu_torch.core.types import normalize
from raytracer_tpu_torch.geom.direct import reflect, sqrt_rn
from raytracer_tpu_torch.render import shading

# Terminated lanes are parked on a ray that misses every box and shape at
# the first test (origin far beyond the scene, pointing away).
PARK_ORIGIN = 2e30
_PARK_DIR = 0.5773502691896258  # 1/sqrt(3): unit, no zero components

ATTR_W = 15  # columns of _attr_table


def _attr_table(scene: FlatScene) -> torch.Tensor:
    """Packed (N, 15) shading-attribute table, one row per shape:
    [n(3), color(3), ka, kd, ks, kf, shininess, center(3), is_sphere]."""
    return torch.cat([
        scene.plane_normal,
        scene.mat_color,
        scene.mat_ambient[:, None],
        scene.mat_diffuse[:, None],
        scene.mat_specular[:, None],
        scene.mat_fresnel[:, None],
        scene.mat_shininess[:, None],
        scene.sphere_center,
        (scene.shape_type == SPHERE).to(torch.float32)[:, None],
    ], dim=1).contiguous()


# Bit i of a 7-bit value moved to bit 3i: the Morton interleave of one
# axis as a 128-entry table.
_SPREAD7 = tuple(sum(((v >> b) & 1) << (3 * b) for b in range(7))
                 for v in range(128))


@functools.lru_cache(maxsize=None)
def _key_tables(device: torch.device):
    """The key's constant tensors on ``device``, made once (a host-to-
    device copy per frame would cost more than the key's arithmetic)."""
    return (torch.tensor([4, 2, 1], dtype=torch.int32, device=device),
            torch.tensor(_SPREAD7, dtype=torch.int32, device=device))


def _bounce_sort_key(o: torch.Tensor, d: torch.Tensor,
                     live: torch.Tensor) -> torch.Tensor:
    """int32 coherence key for re-sorting a bounce wave: the direction
    octant (3 bits) over a 7-bit-per-axis Morton code of the origin,
    quantised to the live rays' bounding box; parked rays get 1 << 30 and
    sort last. 24 bits. With no live ray the box is [0, 1]. (The JAX
    function ORs the 21 bits in one at a time; a table lookup per axis
    gives the same bits in fewer tensor ops.)"""
    weights, spread = _key_tables(o.device)
    octant = ((d > 0).to(torch.int32) * weights).sum(1, dtype=torch.int32)
    lv = live[:, None]
    # nanmin / nanmax over the live rows, NaN where a column has none
    none = ~live.any()
    lo = torch.where(lv, o, torch.inf).amin(0)
    hi = torch.where(lv, o, -torch.inf).amax(0)
    lo = torch.nan_to_num(torch.where(none, torch.nan, lo), nan=0.0)
    hi = torch.nan_to_num(torch.where(none, torch.nan, hi), nan=1.0)
    span = torch.clamp_min(hi - lo, 1e-6)
    q = torch.clamp((o - lo) / span * 127.0, 0.0, 127.0).to(torch.int64)
    # the three axes' bits are disjoint, so the weighted sum is their OR
    m = (spread[q] * weights).sum(1, dtype=torch.int32)
    key = (octant << 21) | m
    return torch.where(live, key, torch.full_like(key, 1 << 30))


def _where3(mask, a, b):
    return torch.where(mask[:, None], a, b)


def trace(scene: FlatScene, light, closest_hit_fn, o: torch.Tensor,
          d: torch.Tensor, bg: torch.Tensor, cfg, occlusion_fn=None,
          fused_fn=None, resolve_fn=None) -> torch.Tensor:
    """Trace R rays to completion. o, d, bg: (R, 3). Returns (R, 3).

    closest_hit_fn(o, d) -> (t, sid, hit); or, where it has
    ``provides_attrs`` set, -> (t, sid, hit, (n, color, ka, kd, ks, kf,
    shininess)), the shading attributes of the hits, and its ``.base``
    (if any) answers the shadow rays. occlusion_fn(o, d, max_t) -> bool:
    an any-hit shadow query (occluded iff some inner hit is closer than
    the light) in place of the closest-hit shadow ray. fused_fn(o, d,
    light_pos) -> (t, sid, hit, in_shadow): closest hit and shadow answer
    in one launch; takes precedence over both. resolve_fn(attr_tab, gid,
    p) -> (n, color, ka, kd, ks, kf, shininess): the shading attributes of
    the hits, in place of the row gather attr_tab[sid] with the sphere
    normal from the hit point. (The JAX function's ``DEBUG_CONST_SHADE``
    branch has no counterpart.)

    With cfg.sort_bounces the rays are re-packed once after bounce 1 by
    the bounce-sort key (a stable sort plus gathers, where the JAX package
    carries every column through one multi-operand sort: per-ray results
    do not depend on the order, so the image is the same); a miss records
    a bit and the background is composited once, at the end, in the
    original order."""
    light_pos, light_color = light.position, light.color
    shadow_eps, reflect_eps = cfg.shadow_eps, cfg.reflect_eps
    n_rays = o.shape[0]
    dev = o.device
    accum = torch.zeros_like(o)
    atten = torch.ones_like(o)
    alive = torch.ones(n_rays, dtype=torch.bool, device=dev)
    missed = torch.zeros(n_rays, dtype=torch.bool, device=dev)
    ret = torch.arange(n_rays, device=dev)
    attr_tab = _attr_table(scene)
    use_fused = fused_fn is not None and cfg.enable_shadows
    provides_attrs = getattr(closest_hit_fn, "provides_attrs", False)
    # shadow rays need no attributes: the plain closest hit where the
    # attribute variant has one
    shadow_fn = getattr(closest_hit_fn, "base", closest_hit_fn)

    for i in range(cfg.max_bounces):
        if use_fused:
            t, sid, hit, in_shadow = fused_fn(o, d, light_pos)
        elif provides_attrs:
            t, sid, hit, attrs = closest_hit_fn(o, d)
        else:
            t, sid, hit = closest_hit_fn(o, d)

        # miss: attenuated background, and the ray ends (comp:454-458)
        miss_now = alive & ~hit
        if cfg.sort_bounces:
            missed = missed | miss_now
        else:
            accum = accum + _where3(miss_now, atten * bg, 0.0)
        live = alive & hit

        p = o + t[:, None] * d
        if provides_attrs:
            n, mat_color, k_a, k_d, k_s, k_f, shin = attrs
        elif resolve_fn is not None:
            n, mat_color, k_a, k_d, k_s, k_f, shin = resolve_fn(
                attr_tab, sid.to(torch.float32), p)
        else:
            # one row gather; index_select's backward adds the rows' grads
            # with index_add_ (an index's backward sorts the indices, and
            # serialises the long runs of one id: most rays hit one shape)
            row = attr_tab.index_select(0, sid.long())
            mat_color = row[:, 3:6]
            k_a, k_d, k_s, k_f, shin = row[:, 6:11].unbind(1)
            # plane family from the table; spheres from the hit point
            # (1 / a correctly rounded root where JAX takes lax.rsqrt)
            rel = p - row[:, 11:14]
            inv = 1.0 / sqrt_rn(shading._dot(rel, rel)[:, None] + 1e-30)
            is_sph = row[:, 14:15]
            n = is_sph * (rel * inv) + (1.0 - is_sph) * row[:, 0:3]

        # shadow ray (comp:466-480 / 562-580), unless fused_fn answered it
        if not use_fused and cfg.enable_shadows:
            s_o = (p + n * shadow_eps).contiguous()
            s_d = normalize(light_pos - p, eps=1e-30).contiguous()
            light_dist = torch.linalg.vector_norm(light_pos - p, dim=-1)
            if occlusion_fn is not None:
                in_shadow = occlusion_fn(s_o, s_d, light_dist)
            else:
                s_t, _, s_hit = shadow_fn(s_o, s_d)[:3]
                in_shadow = s_hit & (s_t < light_dist)
        elif not use_fused:
            in_shadow = torch.zeros_like(hit)

        color = shading.phong(p, n, d, light_pos, light_color, mat_color,
                              k_a, k_d, k_s, shin, attenuate=True)
        color = _where3(in_shadow, color * shading.SHADOW_FACTOR, color)
        accum = accum + _where3(live, atten * color, 0.0)

        # reflection (comp:495-516)
        new_d = reflect(d, n)
        new_o = p + n * reflect_eps
        cont = live & (k_s > 0)
        if cfg.use_fresnel:
            w = shading.fresnel_weight(new_d, n, k_f)
            new_atten = atten * (mat_color + (1.0 - mat_color) * w[:, None])
            # the extra term is NOT attenuated (reference double-count)
            extra = (1.0 - w)[:, None] * mat_color * color
            accum = accum + _where3(cont, extra, 0.0)
        else:
            new_atten = atten * k_s[:, None]
        atten = _where3(cont, new_atten, atten)
        o = _where3(cont, new_o, torch.full_like(o, PARK_ORIGIN)).contiguous()
        d = _where3(cont, new_d, torch.full_like(d, _PARK_DIR)).contiguous()
        alive = cont

        if cfg.sort_bounces and i == 0 and cfg.max_bounces > 1:
            # re-pack the next bounce's rays into coherent runs (parked
            # rays last), once: later bounces inherit the order (the JAX
            # default, SORT_EVERY_BOUNCE=False); liveness is recomputed
            # from the park sentinel
            _, perm = torch.sort(_bounce_sort_key(o, d, alive), stable=True)
            o, d, atten, accum = (x[perm] for x in (o, d, atten, accum))
            missed, ret = missed[perm], ret[perm]
            alive = o[:, 0] < 1e30

    if cfg.sort_bounces:
        # un-sort (ret is a permutation), then the deferred background
        # composite in the original order
        accum = torch.empty_like(accum).index_copy_(0, ret, accum)
        atten = torch.empty_like(atten).index_copy_(0, ret, atten)
        missed = torch.empty_like(missed).index_copy_(0, ret, missed)
        accum = accum + _where3(missed, atten * bg, 0.0)
    return accum
