"""Shading math (port of ``raytracer_tpu/render/shading.py``; reference
gpu_shader.comp:331-361, 436, 491, 501-506).

``background``, ``phong`` and ``fresnel_weight`` are the per-bounce
route's shading (render/whitted.py::trace), in the JAX functions' order
of operations. The whole-frame kernel and its plain version
(render/wholeframe.py) inline the same terms. Both use ``viewDir =
ray.dir`` (pointing away from the viewer) in the specular term, a
reference quirk kept to match images.
"""

from __future__ import annotations

import functools

import torch

from raytracer_tpu_torch.geom.direct import reflect, sqrt_rn

BG_DARK = (0.05, 0.07, 0.1)
BG_SKY = (0.5, 0.7, 1.0)

# Shadowed surfaces are darkened x0.3, not black (gpu_shader.comp:491,591).
SHADOW_FACTOR = 0.3


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis of size 3, added left to right."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def background(ndc_like_y: torch.Tensor) -> torch.Tensor:
    """Vertical gradient mix(dark, skyblue, y/H) (gpu_shader.comp:436).
    ``ndc_like_y`` is texel_y / H in [0, 1); returns (..., 3)."""
    f = ndc_like_y.to(torch.float32)
    a, b = _bg_colors(f.device)
    return a + (b - a) * f[..., None]


@functools.lru_cache(maxsize=None)
def _bg_colors(device: torch.device):
    """The two background colours on ``device``, made once (a host-to-
    device copy per frame would wait for the card)."""
    return (torch.tensor(BG_DARK, dtype=torch.float32, device=device),
            torch.tensor(BG_SKY, dtype=torch.float32, device=device))


def phong(point, normal, view_dir, light_pos, light_color, mat_color,
          ambient_k, diffuse_k, specular_k, shininess,
          attenuate: bool = True) -> torch.Tensor:
    """Phong without Blinn (gpu_shader.comp:331-361). ``attenuate`` is the
    GPU variant, lightColor / distance (1/d, not 1/d^2). Vectors are
    (..., 3), coefficients (...,)."""
    to_light = light_pos - point
    dist = sqrt_rn(torch.clamp_min(_dot(to_light, to_light), 1e-30))
    lc = light_color / dist[..., None] if attenuate else \
        torch.broadcast_to(light_color, point.shape[:-1] + (3,))
    ambient = ambient_k[..., None] * lc
    light_dir = to_light / dist[..., None]
    diff = torch.clamp_min(_dot(normal, light_dir), 0.0)
    diffuse = (diffuse_k * diff)[..., None] * lc
    # specular only where diff > 0 (gpu_shader.comp:352)
    reflect_dir = reflect(-light_dir, normal)
    spec_cos = torch.clamp_min(_dot(view_dir, reflect_dir), 0.0)
    spec = torch.pow(spec_cos, shininess)
    specular = torch.where(diff > 0, specular_k * spec, 0.0)[..., None] * lc
    return (ambient + diffuse + specular) * mat_color


def fresnel_weight(new_dir, normal, fresnel_strength) -> torch.Tensor:
    """Schlick-style factor of the REFLECTED direction
    (gpu_shader.comp:501-506): clamp((1 - max(dot(-newDir, n), 0))^5, 0,
    0.8), scaled by the material's fresnelStrength."""
    cos = torch.clamp_min(_dot(-new_dir, normal), 0.0)
    x1 = 1.0 - cos
    x2 = x1 * x1
    f = torch.clamp(x1 * (x2 * x2), 0.0, 0.8)   # integer_pow(x, 5)
    return fresnel_strength * f
