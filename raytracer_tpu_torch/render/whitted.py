"""Parts of ``raytracer_tpu/render/whitted.py`` the one-launch frame needs:
the parked-ray constants and the packed shading-attribute table.
"""

from __future__ import annotations

import torch

from raytracer_tpu_torch.core.scene import SPHERE, FlatScene

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
