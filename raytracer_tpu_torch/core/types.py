"""Core value types: Material, Light, Camera (port of
``raytracer_tpu/core/types.py``).

Dataclasses of float32 tensors. Material and Light are the reference's
(src/material.hpp:4-30, src/light.hpp:6-35); the Camera keeps the
reference's y-down basis math (src/camera.hpp:30-164).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


def _f32(x, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(x, dtype=torch.float32, device=device)


@dataclasses.dataclass
class Material:
    """Phong material; defaults are the reference's (material.hpp:4-30).
    ``shininess`` is stored as f32 (it is only a ``pow`` exponent)."""

    color: torch.Tensor
    fresnel: torch.Tensor
    ambient: torch.Tensor
    diffuse: torch.Tensor
    specular: torch.Tensor
    shininess: torch.Tensor

    def __init__(self, color=(1.0, 1.0, 1.0), fresnel=1.0, ambient=0.4,
                 diffuse=1.0, specular=0.5, shininess=32):
        self.color = _f32(color)
        self.fresnel = _f32(fresnel)
        self.ambient = _f32(ambient)
        self.diffuse = _f32(diffuse)
        self.specular = _f32(specular)
        self.shininess = _f32(shininess)


@dataclasses.dataclass
class Light:
    """Point light; effective color = intensity * base_color."""

    position: torch.Tensor
    base_color: torch.Tensor
    intensity: torch.Tensor

    def __init__(self, position=(0.0, 0.0, 0.0),
                 base_color=(1.0, 1.0, 1.0), intensity=1.0, device=None):
        self.position = _f32(position, device)
        self.base_color = _f32(base_color, device)
        self.intensity = _f32(intensity, device)

    @property
    def color(self) -> torch.Tensor:
        return self.intensity * self.base_color

    def to(self, device) -> "Light":
        return Light(self.position, self.base_color, self.intensity,
                     device=device)


@dataclasses.dataclass
class Camera:
    """Pinhole camera: position + orthonormal (front, up, right) basis,
    vertical fov in degrees and aspect ratio.

    ``half_h``, the image plane's half height tan(fov/2), is derived from
    ``fov_deg`` unless given. It is given only where a camera is carried
    across from another implementation (interop.from_numpy): f32 ``tan``
    differs by an ulp between libraries (XLA's tan(30 deg) is one ulp
    above the correctly rounded value), and the primary rays must match
    to compare images."""

    position: torch.Tensor
    front: torch.Tensor
    up: torch.Tensor
    right: torch.Tensor
    fov_deg: torch.Tensor
    aspect: torch.Tensor
    half_h: Optional[torch.Tensor]

    def __init__(self, position, front, up, right, fov_deg=60.0, aspect=1.0,
                 device=None, half_h=None):
        self.position = _f32(position, device)
        self.front = _f32(front, device)
        self.up = _f32(up, device)
        self.right = _f32(right, device)
        self.fov_deg = _f32(fov_deg, device)
        self.aspect = _f32(aspect, device)
        self.half_h = None if half_h is None else _f32(half_h, device)

    @property
    def device(self) -> torch.device:
        return self.position.device

    def half_extent(self):
        """(half_w, half_h) of the image plane at distance 1."""
        half_h = self.half_h if self.half_h is not None else \
            torch.tan(torch.deg2rad(self.fov_deg / 2.0))
        return half_h * self.aspect, half_h

    def to(self, device) -> "Camera":
        return Camera(self.position, self.front, self.up, self.right,
                      self.fov_deg, self.aspect, device=device,
                      half_h=self.half_h)


def normalize(v: torch.Tensor, dim: int = -1, eps: float = 0.0
              ) -> torch.Tensor:
    """GLSL-style normalize. With eps=0 this matches glm/GLSL exactly
    (0/0 -> nan); a small eps keeps zero vectors finite."""
    n = torch.linalg.vector_norm(v, dim=dim, keepdim=True)
    if eps:
        n = torch.clamp_min(n, eps)
    return v / n
