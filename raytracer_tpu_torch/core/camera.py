"""Camera operations as functions over the Camera dataclass (port of
``raytracer_tpu/core/camera.py``; reference src/camera.hpp).

The world is y-down, as in the reference (PARITY row 11): the basis math
is kept identical so images match.
"""

from __future__ import annotations

from typing import Tuple

import torch

from raytracer_tpu_torch.core.types import Camera, normalize
from raytracer_tpu_torch.geom.direct import div_rn

# Reference defaults (src/camera.hpp:21-26).
YAW = -90.0
PITCH = 0.0
WORLD_UP = (0.0, 1.0, 0.0)


def _vectors_from_euler(yaw_deg, pitch_deg, world_up, device=None):
    """Front/right/up from Euler angles (src/camera.hpp:152-163)."""
    yaw = torch.deg2rad(torch.as_tensor(yaw_deg, dtype=torch.float32,
                                        device=device))
    pitch = torch.deg2rad(torch.as_tensor(pitch_deg, dtype=torch.float32,
                                          device=device))
    front = torch.stack([
        torch.cos(yaw) * torch.cos(pitch),
        torch.sin(pitch),
        torch.sin(yaw) * torch.cos(pitch),
    ])
    front = normalize(front)
    up_w = torch.as_tensor(world_up, dtype=torch.float32, device=front.device)
    right = normalize(torch.linalg.cross(front, up_w))
    up = normalize(torch.linalg.cross(right, front))
    return front, right, up


def from_euler(position=(0.0, 0.0, 0.0), yaw=YAW, pitch=PITCH, fov_deg=60.0,
               aspect=1.0, world_up=WORLD_UP, device=None) -> Camera:
    """Build a camera the way the reference ctor does (camera.hpp:50-57)."""
    front, right, up = _vectors_from_euler(yaw, pitch, world_up, device)
    return Camera(position, front, up, right, fov_deg, aspect,
                  device=front.device)


def look_at(cam: Camera, target, world_up=WORLD_UP) -> Camera:
    """Point the camera at ``target`` (src/camera.hpp:139-148): pitch =
    asin(dir.y), yaw = atan2(dir.z, dir.x), then the Euler basis."""
    target = torch.as_tensor(target, dtype=torch.float32, device=cam.device)
    direction = normalize(target - cam.position)
    pitch = torch.rad2deg(torch.asin(direction[1]))
    yaw = torch.rad2deg(torch.atan2(direction[2], direction[0]))
    front, right, up = _vectors_from_euler(yaw, pitch, world_up, cam.device)
    return Camera(cam.position, front, up, right, cam.fov_deg, cam.aspect,
                  device=cam.device, half_h=cam.half_h)


def get_rays(cam: Camera, ndc_x: torch.Tensor, ndc_y: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Primary rays for NDC coordinates (src/camera.hpp:124-137): image
    plane at distance 1 along front, half-height tan(fov/2). Returns
    (origins, unit directions) of shape ndc.shape + (3,)."""
    half_w, half_h = cam.half_extent()
    ndc_x = ndc_x.to(torch.float32)[..., None]
    ndc_y = ndc_y.to(torch.float32)[..., None]
    plane_point = (cam.position + cam.front
                   + ndc_x * half_w * cam.right
                   + ndc_y * half_h * cam.up)
    d = normalize(plane_point - cam.position)
    o = torch.broadcast_to(cam.position, d.shape)
    return o, d


def pixel_ndc(width: int, height: int, device=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """NDC grids (height, width), y flipped as in the reference:
    ndc = (2x/W - 1, 1 - 2y/H)."""
    yi, xi = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=device),
        torch.arange(width, dtype=torch.float32, device=device),
        indexing="ij")
    ndc_x = div_rn(2.0 * xi, width) - 1.0
    ndc_y = 1.0 - div_rn(2.0 * yi, height)
    return ndc_x, ndc_y


def camera_rays(cam: Camera, width: int, height: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All primary rays for the image, shape (H, W, 3) each."""
    ndc_x, ndc_y = pixel_ndc(width, height, cam.device)
    return get_rays(cam, ndc_x, ndc_y)
