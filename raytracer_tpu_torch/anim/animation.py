"""Animations as scene transforms (port of ``raytracer_tpu/anim/animation.py``).

Reference: bounceSphere (src/main.cpp:1079-1082), updateWheelAnimations
(main.cpp:1084-1109), driven per frame from the render loop
(main.cpp:438-457). Each step is ``scene -> scene`` on the SoA tensors,
as tensor code on the scene's device with no host round trip, once the
animation's parameters are on that device (``device_bounce``,
``device_wheels``: the frame loop converts them once, not per frame).

QUIRK (preserved): rotating a wheel triangle updates its vertices a/b/c
ONLY; the inherited plane fields m_normal and d are never recomputed
(main.cpp:1101-1106), so animated wheels are tested against their
original planes in barycentric mode. ``rotate_wheels`` updates tri_p1/2/3
and returns plane_normal / plane_d as they were; ``refresh_planes=True``
gives the physically correct variant.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple, Union

import numpy as np
import torch

from raytracer_tpu_torch.core.scene import FlatScene
from raytracer_tpu_torch.geom.direct import sqrt_rn

BounceParams = Union[Sequence[Tuple[int, float, float]],
                     Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def _scalar(x, device) -> torch.Tensor:
    """An f32 0-d tensor on ``device``; a number is written by a fill
    kernel (no host-to-device copy, which would wait for the card)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.full((), float(x), dtype=torch.float32, device=device)


def _on(x, device, dtype) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def device_bounce(bounce_params: BounceParams, device
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The (shape_idx, amplitude, frequency) triples as three tensors on
    ``device``: int64 indices, f32 amplitudes and frequencies. Tensors
    already there are returned as they are."""
    if len(bounce_params) == 3 and isinstance(bounce_params[0],
                                              torch.Tensor):
        cols = bounce_params
    else:
        cols = list(zip(*bounce_params)) or [(), (), ()]
    return (_on(cols[0], device, torch.int64),
            _on(cols[1], device, torch.float32),
            _on(cols[2], device, torch.float32))


def device_wheels(wheels: List[Dict], device) -> List[Dict]:
    """The wheel dicts with indices (int64), center and axis (f32) as
    tensors on ``device``. Tensors already there are kept as they are."""
    return [dict(w, indices=_on(w["indices"], device, torch.int64),
                 center=_on(w["center"], device, torch.float32),
                 axis=_on(w["axis"], device, torch.float32))
            for w in wheels]


def bounce_spheres(scene: FlatScene, bounce_params: BounceParams,
                   elapsed_time) -> FlatScene:
    """center.y = origin.y + amplitude * sin(frequency * t)
    (main.cpp:1079-1082). ``bounce_params``: (shape_idx, amplitude,
    frequency) triples, or ``device_bounce``'s tensors."""
    dev = scene.device
    idx, amp, freq = device_bounce(bounce_params, dev)
    t = _scalar(elapsed_time, dev)
    new_y = scene.origin[idx, 1] + amp * torch.sin(freq * t)
    c = scene.sphere_center.index_select(0, idx)
    c = torch.stack([c[:, 0], new_y, c[:, 2]], dim=1)
    return scene.replace(sphere_center=scene.sphere_center.index_copy(
        0, idx, c))


def _rotation_matrix(axis, angle) -> torch.Tensor:
    """glm::rotate: rotation about ``axis`` (3,) by ``angle`` rad, (3, 3)."""
    axis = torch.as_tensor(axis, dtype=torch.float32)
    axis = axis / sqrt_rn(axis[0] * axis[0] + axis[1] * axis[1]
                          + axis[2] * axis[2])
    x, y, z = axis[0], axis[1], axis[2]
    angle = _scalar(angle, axis.device)
    c = torch.cos(angle)
    s = torch.sin(angle)
    one_c = 1.0 - c
    return torch.stack([
        torch.stack([c + x * x * one_c, x * y * one_c - z * s,
                     x * z * one_c + y * s]),
        torch.stack([y * x * one_c + z * s, c + y * y * one_c,
                     y * z * one_c - x * s]),
        torch.stack([z * x * one_c - y * s, z * y * one_c + x * s,
                     c + z * z * one_c]),
    ])


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def rotate_wheels(scene: FlatScene, wheels: List[Dict], delta_time,
                  rotation_speed: float = 1.0,
                  refresh_planes: bool = False) -> FlatScene:
    """Rotate each wheel's triangles about its center by rotation_speed *
    delta_time around the wheel axis (main.cpp:1084-1109):
    p' = T(center) * R(axis, theta) * T(-center) * p. ``wheels``: dicts of
    indices, center and axis (``device_wheels`` puts them on the device
    once)."""
    dev = scene.device
    if isinstance(delta_time, torch.Tensor):
        angle = _scalar(rotation_speed, dev) * _scalar(delta_time, dev)
    else:   # the f32 product, as the JAX package forms it
        angle = np.float32(rotation_speed) * np.float32(delta_time)
    p1, p2, p3 = scene.tri_p1, scene.tri_p2, scene.tri_p3
    pn, pd = scene.plane_normal, scene.plane_d

    for wheel in device_wheels(wheels, dev):
        idx, center = wheel["indices"], wheel["center"]
        rot = _rotation_matrix(wheel["axis"], angle)

        def xform(p):
            # (p[idx] - center) @ rot.T + center, one rounded op at a time
            q = p.index_select(0, idx) - center
            return (q[:, 0:1] * rot[:, 0] + q[:, 1:2] * rot[:, 1]
                    + q[:, 2:3] * rot[:, 2]) + center

        a, b, c = xform(p1), xform(p2), xform(p3)
        p1 = p1.index_copy(0, idx, a)
        p2 = p2.index_copy(0, idx, b)
        p3 = p3.index_copy(0, idx, c)
        if refresh_planes:
            n = torch.linalg.cross(b - a, c - a, dim=-1)
            # keep the orientation of the (possibly flipped) stale normal,
            # so the back-face convention is stable
            n = n / sqrt_rn(_dot(n, n))[:, None]
            sign = torch.sign(_dot(n, pn.index_select(0, idx)))[:, None]
            n = n * torch.where(sign == 0, 1.0, sign)
            pn = pn.index_copy(0, idx, n)
            pd = pd.index_copy(0, idx, -_dot(n, a))

    return scene.replace(tri_p1=p1, tri_p2=p2, tri_p3=p3,
                         plane_normal=pn, plane_d=pd)


def animate_scene(scene_meta, flat: FlatScene, elapsed_time, delta_time,
                  refresh_planes: bool = False) -> FlatScene:
    """One animation tick for a scenes.Scene (main.cpp:438-457): bounce the
    scene-1 spheres by absolute time, rotate scene-2 wheels by delta time."""
    if scene_meta.bounce_params:
        flat = bounce_spheres(flat, scene_meta.bounce_params, elapsed_time)
    if scene_meta.wheels:
        flat = rotate_wheels(flat, scene_meta.wheels, delta_time,
                             refresh_planes=refresh_planes)
    return flat
