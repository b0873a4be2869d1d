"""Checkpoint / resume for scenes and parameters (port of
``raytracer_tpu/io/checkpoint.py``).

A plain npz round-trip with the JAX package's keys (``scene.<field>``,
``camera.<field>``, ``light.<field>``, ``extra.<name>``), so that a file
saved by one package loads in the other."""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from raytracer_tpu_torch.core.scene import _FIELDS, FlatScene, to_numpy
from raytracer_tpu_torch.core.types import Camera, Light
from raytracer_tpu_torch.device import resolve_device

_CAMERA = ("position", "front", "up", "right", "fov_deg", "aspect")
_LIGHT = ("position", "base_color", "intensity")


def save_scene(path: str, scene: FlatScene, camera: Camera = None,
               light: Light = None, extra: Dict[str, Any] = None) -> None:
    data = {f"scene.{f}": to_numpy(getattr(scene, f)) for f in _FIELDS}
    if camera is not None:
        for k in _CAMERA:
            data[f"camera.{k}"] = to_numpy(getattr(camera, k))
    if light is not None:
        for k in _LIGHT:
            data[f"light.{k}"] = to_numpy(getattr(light, k))
    for k, v in (extra or {}).items():
        data[f"extra.{k}"] = to_numpy(v)
    np.savez(path, **data)


def load_scene(path: str, device=None) -> Tuple[FlatScene, Camera, Light,
                                                Dict[str, np.ndarray]]:
    """(scene, camera or None, light or None, extras as numpy arrays);
    the tensors on ``device`` (None means "cuda")."""
    dev = resolve_device(device)
    z = np.load(path)
    scene = FlatScene(**{f: torch.from_numpy(z[f"scene.{f}"]).to(dev)
                         for f in _FIELDS})
    camera = None
    if "camera.position" in z:
        camera = Camera(*(z[f"camera.{k}"] for k in _CAMERA), device=dev)
    light = None
    if "light.position" in z:
        light = Light(*(z[f"light.{k}"] for k in _LIGHT), device=dev)
    extra = {k[len("extra."):]: z[k] for k in z.files
             if k.startswith("extra.")}
    return scene, camera, light, extra
