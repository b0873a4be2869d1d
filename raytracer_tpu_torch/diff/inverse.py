"""Inverse rendering: fit scene parameters to a target image by gradient
descent (port of ``raytracer_tpu/diff/inverse.py``).

Gradients flow from pixels back to sphere centres and radii, triangle
vertices, materials, the light and the camera; the discrete events (which
shape is hit, shadow on or off) are held fixed (``kernel_vjp``).
Parameters are leaf tensors with ``requires_grad``; a scene is rebuilt
from them with ``FlatScene.replace`` each evaluation.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Tuple

import torch

from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.core.scene import FlatScene
from raytracer_tpu_torch.core.types import Camera, Light
from raytracer_tpu_torch.device import resolve_device
from raytracer_tpu_torch.render import reference


def image_loss(img: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean squared error over pixels."""
    diff = img - target
    return torch.mean(diff * diff)


def _pool(img: torch.Tensor, s: int) -> torch.Tensor:
    """Average over s x s windows with stride s, whole windows only
    (``reduce_window`` sum over VALID windows, / s^2): (H // s, W // s,
    3)."""
    h, w = img.shape[0] // s, img.shape[1] // s
    win = img[:h * s, :w * s].reshape(h, s, w, s, img.shape[2])
    return win.sum((1, 3)) / (s * s)


def image_loss_pyramid(img: torch.Tensor, target: torch.Tensor,
                       scales=(1, 4, 16)) -> torch.Tensor:
    """Multi-scale MSE: the sum of the MSEs of average-pooled copies of
    both (H, W, 3) images, one per pooling width in ``scales`` (1 is the
    plain MSE). Geometry fits need it: with the hit decisions held fixed,
    the per-pixel MSE carries shading gradients only where the object
    already overlaps its target, and its best step for a displaced object
    is often to shrink the mismatch; the coarse scales blur the object
    into a blob whose pooled intensity moves smoothly with position."""
    loss = torch.zeros((), dtype=img.dtype, device=img.device)
    for s in scales:
        if s == 1:
            loss = loss + image_loss(img, target)
        else:
            loss = loss + image_loss(_pool(img, s), _pool(target, s))
    return loss


def make_loss_fn(scene: FlatScene, camera: Camera, light: Light,
                 cfg: RenderConfig, target: torch.Tensor,
                 param_fields: Iterable[str],
                 renderer: Optional[Callable] = None) -> Callable:
    """loss(params, light_params=None): the MSE against ``target`` of the
    image of ``scene`` with the FlatScene fields in ``params`` (a dict
    {field: tensor}) replaced; the other fields are constants.

    ``renderer(scene, camera, light, cfg) -> image`` selects the render
    path: by default the brute-force oracle (``render/reference.py``) on
    the scene's device, differentiable by autograd; pass
    ``make_kernel_renderer``'s result to fit through the production
    kernel."""
    if renderer is None:
        renderer = _oracle
    fields = tuple(param_fields)

    def loss(params: Dict[str, torch.Tensor],
             light_params: Optional[Light] = None) -> torch.Tensor:
        img = renderer(scene.replace(**params), camera,
                       light if light_params is None else light_params, cfg)
        return image_loss(img, target)

    loss.param_fields = fields
    return loss


def _oracle(scene: FlatScene, camera, light, cfg) -> torch.Tensor:
    return reference.render(scene, camera, light, cfg, device=scene.device)


def make_kernel_renderer(bvh, split0, device=None) -> Callable:
    """A renderer that fits through the production split kernel: every
    evaluation refreshes the tables from the current scene on the device
    (``update_dynamic``: pre rows of moved spheres and walls, triangle
    rows with the tree's refit), so hit decisions follow the moving
    geometry across steps, then renders with ``differentiable=True``. The
    refreshed tables carry no gradient: the kernel only decides hits, and
    gradients flow through the re-derivation against the live scene.
    ``device`` None means "cuda"; ``split0`` is moved there once."""
    from raytracer_tpu_torch.render import split as split_mod
    from raytracer_tpu_torch.render.split_scene import update_dynamic

    dev = resolve_device(device)
    split0 = split0.to(dev)

    def render(s: FlatScene, camera, light, cfg) -> torch.Tensor:
        s = s.to(dev)
        sp = update_dynamic(split0, s)
        return split_mod.render(s, bvh, camera, light, cfg, split=sp,
                                differentiable=True, device=dev)

    return render


def fit_scene_params(scene: FlatScene, camera: Camera, light: Light,
                     cfg: RenderConfig, target: torch.Tensor,
                     init_params: Dict[str, torch.Tensor],
                     steps: int = 100, lr: float = 0.05,
                     optimizer: Optional[Callable] = None,
                     renderer: Optional[Callable] = None,
                     ) -> Tuple[Dict[str, torch.Tensor], list]:
    """Gradient-descent fit of the FlatScene fields in ``init_params`` to
    ``target``. Plain SGD (p - lr * g) by default; ``optimizer``, a
    factory ``optimizer(list of parameters) -> torch.optim.Optimizer``
    (e.g. ``lambda ps: torch.optim.Adam(ps, lr=0.01)``), replaces it.
    ``renderer`` as for ``make_loss_fn``. Returns (fitted params, loss
    history), the loss of each step taken before its update."""
    loss_fn = make_loss_fn(scene, camera, light, cfg, target,
                           init_params.keys(), renderer=renderer)
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in init_params.items()}
    leaves = list(params.values())
    opt = optimizer(leaves) if optimizer is not None else None
    history = []
    for _ in range(steps):
        val = loss_fn(params)
        grads = torch.autograd.grad(val, leaves)
        with torch.no_grad():
            if opt is None:
                for p, g in zip(leaves, grads):
                    p.copy_(p - lr * g)
            else:
                for p, g in zip(leaves, grads):
                    p.grad = g
        if opt is not None:
            opt.step()
        history.append(float(val.detach()))
    return {k: v.detach() for k, v in params.items()}, history
