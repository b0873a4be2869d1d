"""raytracer_tpu_torch — the PyTorch and CUDA port of ``raytracer_tpu``.

The module layout mirrors the JAX package, so each module's counterpart
is found under the same path. Host-side scene preparation is numpy, as in
the JAX package; the Whitted frame and the closest-hit query run in CUDA
kernels written for Hopper (``csrc/``), each with a plain PyTorch version
that the CPU path uses. Entry points take ``device=None``, meaning
``"cuda"``.
"""

__version__ = "0.1.0"

from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.core.types import Camera, Light, Material
from raytracer_tpu_torch.core.scene import FlatScene, SceneBuilder

__all__ = ["RenderConfig", "Material", "Light", "Camera", "FlatScene",
           "SceneBuilder"]
