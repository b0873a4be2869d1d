from raytracer_tpu_torch.core.types import Camera, Light, Material
from raytracer_tpu_torch.core.scene import FlatScene, SceneBuilder
from raytracer_tpu_torch.core import camera

__all__ = ["Material", "Light", "Camera", "FlatScene", "SceneBuilder",
           "camera"]
