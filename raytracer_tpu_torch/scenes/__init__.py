from raytracer_tpu_torch.scenes.generators import (Scene, generate_scene,
                                                   generate_scene1,
                                                   generate_scene2,
                                                   generate_scene3)

__all__ = ["generate_scene1", "generate_scene2", "generate_scene3", "Scene",
           "generate_scene"]
