from raytracer_tpu_torch.anim.animation import (animate_scene, bounce_spheres,
                                                rotate_wheels)

__all__ = ["bounce_spheres", "rotate_wheels", "animate_scene"]
