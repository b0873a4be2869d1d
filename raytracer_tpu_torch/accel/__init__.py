from raytracer_tpu_torch.accel.bvh import BVH, build_bvh, refit_grow
from raytracer_tpu_torch.accel.linearize import LinearBVH, linearize

__all__ = ["BVH", "build_bvh", "refit_grow", "LinearBVH", "linearize"]
