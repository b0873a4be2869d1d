from raytracer_tpu_torch.accel.bvh import BVH, build_bvh
from raytracer_tpu_torch.accel.linearize import LinearBVH, linearize

__all__ = ["BVH", "build_bvh", "LinearBVH", "linearize"]
