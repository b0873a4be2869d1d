from raytracer_tpu_torch.utils.timing import FrameTimer, benchmark

__all__ = ["FrameTimer", "benchmark"]
