from raytracer_tpu_torch.io.image import read_png, to_uint8, write_png
from raytracer_tpu_torch.io.obj import load_obj, obj_to_triangles

__all__ = ["write_png", "read_png", "to_uint8", "load_obj",
           "obj_to_triangles"]
