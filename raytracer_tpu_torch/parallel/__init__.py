"""Multi-device rendering over a mesh of devices (port of
``raytracer_tpu/parallel``)."""

from raytracer_tpu_torch.parallel.sharding import (make_mesh, render_sharded,
                                                   render_sharded_split,
                                                   trace_sharded)

__all__ = ["make_mesh", "render_sharded", "render_sharded_split",
           "trace_sharded"]
