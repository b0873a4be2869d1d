"""Render configuration (port of ``raytracer_tpu/config.py``).

The same fields and defaults as the JAX package's ``RenderConfig``, so a
configuration maps one to one between the two packages. The TPU execution
knobs are kept: the CUDA kernels take one thread per pixel or ray and have
no tile or interpret mode, so ``interpret`` is inert; ``ray_chunk`` is the
wavefront renderer's chunk of rays (as in the JAX ``lax.map``), and
``tile_h * tile_w`` sizes the packet renderer's square pixel blocks.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render settings.

      width/height   image size (default 800x600)
      max_bounces    Whitted bounces per pixel
      use_bvh        BVH visibility semantics (leaf-box clip of the
                     infinite floor wall) and the 1e-3 shadow offset
      use_fresnel    Fresnel-weighted reflection (reference double-count)
      use_mt         Moller-Trumbore triangle test instead of barycentric
      use_gram_tri   Gram-fused barycentric test (default); False = the raw
                     column test
    """

    width: int = 800
    height: int = 600
    max_bounces: int = 3
    use_bvh: bool = True
    use_fresnel: bool = False
    use_mt: bool = False
    enable_shadows: bool = True

    # Shadow-ray surface offset: 1e-3 in the BVH path, 1e-5 without.
    @property
    def shadow_eps(self) -> float:
        return 1e-3 if self.use_bvh else 1e-5

    # Reflection-ray surface offset: always 1e-3.
    reflect_eps: float = 1e-3

    # TPU execution knobs of the JAX package (see the module docstring).
    ray_chunk: int = 8192
    tile_h: int = 16
    tile_w: int = 128
    interpret: Optional[bool] = None
    # Sorted-continuation hybrid (render/wholeframe.py::_hybrid): re-sort
    # the continuation rays after bounce 1; second_sort re-sorts again
    # after bounce 2.
    sort_bounces: bool = False
    second_sort: bool = False
    use_gram_tri: bool = True

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)

    @property
    def num_pixels(self) -> int:
        return self.width * self.height

    @property
    def tri_mode(self) -> int:
        """Triangle test selector shared by the kernels and their plain
        versions: 0 raw barycentric, 1 Gram-fused, 2 Moller-Trumbore."""
        if self.use_mt:
            return TRI_MT
        return TRI_GRAM if self.use_gram_tri else TRI_RAW


TRI_RAW, TRI_GRAM, TRI_MT = 0, 1, 2
