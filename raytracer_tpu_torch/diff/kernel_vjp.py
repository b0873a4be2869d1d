"""A differentiable closest hit around a kernel that has no gradient (port
of ``raytracer_tpu/diff/kernel_vjp.py``).

The closest-hit kernels return (t, shape id, hit) and carry no gradient.
The convention of differentiable rendering holds the discrete decisions
fixed (which shape a ray hits, whether a point is shadowed) and lets the
gradients flow through the continuous terms:

  1. the kernel runs on detached rays; its sid and hit are constants;
  2. t is re-derived by intersecting each ray with its winning shape
     alone (``geom.rowwise.intersect_rows`` on the packed row of the
     current scene), in autograd;
  3. the Whitted loop differentiates through hit points, normals and
     Phong as it does for any tensor.

The JAX package has no backward kernel either: its gradients are autodiff
through XLA ops, and these are autograd through PyTorch ops. The
re-derivation tests one shape per ray, O(R) against the kernel's walk.
"""

from __future__ import annotations

import torch

from raytracer_tpu_torch.core.scene import FlatScene
from raytracer_tpu_torch.geom import rowwise


def make_differentiable_closest(scene: FlatScene, fast_closest,
                                use_mt: bool = False):
    """Wrap ``fast_closest(o, d) -> (t, sid, hit)`` so that the returned
    t carries gradients with respect to ``scene``'s tensors (and o, d).
    Where the re-derived t is not finite or not below 1e29 (a grazing
    test that disagrees with the kernel), the kernel's t is kept, without
    gradient."""
    rows = rowwise.pack_rows(scene)

    def closest(o, d):
        t_fast, sid, hit = fast_closest(o.detach().contiguous(),
                                        d.detach().contiguous())
        row = rows.index_select(0, sid.long())   # backward: index_add_
        t_diff, _ = rowwise.intersect_rows(row, o, d, use_mt)
        ok = torch.isfinite(t_diff) & (t_diff < 1e29)
        return torch.where(hit & ok, t_diff, t_fast), sid, hit

    return closest
