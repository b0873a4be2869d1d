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

The packed rows' 24 columns are gathered by ``render/row_gather.py``,
and ``intersect_rows`` takes them as they are. Where autograd records the
gather on the card, ``gather_rows_kernel`` writes each column as an array
of its own and the backward, ``row_grads_kernel``, sums a warp's column
gradients by shape id before it adds them to the rows (the rays of a
miss, and of the shadow rays, carry none and are skipped). Elsewhere the
columns are views of an ``index_select`` row, whose backward is
``index_add_``.

The JAX package has no backward kernel: its gradients are autodiff
through XLA ops, and the rest of these are autograd through PyTorch ops.
The re-derivation tests one shape per ray, O(R) against the kernel's
walk.
"""

from __future__ import annotations

import torch

from raytracer_tpu_torch.core.scene import FlatScene
from raytracer_tpu_torch.geom import rowwise
from raytracer_tpu_torch.render import row_gather


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
        cols = row_gather.gather(rows, sid, row_gather.PACK_GROUPS)
        t_diff, _ = rowwise.intersect_rows(cols, o, d, use_mt)
        ok = torch.isfinite(t_diff) & (t_diff < 1e29)
        return torch.where(hit & ok, t_diff, t_fast), sid, hit

    return closest
