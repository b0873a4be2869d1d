"""Carry scene data across from the JAX package, as numpy arrays.

``from_numpy`` takes what the JAX package computed (a FlatScene's fields,
a SplitScene's ``device_args()`` and counts, the ``_attr_table``, the
reference LinearBVH's arrays, camera and light values), all as numpy
arrays, and returns the port's objects on
a given device. Tests use it to feed both packages the same tables; it
imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from raytracer_tpu_torch.accel.linearize import LinearBVH
from raytracer_tpu_torch.core.scene import _FIELDS, FlatScene
from raytracer_tpu_torch.core.types import Camera, Light
from raytracer_tpu_torch.device import resolve_device
from raytracer_tpu_torch.render.split_scene import REFIT_FIELDS, SplitScene


@dataclasses.dataclass
class Ported:
    """The port's objects built by ``from_numpy`` (None where not given)."""

    flat: Optional[FlatScene] = None
    split: Optional[SplitScene] = None
    attr_tab: Optional[torch.Tensor] = None
    camera: Optional[Camera] = None
    light: Optional[Light] = None
    lin: Optional[LinearBVH] = None


def _t(x, device, dtype=None) -> torch.Tensor:
    return torch.from_numpy(np.array(x)).to(device=device,
                                                         dtype=dtype)


def from_numpy(*, flat: Optional[dict] = None,
               split_args: Optional[Sequence[np.ndarray]] = None,
               m: Optional[int] = None, n_other: Optional[int] = None,
               n_sph: Optional[int] = None, n_tri: Optional[int] = None,
               rid_values: Sequence[int] = (),
               refit: Optional[dict] = None,
               attr_tab: Optional[np.ndarray] = None,
               camera: Optional[dict] = None, light: Optional[dict] = None,
               lin: Optional[dict] = None, device=None) -> Ported:
    """Build the port's objects from numpy arrays.

    flat: FlatScene fields by name. split_args: (leaf_start, leaf_count,
    skip, nodes, pre_rows, tri_rows) as ``SplitScene.device_args()``
    returns them, with ``m``, ``n_other``, ``n_sph`` and ``rid_values``
    (``n_tri`` defaults to the rows the tree's leaves reach; padding rows
    past it are never read). refit: the SplitScene's refit metadata by
    name (``split_scene.REFIT_FIELDS``: other_idx, tri_gids, tri_leaf_id,
    leaf_lo, leaf_hi, node_lo, node_hi, n_leaf, m_pad), which the
    ``update_*`` refreshers read. camera: position, front, up, right, fov_deg,
    aspect, and optionally half_h (the image plane's half height as the
    other implementation computed it). light: position, base_color,
    intensity. lin: the reference LinearBVH's bounds, leaf_start,
    leaf_count, skip and perm; it stays on the host, as ``linearize``
    returns it."""
    dev = resolve_device(device)
    out = Ported()
    if flat is not None:
        missing = set(_FIELDS) - set(flat)
        if missing:
            raise ValueError(f"flat lacks fields {sorted(missing)}")
        out.flat = FlatScene(**{
            f: _t(flat[f], dev, torch.int32 if f == "shape_type" else
                  torch.bool if f == "animated" else torch.float32)
            for f in _FIELDS})
    if split_args is not None:
        if None in (m, n_other, n_sph):
            raise ValueError("split_args need m, n_other and n_sph")
        ls, lc, sk, nodes, pre, tri = (np.asarray(a) for a in split_args)
        if n_tri is None:
            n_tri = int((ls[:m].astype(np.int64)
                         + lc[:m].astype(np.int64)).max()) if m else 0
        out.split = SplitScene(
            leaf_start=_t(ls, dev, torch.int32),
            leaf_count=_t(lc, dev, torch.int32),
            skip=_t(sk, dev, torch.int32),
            nodes=_t(nodes, dev, torch.float32),
            pre_rows=_t(pre, dev, torch.float32),
            tri_rows=_t(tri, dev, torch.float32),
            m=int(m), n_other=int(n_other), n_sph=int(n_sph),
            n_tri=int(n_tri), rid_values=tuple(int(v) for v in rid_values),
            **({} if refit is None else {
                k: int(refit[k]) if k in ("n_leaf", "m_pad")
                else _t(refit[k], dev, torch.int32)
                for k in REFIT_FIELDS}))
    if attr_tab is not None:
        out.attr_tab = _t(attr_tab, dev, torch.float32)
    if camera is not None:
        out.camera = Camera(**{k: np.array(v) for k, v in camera.items()},
                            device=dev)
    if light is not None:
        out.light = Light(**{k: np.array(v) for k, v in light.items()},
                          device=dev)
    if lin is not None:
        out.lin = LinearBVH(**{
            f: _t(lin[f], "cpu", torch.float32 if f == "bounds" else
                  torch.int32)
            for f in ("bounds", "leaf_start", "leaf_count", "skip", "perm")})
    return out
