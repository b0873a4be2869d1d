"""Flat SoA scene representation + host-side scene builder (port of
``raytracer_tpu/core/scene.py``).

Field semantics are the reference's ``FlatShape`` ABI
(src/flatStructures.hpp:22-53):

  type          0=sphere 1=plane 2=wall 3=triangle
  material.*    color/fresnel/ambient/diffuse/specular/shininess
  sphere        center, radius
  plane         unit normal n, d with plane eq. n.p + d = 0, d = -n.point
  wall          start corner, width, height (+ inherited plane fields)
  triangle      p1,p2,p3 (+ inherited plane fields: n = normalize(cross(
                p2-p1, p3-p1)) possibly inverted, d = -n.p1)

Unused fields for a given type are zero. Shapes are accumulated on the
host in numpy, exactly as the JAX package does, and handed to torch once.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from raytracer_tpu_torch.core.types import Material
from raytracer_tpu_torch.device import resolve_device

SPHERE, PLANE, WALL, TRIANGLE = 0, 1, 2, 3

_FIELDS = (
    "shape_type",
    "mat_color", "mat_fresnel", "mat_ambient", "mat_diffuse", "mat_specular",
    "mat_shininess",
    "sphere_center", "sphere_radius",
    "plane_normal", "plane_d",
    "wall_start", "wall_width", "wall_height",
    "tri_p1", "tri_p2", "tri_p3",
    "origin", "animated",
)


def to_numpy(x) -> np.ndarray:
    """Host copy of a tensor (or array-like) for the numpy scene prep."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclasses.dataclass
class FlatScene:
    """SoA scene tensors over N shapes. All f32 except shape_type (int32)
    and animated (bool)."""

    shape_type: torch.Tensor       # int32 [N]
    mat_color: torch.Tensor        # f32 [N, 3]
    mat_fresnel: torch.Tensor      # f32 [N]
    mat_ambient: torch.Tensor      # f32 [N]
    mat_diffuse: torch.Tensor      # f32 [N]
    mat_specular: torch.Tensor     # f32 [N]
    mat_shininess: torch.Tensor    # f32 [N]
    sphere_center: torch.Tensor    # f32 [N, 3]
    sphere_radius: torch.Tensor    # f32 [N]
    plane_normal: torch.Tensor     # f32 [N, 3]
    plane_d: torch.Tensor          # f32 [N]
    wall_start: torch.Tensor       # f32 [N, 3]
    wall_width: torch.Tensor       # f32 [N]
    wall_height: torch.Tensor      # f32 [N]
    tri_p1: torch.Tensor           # f32 [N, 3]
    tri_p2: torch.Tensor           # f32 [N, 3]
    tri_p3: torch.Tensor           # f32 [N, 3]
    origin: torch.Tensor           # f32 [N, 3]
    animated: torch.Tensor         # bool [N]

    @property
    def num_shapes(self) -> int:
        return self.shape_type.shape[0]

    @property
    def device(self) -> torch.device:
        return self.shape_type.device

    def replace(self, **kw) -> "FlatScene":
        return dataclasses.replace(self, **kw)

    def pad_to(self, n: int, pad_type: int = SPHERE) -> "FlatScene":
        """Pad to n shapes with inert entries: zero-radius spheres at the
        origin never give an INNER hit (the discriminant (2 d.oc)^2 -
        4|d|^2|oc|^2 <= 0 by Cauchy-Schwarz, and the reference requires
        D > 0 strictly, sphere.hpp:48-50). Other fields are zero."""
        cur = self.num_shapes
        if n < cur:
            raise ValueError(f"pad_to({n}) below current size {cur}")
        if n == cur:
            return self
        out = {}
        for f in _FIELDS:
            x = getattr(self, f)
            out[f] = torch.cat([x, x.new_zeros((n - cur,) + x.shape[1:])])
        out["shape_type"][cur:] = pad_type
        return FlatScene(**out)

    def take(self, idx) -> "FlatScene":
        """Gather shapes by index (reorders / slices every field)."""
        idx = torch.as_tensor(idx, dtype=torch.int64, device=self.device)
        return FlatScene(**{f: getattr(self, f).index_select(0, idx)
                            for f in _FIELDS})

    def to(self, device) -> "FlatScene":
        return FlatScene(**{f: getattr(self, f).to(device) for f in _FIELDS})

    def numpy(self) -> dict:
        """Host copies of every field, by name."""
        return {f: to_numpy(getattr(self, f)) for f in _FIELDS}

    def recompute_tri_planes(self) -> "FlatScene":
        """Plane refresh from triangle vertices — the reference Triangle
        ctor (src/shapes/triangle.hpp:84-130: normal = normalize(cross(
        p2-p1, p3-p1)), d = -n.p1) — keeping each triangle's stored
        orientation (invert_normal / flip-toward-center). Required before
        rendering a scene whose vertices changed without SceneBuilder."""
        e1 = self.tri_p2 - self.tri_p1
        e2 = self.tri_p3 - self.tri_p1
        n = torch.linalg.cross(e1, e2, dim=-1)
        norm2 = torch.sum(n * n, dim=-1, keepdim=True)
        nn = n * torch.rsqrt(torch.where(norm2 > 0, norm2, 1.0))
        flip = torch.where(
            torch.sum(nn * self.plane_normal, -1, keepdim=True) < 0,
            -1.0, 1.0)
        nn = nn * flip
        is_tri = self.shape_type == TRIANGLE
        pn = torch.where(is_tri[:, None], nn, self.plane_normal)
        pd = torch.where(is_tri, -torch.sum(pn * self.tri_p1, -1),
                         self.plane_d)
        return self.replace(plane_normal=pn, plane_d=pd)


class _BulkRows:
    """Columnar block of ``count`` consecutive shapes (one add_triangles
    call)."""

    __slots__ = ("count", "cols")

    def __init__(self, count: int, cols: dict):
        self.count = count
        self.cols = cols


class SceneBuilder:
    """Host-side accumulation of shapes into a FlatScene (the reference's
    ``scene.shapes.push_back`` + ``serializeScene``, src/main.cpp:583-846).
    """

    def __init__(self):
        self._rows: List = []
        self.animated_indices: List[int] = []
        self._n = 0

    def __len__(self):
        return self._n

    def _push(self, row: dict, material: Optional[Material],
              animated: bool) -> int:
        mat = material if material is not None else Material()
        row["mat_color"] = np.asarray(mat.color, np.float32)
        row["mat_fresnel"] = float(mat.fresnel)
        row["mat_ambient"] = float(mat.ambient)
        row["mat_diffuse"] = float(mat.diffuse)
        row["mat_specular"] = float(mat.specular)
        row["mat_shininess"] = float(mat.shininess)
        row["animated"] = animated
        idx = self._n
        self._rows.append(row)
        self._n += 1
        if animated:
            self.animated_indices.append(idx)
        return idx

    def add_sphere(self, center, radius, material: Optional[Material] = None,
                   animated: bool = False) -> int:
        """src/shapes/sphere.hpp:26-31; origin = center."""
        center = np.asarray(center, np.float32)
        return self._push({
            "shape_type": SPHERE,
            "sphere_center": center,
            "sphere_radius": float(radius),
            "origin": center,
        }, material, animated)

    def add_plane(self, normal, point, material: Optional[Material] = None,
                  animated: bool = False) -> int:
        """src/shapes/plane.hpp:28-33: n normalized, d = -n.point."""
        n = np.asarray(normal, np.float64)
        n = (n / np.linalg.norm(n)).astype(np.float32)
        point = np.asarray(point, np.float32)
        return self._push({
            "shape_type": PLANE,
            "plane_normal": n,
            "plane_d": float(-np.dot(n, point)),
            "origin": point,
        }, material, animated)

    def add_wall(self, start, width, height, normal,
                 material: Optional[Material] = None,
                 animated: bool = False) -> int:
        """src/shapes/wall.hpp:37-40: a plane through ``start`` bounded to
        a width x height rectangle."""
        n = np.asarray(normal, np.float64)
        n = (n / np.linalg.norm(n)).astype(np.float32)
        start = np.asarray(start, np.float32)
        return self._push({
            "shape_type": WALL,
            "plane_normal": n,
            "plane_d": float(-np.dot(n, start)),
            "wall_start": start,
            "wall_width": float(width),
            "wall_height": float(height),
            "origin": start,
        }, material, animated)

    def add_triangle(self, p1, p2, p3, material: Optional[Material] = None,
                     invert_normal: bool = False,
                     animated: bool = False) -> int:
        """src/shapes/triangle.hpp:46,84-98: plane normal =
        normalize(cross(p2-p1, p3-p1)), optionally inverted; d = -n.p1."""
        p1 = np.asarray(p1, np.float32)
        p2 = np.asarray(p2, np.float32)
        p3 = np.asarray(p3, np.float32)
        n = np.cross((p2 - p1).astype(np.float64),
                     (p3 - p1).astype(np.float64))
        norm = np.linalg.norm(n)
        n = (n / norm).astype(np.float32) if norm > 0 \
            else np.zeros(3, np.float32)
        if invert_normal:
            n = -n
        return self._push({
            "shape_type": TRIANGLE,
            "plane_normal": n,
            "plane_d": float(-np.dot(n.astype(np.float64),
                                     p1.astype(np.float64))),
            "tri_p1": p1, "tri_p2": p2, "tri_p3": p3,
            "origin": p1,
        }, material, animated)

    def add_triangles(self, vertices: np.ndarray,
                      material: Optional[Material] = None,
                      flip_toward_center: Optional[np.ndarray] = None,
                      animated: bool = False) -> List[int]:
        """Bulk-add triangles from a (T, 3, 3) vertex array. With
        ``flip_toward_center``, any triangle whose normal satisfies
        dot(normal, center) > 0 is inverted (src/mesh.hpp:163-189)."""
        v = np.asarray(vertices, np.float64)
        p1, p2, p3 = v[:, 0], v[:, 1], v[:, 2]
        n = np.cross(p2 - p1, p3 - p1)
        norm = np.linalg.norm(n, axis=-1, keepdims=True)
        n = np.divide(n, norm, out=np.zeros_like(n), where=norm > 0)
        if flip_toward_center is not None:
            c = np.asarray(flip_toward_center, np.float64)
            flip = (n @ c) > 0.0
            n = np.where(flip[:, None], -n, n)
        d = -(n * p1).sum(-1)

        mat = material if material is not None else Material()
        cnt = int(v.shape[0])
        p1f = p1.astype(np.float32)

        def full(val, shape=()):
            return np.broadcast_to(np.asarray(val), (cnt,) + shape).copy()

        cols = {
            "shape_type": full(TRIANGLE).astype(np.int32),
            "plane_normal": n.astype(np.float32),
            "plane_d": d.astype(np.float32),
            "tri_p1": p1f,
            "tri_p2": p2.astype(np.float32),
            "tri_p3": p3.astype(np.float32),
            "origin": p1f.copy(),
            "mat_color": full(np.asarray(mat.color, np.float32), (3,)),
            "mat_fresnel": full(np.float32(float(mat.fresnel))),
            "mat_ambient": full(np.float32(float(mat.ambient))),
            "mat_diffuse": full(np.float32(float(mat.diffuse))),
            "mat_specular": full(np.float32(float(mat.specular))),
            "mat_shininess": full(np.float32(float(mat.shininess))),
            "animated": full(bool(animated)),
        }
        start = self._n
        self._rows.append(_BulkRows(cnt, cols))
        self._n += cnt
        ids = list(range(start, start + cnt))
        if animated:
            self.animated_indices.extend(ids)
        return ids

    def set_material(self, idx: int, material: Material):
        """Replace shape ``idx``'s material before ``build``."""
        vals = {
            "mat_color": np.asarray(material.color, np.float32),
            "mat_fresnel": float(material.fresnel),
            "mat_ambient": float(material.ambient),
            "mat_diffuse": float(material.diffuse),
            "mat_specular": float(material.specular),
            "mat_shininess": float(material.shininess),
        }
        pos = 0
        for row in self._rows:
            if isinstance(row, _BulkRows):
                if pos <= idx < pos + row.count:
                    for k, v in vals.items():
                        row.cols[k][idx - pos] = v
                    return
                pos += row.count
            else:
                if pos == idx:
                    row.update(vals)
                    return
                pos += 1
        raise IndexError(idx)

    def build(self, device=None) -> FlatScene:
        n = self._n
        if n == 0:
            raise ValueError("empty scene")
        dev = resolve_device(device)

        def col(name, shape, dtype, default=0):
            out = np.full((n,) + shape, default, dtype)
            pos = 0
            for row in self._rows:
                if isinstance(row, _BulkRows):
                    if name in row.cols:
                        out[pos:pos + row.count] = row.cols[name]
                    pos += row.count
                else:
                    if name in row:
                        out[pos] = row[name]
                    pos += 1
            return torch.from_numpy(out).to(dev)

        f3, f1 = ((3,), np.float32), ((), np.float32)
        specs = {
            "shape_type": ((), np.int32), "mat_color": f3,
            "mat_fresnel": f1, "mat_ambient": f1, "mat_diffuse": f1,
            "mat_specular": f1, "mat_shininess": f1,
            "sphere_center": f3, "sphere_radius": f1,
            "plane_normal": f3, "plane_d": f1,
            "wall_start": f3, "wall_width": f1, "wall_height": f1,
            "tri_p1": f3, "tri_p2": f3, "tri_p3": f3, "origin": f3,
        }
        fields = {name: col(name, *spec) for name, spec in specs.items()}
        fields["animated"] = col("animated", (), bool, False)
        return FlatScene(**fields)


def wall_end(scene: FlatScene, idx=None) -> np.ndarray:
    """``Wall::end()`` (src/shapes/wall.hpp:16-31): the opposite corner,
    computed with the *tangent* basis (not the intersection's (u, v) basis
    — a reference quirk). Used by the BVH build for wall AABBs and
    centers. numpy, vectorised over shapes."""
    n = to_numpy(scene.plane_normal).astype(np.float32)
    start = to_numpy(scene.wall_start).astype(np.float32)
    w = to_numpy(scene.wall_width).astype(np.float32)
    h = to_numpy(scene.wall_height).astype(np.float32)
    if idx is not None:
        n, start, w, h = n[idx], start[idx], w[idx], h[idx]
    flat = n.ndim == 1
    if flat:
        n, start = n[None], start[None]
        w, h = np.atleast_1d(w), np.atleast_1d(h)
    use_x = np.abs(n[:, 0]) > np.abs(n[:, 1])
    t1 = np.where(use_x[:, None],
                  np.stack([-n[:, 2], np.zeros_like(n[:, 0]), n[:, 0]], -1),
                  np.stack([np.zeros_like(n[:, 0]), -n[:, 2], n[:, 1]], -1))
    t1n = np.linalg.norm(t1, axis=-1, keepdims=True)
    t1 = np.divide(t1, t1n, out=np.zeros_like(t1), where=t1n > 0)
    t2 = np.cross(n, t1)
    t2n = np.linalg.norm(t2, axis=-1, keepdims=True)
    t2 = np.divide(t2, t2n, out=np.zeros_like(t2), where=t2n > 0)
    end = start + w[:, None] * t1 + h[:, None] * t2
    return end[0] if flat else end
