"""Model/Mesh-equivalent convenience layer over the OBJ parser (port of
``raytracer_tpu/io/model.py``; ``add_to`` goes through the port's
SceneBuilder).

Reference: Model (src/model.hpp:25-202) loads a file into per-mesh vertex
buffers; Mesh::mesh2triangles (src/mesh.hpp:163-189) emits world-space
triangles offset by ``mesh.origin`` with the flip-toward-center normal
heuristic. This module reproduces that consumption path on top of
io/obj.py (or the native parser when available).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from raytracer_tpu_torch.core.scene import SceneBuilder
from raytracer_tpu_torch.core.types import Material
from raytracer_tpu_torch.io.obj import load_obj, load_obj_full
from raytracer_tpu_torch.scenes.meshgen import mesh_center


@dataclasses.dataclass
class Mesh:
    """Triangles in mesh-local coordinates + a placement origin
    (Mesh::origin, assigned by callers as in generateScene1/2). Vertex
    attributes beyond positions (normals/UVs/tangents/bitangents — what
    the reference's processMesh extracts, model.hpp:86-168) are carried
    when the model was loaded with attributes; the render path ignores
    them, exactly as the reference's does."""

    name: str
    triangles: np.ndarray                     # (T, 3, 3) f32, local coords
    origin: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32))
    normals: Optional[np.ndarray] = None      # (T, 3, 3) f32 unit
    uvs: Optional[np.ndarray] = None          # (T, 3, 2) f32
    tangents: Optional[np.ndarray] = None     # (T, 3, 3) f32
    bitangents: Optional[np.ndarray] = None   # (T, 3, 3) f32

    @property
    def num_triangles(self) -> int:
        return int(self.triangles.shape[0])

    def world_triangles(self) -> np.ndarray:
        """mesh2triangles positions: vertex + origin (mesh.hpp:170-172)."""
        return self.triangles + np.asarray(self.origin, np.float32)

    def center(self) -> np.ndarray:
        """Mesh::center() (mesh.hpp:51-60) — used by the normal-flip
        heuristic."""
        return mesh_center(self.triangles, self.origin)

    def add_to(self, builder: SceneBuilder,
               material: Optional[Material] = None,
               animated: bool = False,
               flip_normals: bool = True) -> List[int]:
        """mesh2triangles + push_back (main.cpp:651-661): emit world-space
        triangles with the dot(normal, center) > 0 flip heuristic."""
        center = self.center() if flip_normals else None
        return builder.add_triangles(self.world_triangles(), material,
                                     flip_toward_center=center,
                                     animated=animated)


class Model:
    """Model(path): all meshes of an OBJ file, in file order
    (model.hpp:49-84). With ``attributes=True`` each mesh also carries
    normals/UVs/tangents/bitangents, the reference's full processMesh
    extraction (model.hpp:86-168 under aiProcess_GenSmoothNormals |
    FlipUVs | CalcTangentSpace)."""

    def __init__(self, path: str, use_native: bool = True,
                 attributes: bool = False):
        if attributes:
            full = load_obj_full(path)
            self.meshes = [Mesh(name=k, triangles=m.positions,
                                normals=m.normals, uvs=m.uvs,
                                tangents=m.tangents,
                                bitangents=m.bitangents)
                           for k, m in full.items()]
            return
        meshes: Dict[str, np.ndarray] = None
        if use_native:
            try:
                from raytracer_tpu_torch import native
                if native.available():
                    # the native parser concatenates; fall through to the
                    # python parser for per-mesh grouping unless single mesh
                    meshes = load_obj(path)
            except Exception:
                meshes = None
        if meshes is None:
            meshes = load_obj(path)
        self.meshes = [Mesh(name=k, triangles=v) for k, v in meshes.items()]

    def __len__(self):
        return len(self.meshes)
