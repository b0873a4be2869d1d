"""Minimal OBJ parser (port of ``raytracer_tpu/io/obj.py``: numpy, the
same parse).

The reference imports models through Assimp with triangulation
(src/model.hpp:53: aiProcess_Triangulate | GenSmoothNormals | FlipUVs |
CalcTangentSpace) and extracts positions/normals/UVs/tangents per vertex
(model.hpp:86-168). The render path only ever consumes triangulated
POSITIONS (Mesh::mesh2triangles, src/mesh.hpp:163-189 — normals are
recomputed geometrically per triangle), so ``load_obj`` stays
positions-only; ``load_obj_full`` provides the full attribute set with the
same postprocess semantics (smooth normals generated when the file has
none, V flipped like FlipUVs, tangent space from UVs like
CalcTangentSpace).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np


def load_obj(path: str) -> Dict[str, np.ndarray]:
    """Parse an OBJ file into {object_name: (T, 3, 3) float32 triangles}.

    Supports v / f (with v, v/vt, v/vt/vn, v//vn forms, negative indices),
    o/g object grouping, fan triangulation of n-gons. Everything else is
    ignored.
    """
    verts: List[List[float]] = []
    objects: Dict[str, List] = {}
    current = "default"

    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            tag = parts[0]
            if tag == "v":
                verts.append([float(parts[1]), float(parts[2]),
                              float(parts[3])])
            elif tag in ("o", "g") and len(parts) > 1:
                current = parts[1]
            elif tag == "f":
                idx = []
                for p in parts[1:]:
                    s = p.split("/")[0]
                    i = int(s)
                    idx.append(i - 1 if i > 0 else len(verts) + i)
                tris = objects.setdefault(current, [])
                for k in range(1, len(idx) - 1):  # fan triangulation
                    tris.append((idx[0], idx[k], idx[k + 1]))

    v = np.asarray(verts, np.float32)
    return {name: v[np.asarray(t, np.int64)]
            for name, t in objects.items() if t}


@dataclasses.dataclass
class MeshData:
    """Per-mesh triangulated vertex attributes, corner-expanded to (T, 3, k)
    like the reference's Vertex buffers (model.hpp:86-168):
    positions always present; normals smooth-generated when the file lacks
    ``vn`` (GenSmoothNormals); uvs zero-filled when absent, V flipped
    (FlipUVs); tangents/bitangents derived from UVs (CalcTangentSpace),
    zero where UVs are degenerate."""

    positions: np.ndarray    # (T, 3, 3) f32
    normals: np.ndarray      # (T, 3, 3) f32, unit
    uvs: np.ndarray          # (T, 3, 2) f32
    tangents: np.ndarray     # (T, 3, 3) f32
    bitangents: np.ndarray   # (T, 3, 3) f32


def _smooth_normals(v: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted per-vertex normals over shared positions — the
    GenSmoothNormals analogue. Returns (V, 3) unit normals."""
    p = v[faces]                                      # (T, 3, 3)
    fn = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])  # area-weighted
    acc = np.zeros_like(v)
    for c in range(3):
        np.add.at(acc, faces[:, c], fn)
    norm = np.linalg.norm(acc, axis=1, keepdims=True)
    return acc / np.maximum(norm, 1e-20)


def _tangent_space(pos: np.ndarray, uv: np.ndarray):
    """Per-triangle tangent/bitangent from the UV parameterization
    (CalcTangentSpace analogue; the standard edge/delta-UV solve).
    pos (T, 3, 3), uv (T, 3, 2) -> two (T, 3) arrays, broadcast to
    corners by the caller."""
    e1 = pos[:, 1] - pos[:, 0]
    e2 = pos[:, 2] - pos[:, 0]
    du1 = uv[:, 1] - uv[:, 0]
    du2 = uv[:, 2] - uv[:, 0]
    det = du1[:, 0] * du2[:, 1] - du2[:, 0] * du1[:, 1]
    ok = np.abs(det) > 1e-12
    inv = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)[:, None]
    tan = inv * (du2[:, 1:2] * e1 - du1[:, 1:2] * e2)
    bit = inv * (du1[:, 0:1] * e2 - du2[:, 0:1] * e1)

    def unit(x):
        n = np.linalg.norm(x, axis=1, keepdims=True)
        return np.where(n > 1e-20, x / np.maximum(n, 1e-20), 0.0)

    return unit(tan).astype(np.float32), unit(bit).astype(np.float32)


def load_obj_full(path: str) -> Dict[str, MeshData]:
    """Parse an OBJ into {object_name: MeshData} with the full per-vertex
    attribute set the reference's Model extracts (positions, normals, UVs,
    tangent space — model.hpp:86-168). Supports the same face forms as
    ``load_obj``."""
    verts: List[List[float]] = []
    norms: List[List[float]] = []
    uvs: List[List[float]] = []
    # per object: list of 3 corners, each (v_idx, vt_idx|-1, vn_idx|-1)
    objects: Dict[str, List] = {}
    current = "default"

    def resolve(i: int, n: int) -> int:
        return i - 1 if i > 0 else n + i

    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            tag = parts[0]
            if tag == "v":
                verts.append([float(parts[1]), float(parts[2]),
                              float(parts[3])])
            elif tag == "vn":
                norms.append([float(parts[1]), float(parts[2]),
                              float(parts[3])])
            elif tag == "vt":
                uvs.append([float(parts[1]),
                            float(parts[2]) if len(parts) > 2 else 0.0])
            elif tag in ("o", "g") and len(parts) > 1:
                current = parts[1]
            elif tag == "f":
                corners = []
                for p in parts[1:]:
                    s = p.split("/")
                    vi = resolve(int(s[0]), len(verts))
                    ti = resolve(int(s[1]), len(uvs)) \
                        if len(s) > 1 and s[1] else -1
                    ni = resolve(int(s[2]), len(norms)) \
                        if len(s) > 2 and s[2] else -1
                    corners.append((vi, ti, ni))
                tris = objects.setdefault(current, [])
                for k in range(1, len(corners) - 1):
                    tris.append((corners[0], corners[k], corners[k + 1]))

    v = np.asarray(verts, np.float32).reshape(-1, 3)
    vn = np.asarray(norms, np.float32).reshape(-1, 3)
    vt = np.asarray(uvs, np.float32).reshape(-1, 2)

    out: Dict[str, MeshData] = {}
    for name, tris in objects.items():
        if not tris:
            continue
        c = np.asarray(tris, np.int64)               # (T, 3, 3) index trip
        fv, ft, fn = c[..., 0], c[..., 1], c[..., 2]
        pos = v[fv]
        if len(vn) and (fn >= 0).all():
            nrm = vn[fn]
            ln = np.linalg.norm(nrm, axis=-1, keepdims=True)
            nrm = nrm / np.maximum(ln, 1e-20)
        else:                                        # GenSmoothNormals
            nrm = _smooth_normals(v, fv)[fv]
        if len(vt) and (ft >= 0).all():
            uv = vt[ft].copy()
            uv[..., 1] = 1.0 - uv[..., 1]            # FlipUVs
        else:
            uv = np.zeros(pos.shape[:2] + (2,), np.float32)
        tan, bit = _tangent_space(pos, uv)
        out[name] = MeshData(
            positions=pos.astype(np.float32),
            normals=nrm.astype(np.float32),
            uvs=uv.astype(np.float32),
            tangents=np.broadcast_to(tan[:, None], pos.shape).copy(),
            bitangents=np.broadcast_to(bit[:, None], pos.shape).copy())
    return out


def obj_to_triangles(path: str) -> np.ndarray:
    """All triangles of all objects concatenated, (T, 3, 3) f32."""
    meshes = load_obj(path)
    if not meshes:
        return np.zeros((0, 3, 3), np.float32)
    return np.concatenate(list(meshes.values()), axis=0)
