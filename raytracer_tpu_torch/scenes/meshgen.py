"""Deterministic procedural meshes standing in for the reference's .obj
assets.

The reference repo ships only .mtl stubs — the monkey.obj / lowpolymonkey.obj
/ car.obj payloads are git-LFS pointers that are absent from the mount
(/root/reference/models contains only car.mtl, lowpolymonkey.mtl,
monkey.mtl). These generators produce meshes with the SAME triangle counts
and scene roles so shape totals, BVH shape, and performance characteristics
match the reference scenes:

  scene 1 "monkeys": monkey-class mesh 968 tris + low-poly mesh 240 tris
      -> 1240 shapes total (main.cpp:715 prints "shapes: 1240" per SURVEY)
  scene 2 "car": body 2000 + 4 wheels x 300 + road 822 = 4022 tris
      (+100 spheres)

All outputs are (T, 3, 3) float32 vertex arrays in mesh-local coordinates;
callers add the mesh origin like Mesh::mesh2triangles does
(src/mesh.hpp:163-189).
"""

from __future__ import annotations

import numpy as np


def _uv_sphere(rows: int, cols: int, radius_fn) -> np.ndarray:
    """Triangulated UV sphere: 2 * cols * (rows - 1) triangles.

    radius_fn(theta, phi) -> per-vertex radius, enabling blobby deformation.
    """
    verts = np.zeros((rows + 1, cols, 3), np.float64)
    for i in range(rows + 1):
        theta = np.pi * i / rows
        for j in range(cols):
            phi = 2 * np.pi * j / cols
            r = radius_fn(theta, phi)
            verts[i, j] = [r * np.sin(theta) * np.cos(phi),
                           r * np.cos(theta),
                           r * np.sin(theta) * np.sin(phi)]
    tris = []
    for i in range(rows):
        for j in range(cols):
            j2 = (j + 1) % cols
            a, b = verts[i, j], verts[i, j2]
            c, d = verts[i + 1, j], verts[i + 1, j2]
            if i > 0:          # top cap row produces one tri per col
                tris.append([a, b, c])
            if i < rows - 1:   # bottom cap row likewise
                tris.append([b, d, c])
    # counts: (rows-1)*cols + (rows-1)*cols = 2*cols*(rows-1)
    return np.asarray(tris, np.float32)


def monkey_mesh() -> np.ndarray:
    """968-triangle 'monkey-class' blob (stands in for monkey.obj,
    used by generateScene1, src/main.cpp:647-662)."""
    def radius(theta, phi):
        # deterministic lumpy head-ish shape
        return (8.0 + 1.2 * np.sin(3 * theta) * np.cos(2 * phi)
                + 0.8 * np.cos(5 * phi) * np.sin(theta) ** 2)
    m = _uv_sphere(rows=23, cols=22, radius_fn=radius)
    assert m.shape[0] == 968, m.shape
    return m


def lowpoly_monkey_mesh() -> np.ndarray:
    """240-triangle low-poly blob (stands in for lowpolymonkey.obj,
    generateScene1 src/main.cpp:664-680)."""
    def radius(theta, phi):
        return 6.0 + 0.9 * np.sin(2 * theta) * np.sin(3 * phi)
    m = _uv_sphere(rows=7, cols=20, radius_fn=radius)
    assert m.shape[0] == 240, m.shape
    return m


def car_body_mesh() -> np.ndarray:
    """2000-triangle car-body-class mesh (car.obj mesh 0,
    generateScene2 src/main.cpp:729-776). A squashed rounded box."""
    def radius(theta, phi):
        # superellipsoid-ish: stretch along x, squash along y
        x = np.sin(theta) * np.cos(phi)
        y = np.cos(theta)
        z = np.sin(theta) * np.sin(phi)
        denom = (abs(x / 10.0) ** 4 + abs(y / 3.0) ** 4
                 + abs(z / 4.0) ** 4) ** 0.25
        return 1.0 / max(denom, 1e-6)
    m = _uv_sphere(rows=21, cols=50, radius_fn=radius)
    # shift body upward a bit off the road (y-down world: negative y is up)
    m = m + np.array([0.0, -5.0, 0.0], np.float32)
    assert m.shape[0] == 2000, m.shape
    return m


def wheel_mesh(center: np.ndarray) -> np.ndarray:
    """300-triangle torus wheel centered at ``center`` with axis (0,0,1)
    (the rotation axis used by updateWheelAnimations, main.cpp:1097-1098)."""
    u_seg, v_seg = 15, 10          # 15*10 quads -> 300 tris
    R, r = 1.6, 0.6
    verts = np.zeros((u_seg, v_seg, 3), np.float64)
    for i in range(u_seg):
        a = 2 * np.pi * i / u_seg
        for j in range(v_seg):
            b = 2 * np.pi * j / v_seg
            verts[i, j] = [(R + r * np.cos(b)) * np.cos(a),
                           (R + r * np.cos(b)) * np.sin(a),
                           r * np.sin(b)]
    tris = []
    for i in range(u_seg):
        i2 = (i + 1) % u_seg
        for j in range(v_seg):
            j2 = (j + 1) % v_seg
            a, b = verts[i, j], verts[i, j2]
            c, d = verts[i2, j], verts[i2, j2]
            tris.append([a, b, c])
            tris.append([b, d, c])
    m = np.asarray(tris, np.float32) + np.asarray(center, np.float32)
    assert m.shape[0] == 300, m.shape
    return m


def road_mesh() -> np.ndarray:
    """822-triangle road grid (car.obj mesh 5, main.cpp:749-752).
    Grid of 137 x 3 quads in the y = 0 plane (the ground in the y-down
    world), spanning x in [-60, 60], z in [-20, 10]."""
    nx, nz = 137, 3
    xs = np.linspace(-60.0, 60.0, nx + 1)
    zs = np.linspace(-20.0, 10.0, nz + 1)
    tris = []
    for i in range(nx):
        for j in range(nz):
            a = [xs[i], 0.0, zs[j]]
            b = [xs[i + 1], 0.0, zs[j]]
            c = [xs[i], 0.0, zs[j + 1]]
            d = [xs[i + 1], 0.0, zs[j + 1]]
            tris.append([a, b, c])
            tris.append([b, d, c])
    m = np.asarray(tris, np.float32)
    assert m.shape[0] == 822, m.shape
    return m


def mesh_center(tris: np.ndarray, origin: np.ndarray) -> np.ndarray:
    """Mesh::center() (src/mesh.hpp:51-60): center = (origin + sum(origin +
    v)) / V over the V UNIQUE vertices. Our (T,3,3) arrays duplicate shared
    vertices; the reference iterates the vertex buffer. For the flip
    heuristic only the direction matters, and dedup keeps it faithful."""
    verts = np.unique(tris.reshape(-1, 3).round(6), axis=0)
    origin = np.asarray(origin, np.float64)
    v = verts.shape[0]
    return ((origin + (origin + verts.astype(np.float64)).sum(0)) / v
            ).astype(np.float32)
