"""The triangulated UV sphere that the blob meshes deform."""

import numpy as np


def uv_sphere(rows: int, cols: int, radius_fn) -> np.ndarray:
    """2 * cols * (rows - 1) triangles, (T, 3, 3) f32; ``radius_fn(theta,
    phi)`` gives each vertex's radius."""
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
            if i > 0:
                tris.append([a, b, c])
            if i < rows - 1:
                tris.append([b, d, c])
    return np.asarray(tris, np.float32)
