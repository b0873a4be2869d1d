"""300-triangle torus wheel about ``center``, axis (0, 0, 1), standing in
for car.obj's wheels (main.cpp:757-782)."""

import numpy as np


def make(center) -> np.ndarray:
    u_seg, v_seg = 15, 10
    big, small = 1.6, 0.6
    verts = np.zeros((u_seg, v_seg, 3), np.float64)
    for i in range(u_seg):
        a = 2 * np.pi * i / u_seg
        for j in range(v_seg):
            b = 2 * np.pi * j / v_seg
            verts[i, j] = [(big + small * np.cos(b)) * np.cos(a),
                           (big + small * np.cos(b)) * np.sin(a),
                           small * np.sin(b)]
    tris = []
    for i in range(u_seg):
        i2 = (i + 1) % u_seg
        for j in range(v_seg):
            j2 = (j + 1) % v_seg
            a, b = verts[i, j], verts[i, j2]
            c, d = verts[i2, j], verts[i2, j2]
            tris.append([a, b, c])
            tris.append([b, d, c])
    return np.asarray(tris, np.float32) + np.asarray(center, np.float32)
