"""822-triangle road grid in the y = 0 plane, x in [-60, 60], z in
[-20, 10] (car.obj's road, main.cpp:749-752)."""

import numpy as np


def make() -> np.ndarray:
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
    return np.asarray(tris, np.float32)
