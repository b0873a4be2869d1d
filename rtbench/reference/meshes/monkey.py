"""968-triangle lumpy blob standing in for the upstream's monkey.obj
(generateScene1, main.cpp:647-662)."""

import numpy as np

from ._uv import uv_sphere


def make() -> np.ndarray:
    def radius(theta, phi):
        return (8.0 + 1.2 * np.sin(3 * theta) * np.cos(2 * phi)
                + 0.8 * np.cos(5 * phi) * np.sin(theta) ** 2)
    return uv_sphere(rows=23, cols=22, radius_fn=radius)
