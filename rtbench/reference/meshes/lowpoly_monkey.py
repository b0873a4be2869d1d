"""240-triangle blob standing in for the upstream's lowpolymonkey.obj
(generateScene1, main.cpp:664-680)."""

import numpy as np

from ._uv import uv_sphere


def make() -> np.ndarray:
    def radius(theta, phi):
        return 6.0 + 0.9 * np.sin(2 * theta) * np.sin(3 * phi)
    return uv_sphere(rows=7, cols=20, radius_fn=radius)
