"""2,000-triangle squashed rounded box standing in for car.obj's body
(generateScene2, main.cpp:729-776), lifted 5 units off the road (y-down
world)."""

import numpy as np

from ._uv import uv_sphere


def make() -> np.ndarray:
    def radius(theta, phi):
        x = np.sin(theta) * np.cos(phi)
        y = np.cos(theta)
        z = np.sin(theta) * np.sin(phi)
        denom = (abs(x / 10.0) ** 4 + abs(y / 3.0) ** 4
                 + abs(z / 4.0) ** 4) ** 0.25
        return 1.0 / max(denom, 1e-6)
    return uv_sphere(rows=21, cols=50, radius_fn=radius) + np.array(
        [0.0, -5.0, 0.0], np.float32)
