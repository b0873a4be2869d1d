"""The one traffic generator: it reads a mix's parameters
(``rtbench/traffic/<mix>.json``) and the run's seed, and gives the work
that the window offers, as NumPy arrays on the host. Nothing here reads a
clock: the same seed gives the same work, whatever the program's speed.

``fly``: a camera path over ``period_frames`` frames, a function of the
frame index (``dt`` of simulated time a frame), that orbits the
configuration's look-at target. Over one period the orbit turns
``orbit_cycles`` times, the distance swings between ``radius_scale`` of
the configuration's camera's (``radius_cycles`` times), the height swings
by ``height_swing`` of the camera's own height above the target
(``height_cycles``), and mouse-look adds ``look_jitter_deg`` (yaw, pitch)
at ``look_cycles``. The seed picks only where on the closed path the run
starts and which way round it flies it, so every seed offers the same
views, in another order.

``fit``: each fitted parameter's starting value: an offset of
``offset_norm`` in a direction drawn from the seed, or a value drawn
uniformly from ``[low, high)``.
"""

from __future__ import annotations

import numpy as np


def rng(seed: int, stream: int) -> np.random.Generator:
    """An independent generator for each use of the seed."""
    return np.random.default_rng([int(seed) & (2 ** 63 - 1), stream])


def look_angles(direction) -> tuple:
    """(yaw, pitch) in degrees of a direction (camera.hpp:139-148)."""
    d = np.asarray(direction, np.float64)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return (np.degrees(np.arctan2(d[..., 2], d[..., 0])),
            np.degrees(np.arcsin(d[..., 1])))


def fly_poses(mix: dict, camera: dict, seed: int) -> np.ndarray:
    """(period_frames, 5) float64 rows x, y, z, yaw, pitch: frame k of
    the run takes row k mod period_frames."""
    p = mix["path"]
    n = int(p["period_frames"])
    g = rng(seed, 1)
    k0 = int(g.integers(0, n))
    sign = 1 if g.integers(0, 2) else -1
    u = np.arange(n) / n
    target = np.asarray(camera["look_at"], np.float64)
    v0 = np.asarray(camera["position"], np.float64) - target
    dh0 = np.hypot(v0[0], v0[2])
    th0 = np.arctan2(v0[2], v0[0])
    lo, hi = p["radius_scale"]
    scale = (lo + hi) / 2 + (hi - lo) / 2 * np.sin(
        2 * np.pi * p["radius_cycles"] * u)
    th = th0 + 2 * np.pi * p["orbit_cycles"] * u
    h = v0[1] * (1.0 + p["height_swing"] * np.sin(
        2 * np.pi * p["height_cycles"] * u))
    pos = target + scale[:, None] * np.stack(
        [dh0 * np.cos(th), h, dh0 * np.sin(th)], -1)
    yaw, pitch = look_angles(target - pos)
    jy, jp = p["look_jitter_deg"]
    cy, cp = p["look_cycles"]
    yaw = yaw + jy * np.sin(2 * np.pi * cy * u)
    pitch = np.clip(pitch + jp * np.sin(2 * np.pi * cp * u), -89.0, 89.0)
    views = np.concatenate([pos, yaw[:, None], pitch[:, None]], 1)
    return views[(k0 + sign * np.arange(n)) % n]


def fit_start(mix: dict, seed: int) -> dict:
    """Each fitted parameter's starting offset or value, by name."""
    g = rng(seed, 2)
    out = {}
    for prm in mix["params"]:
        if "offset_norm" in prm:
            v = g.standard_normal(3)
            out[prm["name"]] = prm["offset_norm"] * v / np.linalg.norm(v)
        else:
            out[prm["name"]] = g.uniform(prm["low"], prm["high"], 3)
    return out


def sample_pixels(seed: int, stream: int, n_pixels: int, k: int
                  ) -> np.ndarray:
    """``k`` distinct pixel indices of a frame, drawn from the seed."""
    return np.sort(rng(seed, 100 + stream).choice(n_pixels, size=k,
                                                  replace=False))


def look_at_pose(position, target) -> np.ndarray:
    """(x, y, z, yaw, pitch) of a camera at ``position`` looking at
    ``target``."""
    yaw, pitch = look_angles(np.asarray(target, np.float64)
                             - np.asarray(position, np.float64))
    return np.array([*np.asarray(position, np.float64), yaw, pitch])
