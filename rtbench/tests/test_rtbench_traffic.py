"""The traffic generator is deterministic in the seed, reads no clock,
and gives every seed the same views in another order."""

import json
import time

import numpy as np

from conftest import ROOT


def mix(name):
    with open(ROOT / "rtbench" / "traffic" / f"{name}.json") as f:
        return json.load(f)


def camera(which):
    with open(ROOT / "rtbench" / "configs" / f"scene{which}.json") as f:
        return json.load(f)["camera"]


def test_fly_path_deterministic_and_same_views():
    from rtbench.reference import traffic
    m, cam = mix("fly"), camera(1)
    a = traffic.fly_poses(m, cam, 2 ** 31 + 3)
    time.sleep(0.01)
    b = traffic.fly_poses(m, cam, 2 ** 31 + 3)
    c = traffic.fly_poses(m, cam, 17)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)
    assert a.shape == (m["path"]["period_frames"], 5)
    # the same views, started elsewhere or flown the other way round
    key = lambda p: p[np.lexsort(p.T)]  # noqa: E731
    assert np.array_equal(key(a), key(c))


def test_fly_path_stays_above_the_floor_and_near_the_target():
    from rtbench.reference import traffic
    for which in (1, 2):
        cam = camera(which)
        p = traffic.fly_poses(mix("fly"), cam, 5)
        dist = np.linalg.norm(p[:, :3] - np.asarray(cam["look_at"]), axis=1)
        d0 = np.linalg.norm(np.subtract(cam["position"], cam["look_at"]))
        assert dist.min() > 0.5 * d0 and dist.max() < 1.5 * d0
        assert (p[:, 1] < cam["look_at"][1] + 1e-9).all()


def test_fit_start_deterministic():
    from rtbench.reference import traffic
    for name in ("fit_sphere", "fit_pose"):
        m = mix(name)
        a, b = traffic.fit_start(m, 99), traffic.fit_start(m, 99)
        c = traffic.fit_start(m, 100)
        for prm in m["params"]:
            n = prm["name"]
            assert np.array_equal(a[n], b[n]) and not np.array_equal(a[n], c[n])
            if "offset_norm" in prm:
                assert np.isclose(np.linalg.norm(a[n]), prm["offset_norm"])
