"""The scene maker's arrays, fed through the port's scene builder, equal
the port's own ``generate_scene``; the reference's tree equals the
port's median tree."""

import json

import numpy as np
import pytest

from conftest import ROOT

SEEDS = (0, 2 ** 31 + 5)


def config(which):
    with open(ROOT / "rtbench" / "configs" / f"scene{which}.json") as f:
        return json.load(f)


@pytest.mark.parametrize("which", (1, 2))
@pytest.mark.parametrize("seed", SEEDS)
def test_scene_maker_equals_generate_scene(which, seed):
    from raytracer_tpu_torch.scenes import generate_scene
    from rtbench import port
    from rtbench.reference import scene as rs
    spec = rs.make_scene(config(which), seed=seed)
    want = generate_scene(which, seed=seed, device="cpu").flat.numpy()
    built = port.build_flat(spec.items, "cpu").numpy()
    for k, v in want.items():
        assert np.array_equal(built[k], v), k
        assert np.array_equal(spec.flat[k].astype(v.dtype), v), k


@pytest.mark.parametrize("which", (1, 2))
def test_reference_tree_equals_port_tree(which):
    from raytracer_tpu_torch.accel import build_bvh
    from rtbench import port
    from rtbench.reference import bvh as rb
    from rtbench.reference import scene as rs
    spec = rs.make_scene(config(which), run_seed=7)
    tree = rb.build(spec.flat, spec.bvh_max_depth)
    want = build_bvh(port.build_flat(spec.items, "cpu"), spec.bvh_max_depth)
    assert np.array_equal(tree.bmin, want.bounds_min)
    assert np.array_equal(tree.bmax, want.bounds_max)
    assert np.array_equal(tree.left, want.left)
    assert np.array_equal(tree.right, want.right)
    assert [len(m) for m in tree.members] == want.count.tolist()


@pytest.mark.parametrize("which", (1, 2))
def test_run_seed_changes_colours_only(which):
    from rtbench.reference import scene as rs
    a = rs.make_scene(config(which), run_seed=1).flat
    b = rs.make_scene(config(which), run_seed=2 ** 31 + 1).flat
    for k in a:
        if k != "mat_color":
            assert np.array_equal(a[k], b[k]), k
    assert not np.array_equal(a["mat_color"], b["mat_color"])
