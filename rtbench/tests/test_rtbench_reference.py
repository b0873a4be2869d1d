"""The reference follows the port's CPU path at a small frame within the
cells' limits, and its work count is deterministic."""

import pytest

from conftest import small_cell


@pytest.mark.parametrize("workload", ("scene1.fly", "scene2.fly"))
def test_fly_run_on_cpu_is_correct(workload):
    from rtbench import run
    cell = small_cell(workload, 2 ** 31 + 9)
    out = run.run_cell(cell, 0.5, False, "cpu")
    line = run.result_line(cell, out, False, "cpu")
    assert line["correct"], line["checks"]
    assert out["numbers"]["worst_frame_px"] == 0.0


@pytest.mark.parametrize("workload", ("scene1.fit", "scene2.fit"))
def test_fit_set_up_leaves_the_start_to_the_window(workload):
    """The set-up warms up without moving the parameters or filling the
    optimizer: the steps the check compares are the window's."""
    import torch

    from rtbench import fit
    cell = small_cell(workload, 2 ** 31 + 9)
    loop = fit.Loop(cell, "cpu")
    start = fit.start_values(cell.mix, loop.spec, cell.seed)
    for name, leaf in loop.leaves.items():
        assert torch.equal(leaf.detach(),
                           torch.tensor(start[name], dtype=torch.float32))
    assert not loop.opt.state and loop.rec == {"losses": []}


@pytest.mark.parametrize("workload", ("scene1.fit", "scene2.fit"))
def test_fit_run_on_cpu_is_correct(workload):
    from rtbench import run
    cell = small_cell(workload, 2 ** 31 + 9)
    out = run.run_cell(cell, 0.5, False, "cpu")
    line = run.result_line(cell, out, False, "cpu")
    assert line["correct"], line["checks"]


def test_work_count_deterministic():
    from rtbench import fly
    cell = small_cell("scene2.fly", 4)
    a, b = fly.work_count(cell, "cpu"), fly.work_count(cell, "cpu")
    assert a == b and a["ops"] > 0 and a["bound_ms"] > 0


@pytest.mark.parametrize("which", (1, 2))
def test_counting_tree_bounds_its_leaves(which):
    """Every shape sits in exactly one leaf of at most LEAF_MAX shapes,
    also where the upstream's tree keeps hundreds in one."""
    import json

    import numpy as np

    from conftest import ROOT
    from rtbench.reference import bvh, scene, tracer
    with open(ROOT / "rtbench" / "configs" / f"scene{which}.json") as f:
        spec = scene.make_scene(json.load(f), run_seed=5)
    tree = bvh.build_counting(spec.flat, tracer.LEAF_MAX)
    leaves = [tree.members[i] for i in np.nonzero(tree.left < 0)[0]]
    assert max(len(m) for m in leaves) <= tracer.LEAF_MAX
    assert np.array_equal(np.sort(np.concatenate(leaves)),
                          np.arange(spec.num_shapes))


def test_work_count_takes_the_lesser_tree():
    import torch

    from rtbench.reference import work
    flat = {}
    per_px = torch.tensor([10.0, 0, 0, 0, 100.0,    # upstream's tree
                           30.0, 0, 0, 0, 2.0])     # counting tree
    got = work.frame_work(per_px, flat, 4, 2)
    assert got["tree"] == 1
    assert got["ops"] == (30 * work.OPS["box"]
                          + 2 * work.OPS["triangle"]) * 8
