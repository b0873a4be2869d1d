"""packet_kernel's warp-synchronous walk, compiled for the host.

``tools/host_check.py`` compiles the CUDA device code of
``raytracer_tpu_torch/csrc/raytrace.cuh`` with g++ under a host lane
policy: one thread runs the 32 lanes of a warp, a vote is a loop over
them, and the leaf rows are staged with cp.async's group semantics (a copy
lands only when a wait covers it). These tests hold that walk against
``packet.packet_plain`` bit for bit (t and the row) on scenes 1, 2 and a
scene with every shape type, in all four ``<MT, CULL>`` variants, on
seeded rays (a tenth parked, some NaN, some of zero direction, a count that
is not a multiple of 32); its per-lane counts against those of the
per-thread walk (``packet_walk``); and its warp node and row steps against
a count made here in numpy. Skipped only where g++ is absent.
"""

from __future__ import annotations

import functools
import importlib.util
import pathlib
import shutil

import numpy as np
import pytest
import torch

from raytracer_tpu_torch.accel import build_bvh, linearize
from raytracer_tpu_torch.core.camera import from_euler
from raytracer_tpu_torch.render import packet
from raytracer_tpu_torch.scenes import generate_scene

ROOT = pathlib.Path(__file__).resolve().parent.parent
N_RAYS = 3001   # 93 full warps and a partial one of 25 lanes
SCENES = ("scene1", "scene2", "typed")
VARIANTS = [(mt, cull) for mt in (False, True) for cull in (False, True)]


@functools.lru_cache(maxsize=None)
def _host_check():
    spec = importlib.util.spec_from_file_location(
        "host_check", ROOT / "tools" / "host_check.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def hc():
    return _host_check()


@pytest.fixture(scope="module")
def lib(hc, tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the host build of the device "
                    "code needs it")
    return hc.build(tmp_path_factory.mktemp("host_walks"))


@functools.lru_cache(maxsize=None)
def _scene(name):
    """(flat scene, reference LinearBVH, seeded rays o, d) on the CPU."""
    hc = _host_check()
    if name == "typed":
        flat = hc.typed_scene("cpu")
        lin = linearize(build_bvh(flat, 3))
        camera = from_euler(fov_deg=60, aspect=4 / 3)
    else:
        sc = generate_scene(int(name[-1]), device="cpu")
        flat, camera = sc.flat, sc.camera
        lin = linearize(build_bvh(flat, sc.bvh_max_depth))
    gen = torch.Generator().manual_seed(11)
    return (flat, lin) + hc.seeded_rays(camera, N_RAYS, gen)


@pytest.mark.parametrize("use_mt,t_cull", VARIANTS)
@pytest.mark.parametrize("scene", SCENES)
def test_warp_walk_matches_packet_plain(scene, use_mt, t_cull, hc, lib):
    flat, lin, o, d = _scene(scene)
    tree = packet.make_tree(lin, flat, t_cull=t_cull)
    (tw, rw), sw = hc.host_warp(lib, tree, o, d, use_mt, t_cull)
    tp, rp = packet.packet_plain(tree, o, d, use_mt, t_cull)
    assert torch.equal(tw, tp)
    assert torch.equal(rw, rp)
    assert bool((tp < 1e30).any()) and bool((tp >= 1e30).any())
    # each lane tests what its per-thread walk tests
    _, st = hc.host_packet(lib, tree, o, d, use_mt, t_cull)
    assert sw[:3] == st
    assert 0 < sw[4] and sw[0] + sw[2] <= 32 * sw[4]


def _slab_probe(nodes, o, d):
    """(R, m) bool: ray r probes node k without t-culling, with the slab
    test's f32 arithmetic (NaN propagates through min and max)."""
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        inv = np.float32(1.0) / d
        near, far = [], []
        for ax in range(3):
            a = (nodes[None, :, ax] - o[:, None, ax]) * inv[:, None, ax]
            b = (nodes[None, :, ax + 3] - o[:, None, ax]) * inv[:, None, ax]
            near.append(np.minimum(a, b))
            far.append(np.maximum(a, b))
        tmin = np.maximum(np.maximum(near[0], near[1]), near[2])
        tmax = np.minimum(np.minimum(far[0], far[1]), far[2])
        return (tmax >= tmin) & (tmax > 0)


def numpy_warp_steps(tree, o, d):
    """Node steps and row steps of the lockstep walk without t-culling,
    summed over the warps of 32 consecutive rays: each lane's skip-pointer
    walk over its box tests; a warp steps through the union of its lanes'
    nodes and tests every row of each leaf that some lane enters."""
    nodes = tree.nodes.numpy()
    count = tree.leaf_count.numpy().astype(np.int64)
    skip = tree.skip.numpy().astype(np.int64)
    o, d = o.numpy(), d.numpy()
    n, m = o.shape[0], nodes.shape[0]
    probe = _slab_probe(nodes, o, d)
    visit = np.zeros((n, m), dtype=bool)
    ptr = np.where((d == 0).all(1), m, 0)
    while (ptr < m).any():
        lanes = np.nonzero(ptr < m)[0]
        k = ptr[lanes]
        visit[lanes, k] = True
        inner = probe[lanes, k] & (count[k] == 0)
        ptr[lanes] = np.where(inner, k + 1, skip[k])
    enter = visit & probe & (count > 0)[None]
    pad = (-n) % 32
    visit = np.pad(visit, ((0, pad), (0, 0))).reshape(-1, 32, m).any(1)
    enter = np.pad(enter, ((0, pad), (0, 0))).reshape(-1, 32, m).any(1)
    return int(visit.sum()), int((enter * count[None]).sum())


@pytest.mark.parametrize("scene", SCENES)
def test_warp_steps_match_a_numpy_count(scene, hc, lib):
    flat, lin, o, d = _scene(scene)
    tree = packet.make_tree(lin, flat, t_cull=False)
    want = numpy_warp_steps(tree, o, d)
    for use_mt in (False, True):
        _, sw = hc.host_warp(lib, tree, o, d, use_mt, False)
        assert tuple(sw[3:]) == want
