"""The lockstep walks of packet_kernel, occlusion_kernel, brute_kernel,
closest_hit_kernel, wholeframe_kernel, fused_kernel and
closest_attrs_kernel, compiled for the host.

``tools/host_check.py`` compiles the CUDA device code of
``raytracer_tpu_torch/csrc/raytrace.cuh`` with g++ under a host lane
policy: one thread runs the 32 lanes of a warp, a vote is a loop over
them, and staged rows and run tables land with cp.async's group semantics
(a copy lands only when a wait covers it). These tests hold the walks
against their plain versions bit for bit on scenes 1, 2 (3) and a scene
with every shape type, on seeded rays (a tenth parked, some NaN, some of
zero direction, a count that is not a multiple of 32):
- packet_kernel's ``warp_walk`` against ``packet.packet_plain`` (t and the
  row) in all four ``<MT, CULL>`` variants; its per-lane counts against
  those of the per-thread walk (``packet_walk``); its warp node and row
  steps against a count made here in numpy;
- occlusion_kernel's ``warp_walk`` in occlusion mode against
  ``packet.occlusion_plain`` and the per-thread ``packet_walk<MT, CULL,
  true>`` (the answer and each lane's counts), in all four variants;
- brute_kernel's ``brute_walk`` against ``brute.brute_plain`` (t and the
  row), gate and Moller-Trumbore on and off, with the run table staged
  whole and in chunks; its row tests against the rows whose leaf box each
  ray hits, counted here;
- closest_hit_kernel's ``split_walk`` against ``closest_hit_plain`` (t
  and the gid, and occlusion) for the raw, Gram and MT triangle tests, and
  its per-lane counts against those of the per-thread walks
  (``closest_walk``, ``occluded``);
- wholeframe_kernel's lockstep trace (``warp_trace``) against the
  per-thread ``trace_ray`` over the kernel's grid at 37x23 (partial tiles
  and warps), in raygen, raygen + emit and consume + emit mode (on the
  re-packed, sorted state: parked rays last, a partial last warp; 6 and 9
  rows): colours and state bit for bit, each lane's closest-walk tests
  against ``closest_walk``'s and its shadow-leg tests against
  ``occluded``'s, and colours and state also against ``trace_ray`` with
  the closest-mode shadow leg; default, raw, MT + Fresnel and unshadowed
  5-bounce configurations;
- fused_kernel's lockstep walk (``warp_fused``: the closest-mode split
  walk, then the any-hit split walk of the shadow rays) against
  ``fused_plain`` (t, gid and in_shadow), and its per-lane closest-walk and
  shadow-leg counts against the per-thread ``fused_ray<TRI, true>``'s; the
  outputs of ``fused_ray`` with either shadow leg against ``fused_plain``;
  raw, Gram and MT, toward the scene's light;
- closest_attrs_kernel's walk (the split walk, then ``split_attrs``)
  against ``closest_hit_attrs_plain`` (t, gid and the 11 attributes), and
  its per-lane counts against the per-thread ``closest_walk<TRI, true,
  true>``'s, whose outputs are held against the plain version too.
Skipped only where g++ is absent.
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
from raytracer_tpu_torch.accel.linearize import shape_leaf_boxes
from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.core.camera import from_euler
from raytracer_tpu_torch.geom import rowwise
from raytracer_tpu_torch.render import brute, packet, split_scene
from raytracer_tpu_torch.render.split import (closest_hit_attrs_plain,
                                              closest_hit_plain, fused_plain)
from raytracer_tpu_torch.scenes import generate_scene

ROOT = pathlib.Path(__file__).resolve().parent.parent
N_RAYS = 3001   # 93 full warps and a partial one of 25 lanes
SCENES = ("scene1", "scene2", "typed")
ALL_SCENES = ("scene1", "scene2", "scene3", "typed")
WHOLE = 3000   # runs per chunk: every table staged at once
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
def _generated(which):
    return generate_scene(which, device="cpu")


@functools.lru_cache(maxsize=None)
def _scene(name):
    """(flat scene, reference LinearBVH, seeded rays o, d) on the CPU."""
    hc = _host_check()
    if name == "typed":
        flat = hc.typed_scene("cpu")
        lin = linearize(build_bvh(flat, 3))
        camera = from_euler(fov_deg=60, aspect=4 / 3)
    else:
        sc = _generated(int(name[-1]))
        flat, camera = sc.flat, sc.camera
        lin = linearize(build_bvh(flat, sc.bvh_max_depth))
    gen = torch.Generator().manual_seed(11)
    return (flat, lin) + hc.seeded_rays(camera, N_RAYS, gen)


@functools.lru_cache(maxsize=None)
def _split_light(name):
    """(split tables, light position) of the scene on the CPU."""
    flat, lin = _scene(name)[:2]
    light = (_host_check().TYPED_LIGHT if name == "typed"
             else _generated(int(name[-1])).light.position)
    return split_scene.prepare(flat, lin), light


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


def _rows_hitting_boxes(runs, o, d):
    """Summed over the rays of nonzero direction (the others hit nothing),
    the rows of each run whose box the ray hits (the gate's slab test)."""
    keep = (d != 0).any(1)
    o, d = o[keep], d[keep]
    tmin, tmax = rowwise.slab(runs[None, :, :6], o[:, None], 1.0 / d[:, None])
    hit = (tmax >= tmin) & (tmax > 0)
    return int((hit.sum(0) * runs[:, 7].long()).sum())


@pytest.mark.parametrize("scene", ALL_SCENES)
def test_brute_walk_matches_brute_plain(scene, hc, lib):
    flat, lin, o, d = _scene(scene)
    perm, counts = brute.sort_scene_by_type(flat)
    boxes = shape_leaf_boxes(lin, flat.num_shapes)
    for gate in (False, True):
        rows = brute.pack_rows_ext(flat, perm, boxes if gate else None)
        runs = brute.box_runs(rows, counts, gate)
        assert int(runs[:, 7].sum()) == rows.shape[0]
        for use_mt in (False, True):
            tp, rp = brute.brute_plain(rows, counts, o, d, use_mt, gate)
            for chunk in (hc.RUN_CHUNK, WHOLE):
                (tk, rk), st = hc.host_brute(lib, rows, runs, counts, o, d,
                                             use_mt, gate, chunk)
                assert torch.equal(tk, tp) and torch.equal(rk, rp)
                gates, tests, steps = st
                walks = int((d != 0).any(1).sum())
                assert walks < o.shape[0]   # zero-direction rays walk not
                assert gates == (walks * runs.shape[0] if gate else 0)
                if gate:
                    assert tests == _rows_hitting_boxes(runs, o, d)
                else:
                    assert tests == walks * rows.shape[0]
                assert tests <= 32 * steps
    assert bool((tp < 1e30).any()) and bool((tp >= 1e30).any())


@pytest.mark.parametrize("scene", ALL_SCENES)
def test_split_walk_matches_closest_hit_plain(scene, hc, lib):
    flat, lin, o, d = _scene(scene)
    split = split_scene.prepare(flat, lin)
    for tri_mode in (0, 1, 2):
        (tw, gw), cw, _ = hc.host_closest(lib, split, o, d, tri_mode,
                                          warp=True)
        tp, gp = closest_hit_plain(split, o, d, tri_mode)
        assert torch.equal(tw, tp) and torch.equal(gw, gp)
        _, ck = hc.host_closest(lib, split, o, d, tri_mode)
        assert torch.equal(cw, ck)   # each lane's pre, node, tri tests
        limit = hc.occlusion_limits(tp)
        ow, cow, _ = hc.host_closest(lib, split, o, d, tri_mode, limit,
                                     warp=True)
        op = closest_hit_plain(split, o, d, tri_mode, max_t=limit)[0] == 0
        assert torch.equal(ow, op)
        _, cok = hc.host_closest(lib, split, o, d, tri_mode, limit)
        assert torch.equal(cow, cok)
    assert bool((tp < 1e30).any()) and bool(op.any())


@pytest.mark.parametrize("scene", SCENES)
def test_warp_occlusion_matches_packet_walk(scene, hc, lib):
    flat, lin, o, d = _scene(scene)
    for use_mt, t_cull in VARIANTS:
        tree = packet.make_tree(lin, flat, t_cull=t_cull)
        tp, _ = packet.packet_plain(tree, o, d, use_mt, t_cull)
        limit = hc.occlusion_limits(tp)
        ow, sw, cw = hc.host_warp(lib, tree, o, d, use_mt, t_cull, limit,
                                  lanes=True)
        op = packet.occlusion_plain(tree, o, d, limit, use_mt, t_cull)
        assert torch.equal(ow, op)
        ok, ck = hc.host_packet(lib, tree, o, d, use_mt, t_cull, limit,
                                lanes=True)
        assert torch.equal(ok, op)
        assert torch.equal(cw, ck)   # each lane's tests, up to its hit
        assert 0 < sw[4] and sw[0] + sw[2] <= 32 * sw[4]
        assert bool(op.any()) and not bool(op.all())


@pytest.mark.parametrize("scene", SCENES)
def test_frame_trace_matches_trace_ray(scene, hc, lib):
    split, tab, par = hc.frame_inputs(
        "typed" if scene == "typed" else int(scene[-1]))
    n = hc.FRAME_W * hc.FRAME_H
    for name, kw in hc.FRAME_VARIANTS:
        cfg = RenderConfig(width=hc.FRAME_W, height=hc.FRAME_H,
                           **{"max_bounces": 3, **kw})
        diffs, parked = hc.check_frame(lib, split, tab, par, cfg)
        assert not any(diffs.values()), (name, diffs)
        assert 0 < parked < n   # the consume stream has both kinds


@pytest.mark.parametrize("scene", SCENES)
def test_fused_walk_matches_fused_plain(scene, hc, lib):
    split, light = _split_light(scene)
    o, d = _scene(scene)[2:]
    eps = RenderConfig().shadow_eps
    for tri_mode in (0, 1, 2):
        plain = fused_plain(split, o, d, light, tri_mode, eps)
        warp, cw, steps = hc.host_fused(lib, split, o, d, light, tri_mode,
                                        eps)
        assert all(torch.equal(a, b) for a, b in zip(warp, plain))
        assert steps[1] > 0
        # each lane's closest-walk and shadow-leg tests are those of the
        # per-thread walk with the any-hit shadow leg
        for how in (1, 2):
            per_thread, ck, _ = hc.host_fused(lib, split, o, d, light,
                                              tri_mode, eps, how)
            assert all(torch.equal(a, b) for a, b in zip(per_thread, plain))
            if how == 1:
                assert torch.equal(cw, ck)
    t, _, in_shadow = plain
    assert bool((t < 1e30).any()) and bool((t >= 1e30).any())
    assert bool(in_shadow.any()) and not bool(in_shadow[t < 1e30].all())


@pytest.mark.parametrize("scene", SCENES)
def test_attrs_walk_matches_attrs_plain(scene, hc, lib):
    split, _ = _split_light(scene)
    o, d = _scene(scene)[2:]
    for tri_mode in (0, 1, 2):
        plain = closest_hit_attrs_plain(split, o, d, tri_mode)
        warp, cw, steps = hc.host_attrs(lib, split, o, d, tri_mode, warp=True)
        assert all(torch.equal(a, b) for a, b in zip(warp, plain))
        assert steps[1] > 0
        per_thread, ck, _ = hc.host_attrs(lib, split, o, d, tri_mode)
        assert all(torch.equal(a, b) for a, b in zip(per_thread, plain))
        assert torch.equal(cw, ck)   # each lane's pre, node, tri tests
    t, _, attrs = plain
    hit = t < 1e30
    assert bool(hit.any()) and not bool(hit.all())
    assert bool((attrs[:, ~hit] == 0).all()) and bool((attrs[3:6, hit] > 0)
                                                      .any())
