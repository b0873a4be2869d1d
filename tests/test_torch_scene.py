"""The PyTorch port's host side against the JAX package: scene generators,
the reference BVH, the SplitScene tables (bit-exact), and the port's
import and device rules."""

import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.accel.linearize import shape_leaf_boxes as jax_leaf_boxes
from raytracer_tpu.geom.direct import reflect as jax_reflect
from raytracer_tpu_torch import interop
from raytracer_tpu_torch.accel import build_bvh, linearize
from raytracer_tpu_torch.accel.linearize import shape_leaf_boxes
from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.geom.direct import reflect
from raytracer_tpu_torch.render import brute, packet, split_scene, wavefront
from raytracer_tpu_torch.render.split import render
from raytracer_tpu_torch.scenes import generate_scene

from torch_port_common import CAMERA_FIELDS, jax_scene, ported

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", params=[1, 2, 3])
def both(request):
    which = request.param
    sc_j, lin_j, split_j = jax_scene(which)
    sc_t = generate_scene(which, device="cpu")
    lin_t = linearize(build_bvh(sc_t.flat, sc_t.bvh_max_depth))
    return which, (sc_j, lin_j, split_j), (sc_t, lin_t)


def test_scene_generators_match(both):
    which, (sc_j, _, _), (sc_t, _) = both
    assert sc_t.num_shapes == {1: 1240, 2: 4122, 3: 1}[which]
    for name, arr in sc_t.flat.numpy().items():
        assert np.array_equal(arr, np.asarray(getattr(sc_j.flat, name))), \
            name
    # f32 trig differs by an ulp between the libraries
    for f in CAMERA_FIELDS:
        np.testing.assert_allclose(getattr(sc_t.camera, f).numpy(),
                                   np.asarray(getattr(sc_j.camera, f)),
                                   rtol=0, atol=1e-6)
    np.testing.assert_array_equal(sc_t.light.color.numpy(),
                                  np.asarray(sc_j.light.color))
    assert (sc_t.bvh_max_depth, sc_t.animated_indices) == \
        (sc_j.bvh_max_depth, sc_j.animated_indices)


def test_reference_bvh_matches(both):
    _, (sc_j, lin_j, _), (sc_t, lin_t) = both
    for f in ("bounds", "leaf_start", "leaf_count", "skip", "perm"):
        assert np.array_equal(getattr(lin_t, f).numpy(),
                              np.asarray(getattr(lin_j, f))), f
    for a, b in zip(shape_leaf_boxes(lin_t, sc_t.num_shapes),
                    jax_leaf_boxes(lin_j, sc_j.num_shapes)):
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_split_tables_match(both):
    """The port's prepare() against the JAX package's, table by table. The
    JAX tables carry padding rows for the TPU unroll; the port drops them,
    so its tables are the JAX tables' leading rows and the rest is zero."""
    _, (_, _, split_j), (sc_t, lin_t) = both
    split_t = split_scene.prepare(sc_t.flat, lin_t)
    assert (split_t.m, split_t.n_other, split_t.n_sph, split_t.n_tri,
            split_t.rid_values) == (split_j.m, split_j.n_other,
                                    split_j.n_sph, split_j.n_tri,
                                    split_j.rid_values)
    names = ("leaf_start", "leaf_count", "skip", "nodes", "pre_rows",
             "tri_rows")
    for name, t, j in zip(names, split_t.device_args(),
                          split_j.device_args()):
        t, j = t.numpy(), np.asarray(j)
        n = t.shape[0]
        assert np.array_equal(t, j[:n]), name
        assert not j[n:].any(), name


def test_from_numpy_carries_the_jax_tables():
    sc_j, _, split_j = jax_scene(1)
    p = ported(1)
    for name, t in zip(("leaf_start", "leaf_count", "skip", "nodes",
                        "pre_rows", "tri_rows"), p.split.device_args()):
        assert np.array_equal(t.numpy(),
                              np.asarray(getattr(split_j, name))), name
    assert p.split.n_tri == 1209 and p.split.max_id == 1239
    assert p.attr_tab.shape == (1240, 15)
    assert np.array_equal(p.flat.shape_type.numpy(),
                          np.asarray(sc_j.flat.shape_type))


def test_split_scene_refuses_a_walk_that_does_not_end():
    p = ported(3)
    with pytest.raises(ValueError, match="skip pointers"):
        split_scene.SplitScene(
            leaf_start=p.split.leaf_start, leaf_count=p.split.leaf_count,
            skip=torch.zeros_like(p.split.skip), nodes=p.split.nodes,
            pre_rows=p.split.pre_rows, tri_rows=p.split.tri_rows,
            m=p.split.m, n_other=0, n_sph=0, n_tri=p.split.n_tri,
            rid_values=(0,))


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "raytracer_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "raytracer_tpu"), \
                f"{path.relative_to(ROOT)} imports {name}"


# The renderers' entry points: render(scene, bvh, camera, light, cfg).
ENTRY_POINTS = {"split": render, "packet": packet.render,
                "brute": brute.render, "wavefront": wavefront.render}


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_render_without_a_device_needs_a_card(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    render_fn = ENTRY_POINTS[entry]
    sc = generate_scene(3, device="cpu")
    lin = linearize(build_bvh(sc.flat, sc.bvh_max_depth))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        render_fn(sc.flat, lin, sc.camera, sc.light,
                  RenderConfig(width=8, height=6))
    if entry == "split":
        with pytest.raises(RuntimeError, match="no CUDA device"):
            render(sc.flat, lin, sc.camera, sc.light,
                   RenderConfig(width=8, height=6, sort_bounces=True))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            generate_scene(3)
    img = render_fn(sc.flat, lin, sc.camera, sc.light,
                    RenderConfig(width=8, height=6), device="cpu")
    assert img.shape == (6, 8, 3) and torch.isfinite(img).all()


def test_recompute_tri_planes_matches_jax():
    """Planes refreshed from moved vertices keep each triangle's stored
    orientation, as the JAX package's refresh does."""
    sc_j, _, _ = jax_scene(1)
    rng = np.random.default_rng(5)
    moved = {f: np.asarray(getattr(sc_j.flat, f)).copy()
             for f in sc_j.flat.__dataclass_fields__}
    tri = moved["shape_type"] == 3
    for f in ("tri_p1", "tri_p2", "tri_p3"):
        moved[f][tri] += rng.normal(0, 0.05, moved[f][tri].shape).astype(
            np.float32)
    want = sc_j.flat.replace(**{f: jnp.asarray(moved[f]) for f in
                                ("tri_p1", "tri_p2", "tri_p3")}
                             ).recompute_tri_planes()
    got = interop.from_numpy(flat=moved, device="cpu").flat \
        .recompute_tri_planes()
    for f in ("plane_normal", "plane_d"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   rtol=1e-6, atol=1e-5)


def test_reflect_matches_jax():
    rng = np.random.default_rng(6)
    i, n = rng.normal(size=(2, 64, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    np.testing.assert_allclose(
        reflect(torch.from_numpy(i), torch.from_numpy(n)).numpy(),
        np.asarray(jax_reflect(jnp.asarray(i), jnp.asarray(n))),
        rtol=1e-6, atol=1e-6)
