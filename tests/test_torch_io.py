"""The port's IO (``io/image.py``, ``io/obj.py``, ``io/model.py``,
``io/checkpoint.py``) and native scene prep (``native.py``) against the
JAX package and the port's Python builders. All exact: PNG bytes, parsed
arrays, checkpoint fields and the native tables equal bit for bit."""

import shutil

import numpy as np
import pytest
import torch

from raytracer_tpu.core.scene import SceneBuilder as JaxBuilder
from raytracer_tpu.core.types import Material as JaxMaterial
from raytracer_tpu.io import checkpoint as jax_ckpt
from raytracer_tpu.io import image as jax_image
from raytracer_tpu.io import model as jax_model
from raytracer_tpu.io import obj as jax_obj
from raytracer_tpu.scenes import generate_scene3 as jax_scene3
from raytracer_tpu_torch import native
from raytracer_tpu_torch.accel import build_bvh, linearize
from raytracer_tpu_torch.core.scene import _FIELDS, SceneBuilder
from raytracer_tpu_torch.core.types import Material
from raytracer_tpu_torch.geom.aabb import shape_aabbs, shape_centers
from raytracer_tpu_torch.io import checkpoint, image, model, obj
from raytracer_tpu_torch.scenes import generate_scene

OBJ = """# comment
o quad
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
vt 0 0
vt 1 0
vt 1 1
vt 0 1
vn 0 0 1
f 1/1/1 2/2/1 3/3/1 4/4/1
g pent
v 5 5 5
v 6 5 5
v 6.5 6 5
v 5.5 7 5.5
v 4.5 6 5
f -5 -4/2 -3//1 -2 -1
o bare
v 0 0 5
v 1 0 5
v 0 1 5
f 10 11 12
"""


def test_png_bytes_match_jax(tmp_path):
    """Float (clamped), uint8 and grey images, from numpy and from a
    tensor: the same file bytes as the JAX writer; read_png round-trips."""
    rng = np.random.default_rng(0)
    imgs = [rng.uniform(-0.2, 1.3, (7, 5, 3)).astype(np.float32),
            rng.integers(0, 256, (4, 9, 3)).astype(np.uint8),
            rng.uniform(0, 1, (3, 6)).astype(np.float32)]
    for i, img in enumerate(imgs):
        want, got = tmp_path / f"j{i}.png", tmp_path / f"p{i}.png"
        jax_image.write_png(str(want), img)
        image.write_png(str(got), torch.from_numpy(img))
        assert got.read_bytes() == want.read_bytes()
        back = image.read_png(str(got))
        np.testing.assert_array_equal(back, jax_image.read_png(str(want)))
        if img.ndim == 3:
            np.testing.assert_array_equal(back, jax_image.to_uint8(img)
                                          if img.dtype != np.uint8 else img)
    np.testing.assert_array_equal(image.to_uint8(torch.from_numpy(imgs[0])),
                                  jax_image.to_uint8(imgs[0]))


def test_obj_matches_jax(tmp_path):
    """o/g groups, v/vt/vn face forms, negative indices and an n-gon fan:
    load_obj, load_obj_full and obj_to_triangles equal the JAX parse."""
    p = str(tmp_path / "m.obj")
    with open(p, "w") as f:
        f.write(OBJ)
    want, got = jax_obj.load_obj(p), obj.load_obj(p)
    assert list(got) == list(want) == ["quad", "pent", "bare"]
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert got["pent"].shape == (3, 3, 3)
    np.testing.assert_array_equal(obj.obj_to_triangles(p),
                                  jax_obj.obj_to_triangles(p))
    want, got = jax_obj.load_obj_full(p), obj.load_obj_full(p)
    assert list(got) == list(want)
    for k in want:
        for f in ("positions", "normals", "uvs", "tangents", "bitangents"):
            np.testing.assert_array_equal(getattr(got[k], f),
                                          getattr(want[k], f), err_msg=f)


def test_model_matches_jax(tmp_path):
    """Model (Python and native parse, and with attributes) and
    Mesh.add_to through the port's SceneBuilder: the same meshes and the
    same scene fields as the JAX package's."""
    p = str(tmp_path / "m.obj")
    with open(p, "w") as f:
        f.write(OBJ)
    for kw in (dict(use_native=False), dict(), dict(attributes=True)):
        want, got = jax_model.Model(p, **kw), model.Model(p, **kw)
        assert len(got) == len(want) == 3
        for a, b in zip(got.meshes, want.meshes):
            assert a.name == b.name
            np.testing.assert_array_equal(a.triangles, b.triangles)
            if kw.get("attributes"):
                np.testing.assert_array_equal(a.normals, b.normals)
    jb, pb = JaxBuilder(), SceneBuilder()
    for i, (builder, mat) in enumerate(((jb, JaxMaterial), (pb, Material))):
        m = (want if i == 0 else got).meshes[1]
        m.origin = np.array([2.0, -1.0, 0.5], np.float32)
        ids = m.add_to(builder, mat(color=(1, 0, 0)), animated=True)
        assert ids == [0, 1, 2]
    jf, pf = jb.build(), pb.build("cpu")
    for f in _FIELDS:
        np.testing.assert_array_equal(getattr(pf, f).numpy(),
                                      np.asarray(getattr(jf, f)), err_msg=f)


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_checkpoint_loads_across_packages(tmp_path, saver):
    """A scene, camera, light and extras saved by one package load in the
    other with every field equal."""
    path = str(tmp_path / "ckpt.npz")
    sc = jax_scene3()
    extra = {"step": np.int32(7), "loss": np.float32(0.25)}
    if saver == "jax":
        jax_ckpt.save_scene(path, sc.flat, sc.camera, sc.light, extra=extra)
        flat, cam, light, ex = checkpoint.load_scene(path, device="cpu")
        want = (sc.flat, sc.camera, sc.light)
        got = (flat, cam, light)
    else:
        psc = generate_scene(3, device="cpu")
        checkpoint.save_scene(path, psc.flat, psc.camera, psc.light,
                              extra=extra)
        flat, cam, light, ex = jax_ckpt.load_scene(path)
        want = (psc.flat, psc.camera, psc.light)
        got = (flat, cam, light)
    assert int(ex["step"]) == 7 and float(ex["loss"]) == 0.25
    fields = (_FIELDS, ("position", "front", "up", "right", "fov_deg",
                        "aspect"), ("position", "base_color", "intensity"))
    for g, w, names in zip(got, want, fields):
        for f in names:
            a, b = (np.asarray(x.numpy() if isinstance(x, torch.Tensor)
                               else x) for x in (getattr(g, f),
                                                 getattr(w, f)))
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)


def _native():
    """The native library, which must build wherever g++ is found."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not available to build native/scene_prep.cpp")
    assert native.available()


@pytest.fixture(scope="module")
def scene1():
    sc = generate_scene(1, device="cpu")
    return sc, build_bvh(sc.flat, sc.bvh_max_depth)


def test_native_bvh_matches_python(scene1):
    _native()
    sc, py = scene1
    mins, maxs = shape_aabbs(sc.flat)
    nat = native.build_bvh_native(mins, maxs, shape_centers(sc.flat),
                                  sc.bvh_max_depth)
    for a, f in zip(nat[:7], ("bounds_min", "bounds_max", "left", "right",
                              "start", "count", "indices")):
        np.testing.assert_array_equal(a, getattr(py, f), err_msg=f)
    assert len(nat[7]) == py.num_nodes
    for a, b in zip(nat[7], py.node_shapes):
        np.testing.assert_array_equal(a, b)


def test_native_linearize_matches_python(scene1):
    _native()
    sc, py = scene1
    lin = linearize(py)
    mins, maxs = shape_aabbs(sc.flat)
    got = native.linearize_native(mins, maxs, shape_centers(sc.flat),
                                  sc.bvh_max_depth, sc.num_shapes)
    for a, f in zip(got, ("bounds", "leaf_start", "leaf_count", "skip",
                          "perm")):
        np.testing.assert_array_equal(a, getattr(lin, f).numpy(), err_msg=f)


def test_native_obj_matches_python(tmp_path):
    _native()
    p = str(tmp_path / "m.obj")
    with open(p, "w") as f:
        f.write(OBJ)
    np.testing.assert_array_equal(native.load_obj_native(p),
                                  obj.obj_to_triangles(p))
    with pytest.raises(FileNotFoundError):
        native.load_obj_native(str(tmp_path / "missing.obj"))
