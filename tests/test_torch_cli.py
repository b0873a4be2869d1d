"""The port's command line (``raytracer_tpu_torch.cli``) and the camera
controls it drives (``core/camera.py``: ``move``, ``mouse_look``,
``yaw_pitch_of``) against the JAX package, on the CPU (``--device
cpu``).

Bars: camera vectors within 1e-6 and angles within 1e-4 degrees of the
JAX values (f32 sin, cos, asin and atan2 may differ by an ulp between
PyTorch and XLA on the CPU); PNGs within one uint8 code of the JAX
frame of the same scene (scene 1 at 24x18: the JAX command line's
``reference`` renderer has no leaf boxes, the BVH renderers are held
against the oracle with them, ``cpu`` against the JAX CPU fallback);
play's printed positions equal to the JAX camera chain's (both rounded
to 4 decimals, as the command prints them)."""

import functools
import json

import numpy as np
import pytest
import torch

from raytracer_tpu.accel.linearize import shape_leaf_boxes as jax_leaf_boxes
from raytracer_tpu.config import RenderConfig as JaxConfig
from raytracer_tpu.core import camera as jax_cam
from raytracer_tpu.io.image import to_uint8 as jax_to_uint8
from raytracer_tpu.render import cpu_fallback as jax_cpu
from raytracer_tpu.render import reference as jax_reference
from raytracer_tpu.scenes import generate_scene as jax_generate_scene
from raytracer_tpu_torch import cli
from raytracer_tpu_torch import scenes as port_scenes
from raytracer_tpu_torch.accel import build_bvh, linearize
from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.core import camera as cam_ops
from raytracer_tpu_torch.core.types import Camera
from raytracer_tpu_torch.io.image import read_png, to_uint8
from raytracer_tpu_torch.render import split as split_mod
from raytracer_tpu_torch.render import split_scene
from torch_port_common import CAMERA_FIELDS, jax_scene_bvh

W, H = 24, 18
SMALL = ["--device", "cpu", "--width", str(W), "--height", str(H)]


def test_camera_controls_match_jax():
    """Each move direction (the y-down "up": position - up * v), a
    mouse-look, the pitch clamp both ways and yaw_pitch_of, from the same
    starting camera."""
    jc = jax_cam.look_at(jax_cam.from_euler(position=(3.0, -2.0, 7.0),
                                            aspect=4 / 3), (0.5, 1.0, -2.0))
    pc = Camera(**{f: np.array(getattr(jc, f)) for f in CAMERA_FIELDS},
                device="cpu")
    for direction in ("forward", "backward", "left", "right", "up", "down"):
        want = jax_cam.move(jc, direction, 0.25)
        got = cam_ops.move(pc, direction, 0.25)
        np.testing.assert_allclose(got.position.numpy(), want.position,
                                   rtol=0, atol=1e-6)
    v = np.float32(cam_ops.SPEED) * np.float32(0.25)
    np.testing.assert_array_equal(
        cam_ops.move(pc, "up", 0.25).position.numpy(),
        pc.position.numpy() - pc.up.numpy() * v)
    for dx, dy in ((40.0, -25.0), (0.0, 5000.0), (-3.0, -5000.0)):
        want = jax_cam.mouse_look(jc, dx, dy)
        got = cam_ops.mouse_look(pc, dx, dy)
        for f in ("front", "up", "right"):
            np.testing.assert_allclose(getattr(got, f).numpy(),
                                       getattr(want, f), rtol=0, atol=1e-6)
        for a, b in zip(cam_ops.yaw_pitch_of(got),
                        jax_cam.yaw_pitch_of(want)):
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-4)
        if abs(dy) > 1000:
            pitch = cam_ops.yaw_pitch_of(got)[1]
            assert abs(abs(float(pitch)) - 89.0) < 1e-3
            assert pitch.dtype == torch.float32


@functools.lru_cache(maxsize=None)
def _jax_frames():
    """Scene 1's JAX frames at 24x18: the oracle with and without the
    reference tree's leaf boxes, and the CPU fallback, as uint8."""
    sc, lin = jax_scene_bvh(1)
    cfg = JaxConfig(width=W, height=H)
    boxes = jax_leaf_boxes(lin, sc.num_shapes)
    args = (sc.flat, sc.camera, sc.light, cfg)
    return {"oracle": jax_to_uint8(jax_reference.render(*args,
                                                        leaf_boxes=boxes)),
            "reference": jax_to_uint8(jax_reference.render(*args)),
            "cpu": jax_to_uint8(jax_cpu.render(*args))}


@pytest.mark.parametrize("renderer,want", [
    ("reference", "reference"), ("cpu", "cpu"), ("wavefront", "oracle"),
    ("pallas-split", "oracle")])
def test_render_matches_jax(tmp_path, capsys, renderer, want):
    out = str(tmp_path / "f.png")
    cli.main(["render", "--scene", "1", "--renderer", renderer, "--out",
              out] + SMALL)
    assert f"renderer={renderer} first-frame" in capsys.readouterr().out
    img = read_png(out)
    assert img.shape == (H, W, 3)
    ref = _jax_frames()[want]
    assert np.abs(img.astype(int) - ref.astype(int)).max() <= 1


def test_play_positions_match_jax(tmp_path, capsys):
    """A scripted session: every key (with and without a delta time), a
    mouse-look and a clamped one, waits and an unknown event; each
    printed position equals the JAX camera chain's."""
    events = ["key w 0.5", "mouse 40 -25", "key d", "key space 0.2",
              "key ctrl 0.1", "wait", "mouse 0 3000", "key s 0.3",
              "key a", "bogus", "quit", "key w"]
    script = tmp_path / "s.txt"
    script.write_text("# session\n\n" + "\n".join(events) + "\n")
    cli.main(["play", "--scene", "3", "--renderer", "cpu", "--script",
              str(script)] + SMALL)
    out = capsys.readouterr()
    stats = [json.loads(x) for x in out.out.splitlines()
             if x.startswith("{")]
    assert "unknown event 'bogus'" in out.err
    cam = jax_generate_scene(3, aspect=W / H).camera
    want = []
    for ev in events[:events.index("quit")]:
        parts = ev.split()
        if parts[0] == "key":
            dt = float(parts[2]) if len(parts) > 2 else 1.0 / 30.0
            cam = jax_cam.move(cam, cli._KEYMAP[parts[1]], dt)
        elif parts[0] == "mouse":
            cam = jax_cam.mouse_look(cam, float(parts[1]), float(parts[2]))
        elif parts[0] != "wait":
            continue
        want.append(np.asarray(cam.position).round(4).tolist())
    assert [s["pos"] for s in stats] == want
    assert [s["frame"] for s in stats] == list(range(len(want)))


def test_bench_json_keys(capsys):
    cli.main(["bench", "--scene", "3", "--renderer", "pallas-split",
              "--iters", "2"] + SMALL)
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(stats) == {"mean_s", "min_s", "fps", "iters", "mrays_per_s",
                          "scene", "renderer", "width", "height", "bounces",
                          "device"}
    assert stats["iters"] == 2 and stats["fps"] > 0
    assert stats["scene"] == "scene3_triangle" and stats["device"] == "cpu"
    assert stats["mrays_per_s"] == pytest.approx(
        W * H / stats["mean_s"] / 1e6)


def test_play_material_edit_refreshes_split(tmp_path, monkeypatch):
    """Live material edits under pallas-split refresh the prepared tables
    with update_materials (no new prepare) and render what a fresh
    prepare of the edited scene renders; the tensors of the scene they
    edit are left unchanged; `bvh off` / `bvh on` re-prepare."""
    made, calls = [], []
    gen = port_scenes.generate_scene

    def generate(*a, **k):
        sc = gen(*a, **k)
        made.append((sc, sc.flat, sc.flat.mat_color.clone(),
                     sc.flat.mat_specular.clone()))
        return sc

    def counted(name, fn):
        return lambda *a, **k: calls.append(name) or fn(*a, **k)

    monkeypatch.setattr(port_scenes, "generate_scene", generate)
    for name in ("update_materials", "prepare"):
        monkeypatch.setattr(split_scene, name,
                            counted(name, getattr(split_scene, name)))
    script = tmp_path / "s.txt"
    script.write_text("wait\nmaterial 0:color=1,0,0\nmaterial 1:specular=0.8"
                      "\nbvh off\nbvh on\nquit\n")
    out_dir = tmp_path / "frames"
    cli.main(["play", "--scene", "1", "--renderer", "pallas-split",
              "--script", str(script), "--out-dir", str(out_dir)] + SMALL)
    frames = [read_png(str(out_dir / f"play_{i:04d}.png")) for i in range(5)]
    assert calls == ["prepare", "update_materials", "update_materials",
                     "prepare", "prepare"]
    sc, orig, color0, spec0 = made[0]
    assert torch.equal(orig.mat_color, color0)
    assert torch.equal(orig.mat_specular, spec0)
    edited = sc.flat
    assert torch.equal(edited.mat_color[0], torch.tensor([1.0, 0.0, 0.0]))
    assert float(edited.mat_specular[1]) == pytest.approx(0.8)
    lin = linearize(build_bvh(edited, sc.bvh_max_depth))
    want = to_uint8(split_mod.render(edited, lin, sc.camera, sc.light,
                                     RenderConfig(width=W, height=H),
                                     device="cpu"))
    np.testing.assert_array_equal(frames[2], want)
    np.testing.assert_array_equal(frames[4], want)
    assert np.abs(frames[2].astype(int) - frames[0].astype(int)).max() > 0


def test_device_cuda_raises_without_card(tmp_path):
    """The default device is "cuda": without a card the command raises
    the port's error rather than rendering on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        cli.main(["render", "--scene", "3", "--width", "8", "--height", "6",
                  "--out", str(tmp_path / "f.png")])
    assert not (tmp_path / "f.png").exists()
