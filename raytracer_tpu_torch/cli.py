"""Headless command line (port of ``raytracer_tpu/cli.py``) — the
replacement for the reference's GLFW/ImGui interactive loop
(src/main.cpp:147-470). Every ImGui knob is a flag; output goes to PNG
files; the FPS readout becomes printed frame stats.

Usage examples:
  python -m raytracer_tpu_torch.cli render --scene 1 --width 800 \\
      --height 600 --bounces 3 --renderer pallas-split --out scene1.png
  python -m raytracer_tpu_torch.cli animate --scene 1 --frames 10 \\
      --out-dir frames/
  python -m raytracer_tpu_torch.cli bench --scene 1 --renderer pallas-split

The flags and their defaults are the JAX command line's, plus
``--device`` (default "cuda", which raises without a card; "cpu" runs
the kernels' plain versions). Renderers: ``pallas-split`` is
``render.split.render`` (wholeframe_kernel), ``pallas-bvh``
``render.packet.render`` (packet_kernel, occlusion_kernel with
``packet.USE_OCCLUSION``), ``pallas`` ``render.brute.render``
(brute_kernel), ``wavefront`` ``render.wavefront.render``, ``reference``
the brute-force oracle ``render.reference.render`` and ``cpu``
``render.cpu_fallback.render`` (all tensor ops).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

RENDERERS = ("wavefront", "reference", "cpu", "pallas", "pallas-bvh",
             "pallas-split")


def _apply_material_spec(flat, spec: str):
    """One material edit ``IDX:FIELD=V[,V,...]`` (e.g. ``0:color=1,0,0``)
    — one ImGui material-editor widget change (src/main.cpp:384-429).
    Functional: the edited field is a new tensor in a new FlatScene; the
    old scene's tensors are left as they were."""
    import torch

    head, _, kv = spec.partition(":")
    idx = int(head)
    key, _, val = kv.partition("=")
    vals = [float(v) for v in val.split(",")]
    field = {"color": "mat_color", "fresnel": "mat_fresnel",
             "ambient": "mat_ambient", "diffuse": "mat_diffuse",
             "specular": "mat_specular",
             "shininess": "mat_shininess"}[key]
    arr = getattr(flat, field).clone()
    arr[idx] = torch.tensor(vals if arr.ndim > 1 else vals[0],
                            dtype=torch.float32, device=arr.device)
    return flat.replace(**{field: arr})


def _apply_light(light, pos=None, color=None, intensity=None):
    """Light edits (ImGui light color/intensity/xyz sliders)."""
    from raytracer_tpu_torch.core.types import Light

    dev = light.position.device
    if pos is not None:
        light = Light(pos, light.base_color, light.intensity, device=dev)
    if color is not None:
        light = Light(light.position, color, light.intensity, device=dev)
    if intensity is not None:
        light = Light(light.position, light.base_color, float(intensity),
                      device=dev)
    return light


def _apply_edits(sc, args):
    """Live-editing knobs from the reference's ImGui panel
    (src/main.cpp:384-429: material editor, light color/intensity/xyz) as
    flags."""
    flat = sc.flat
    for spec in args.material or []:
        flat = _apply_material_spec(flat, spec)
    sc.flat = flat
    sc.light = _apply_light(sc.light, pos=args.light_pos,
                            color=args.light_color,
                            intensity=args.light_intensity)
    return sc


def _build(args):
    """(cfg, scene, reference LinearBVH or None, device) from the flags;
    the scene's tensors on ``--device``."""
    from raytracer_tpu_torch.accel import build_bvh, linearize
    from raytracer_tpu_torch.config import RenderConfig
    from raytracer_tpu_torch.device import resolve_device
    from raytracer_tpu_torch.scenes import generate_scene

    dev = resolve_device(args.device)
    cfg = RenderConfig(width=args.width, height=args.height,
                       max_bounces=args.bounces, use_bvh=not args.no_bvh,
                       use_fresnel=args.fresnel, use_mt=args.mt,
                       ray_chunk=args.ray_chunk,
                       sort_bounces=args.sort_bounces)
    sc = generate_scene(args.scene, aspect=args.width / args.height,
                        seed=args.seed, device=dev)
    sc = _apply_edits(sc, args)
    bvh = None
    if cfg.use_bvh:
        bvh = linearize(build_bvh(sc.flat, sc.bvh_max_depth))
    return cfg, sc, bvh, dev


def _prepare(flat, bvh, dev):
    from raytracer_tpu_torch.render import split_scene
    return split_scene.prepare(flat, bvh, device=dev)


def _render_frame(cfg, sc, flat, bvh, renderer: str, dev, camera=None,
                  split=None):
    """One frame of ``renderer`` (see the module docstring); the
    ``wavefront`` renderer without a tree is the oracle, as in the JAX
    command line."""
    cam = sc.camera if camera is None else camera
    if renderer == "wavefront" and bvh is not None:
        from raytracer_tpu_torch.render import wavefront
        return wavefront.render(flat, bvh, cam, sc.light, cfg, device=dev)
    if renderer == "cpu":
        from raytracer_tpu_torch.render import cpu_fallback
        return cpu_fallback.render(flat, cam, sc.light, cfg, device=dev)
    if renderer == "pallas":
        from raytracer_tpu_torch.render import brute
        return brute.render(flat, bvh, cam, sc.light, cfg, device=dev)
    if renderer == "pallas-bvh":
        from raytracer_tpu_torch.render import packet
        return packet.render(flat, bvh, cam, sc.light, cfg, device=dev)
    if renderer == "pallas-split":
        from raytracer_tpu_torch.render import split as split_mod
        return split_mod.render(flat, bvh, cam, sc.light, cfg, split=split,
                                device=dev)
    from raytracer_tpu_torch.render import reference
    return reference.render(flat, cam, sc.light, cfg, device=dev)


def cmd_render(args):
    """One frame to a PNG. The printed first-frame time holds the host
    prep of the renderer's tables and, on a fresh checkout, nvcc's build
    of the kernels."""
    from raytracer_tpu_torch.io import write_png
    from raytracer_tpu_torch.utils.timing import block_until_ready

    cfg, sc, bvh, dev = _build(args)
    t0 = time.perf_counter()
    img = block_until_ready(
        _render_frame(cfg, sc, sc.flat, bvh, args.renderer, dev))
    dt = time.perf_counter() - t0
    write_png(args.out, img)
    print(f"{sc.name}: {cfg.width}x{cfg.height} bounces={cfg.max_bounces} "
          f"renderer={args.renderer} first-frame {dt:.3f}s -> {args.out}")


def cmd_animate(args):
    from raytracer_tpu_torch.io import write_png
    from raytracer_tpu_torch.utils.timing import FrameTimer, block_until_ready

    cfg, sc, bvh, dev = _build(args)
    os.makedirs(args.out_dir, exist_ok=True)
    timer = FrameTimer()
    dt = 1.0 / args.fps_assumed

    if args.dynamic:
        # all on the device: animate + (refresh|LBVH rebuild) + render
        from raytracer_tpu_torch.render.dynamic import make_frame_fn
        if args.renderer == "pallas-split":
            renderer = "split"      # production kernel, device refresh
        elif args.renderer.startswith("pallas"):
            renderer = "pallas"     # packet kernel over the rebuilt LBVH
        else:
            renderer = "wavefront"
        frame_fn = make_frame_fn(sc, cfg, renderer=renderer, device=dev)
        flat = sc.flat
        for frame in range(args.frames):
            img, flat = frame_fn(flat, sc.camera, sc.light, frame * dt, dt)
            img = block_until_ready(img)
            timer.tick()
            write_png(os.path.join(args.out_dir, f"frame_{frame:04d}.png"),
                      img)
    else:
        # the reference's host loop: animate, and rebuild the tree every
        # refit_every frames
        from raytracer_tpu_torch.accel import build_bvh, linearize
        from raytracer_tpu_torch.anim import animate_scene
        flat = sc.flat
        for frame in range(args.frames):
            t = frame * dt
            flat = animate_scene(sc, flat, elapsed_time=t, delta_time=dt)
            if bvh is not None and sc.animated_indices:
                if frame % max(args.refit_every, 1) == 0 and frame:
                    bvh = linearize(build_bvh(flat, sc.bvh_max_depth))
            img = block_until_ready(
                _render_frame(cfg, sc, flat, bvh, args.renderer, dev))
            timer.tick()
            write_png(os.path.join(args.out_dir, f"frame_{frame:04d}.png"),
                      img)
    print(f"{args.frames} frames -> {args.out_dir} "
          f"(last fps={timer.fps:.1f})")


_KEYMAP = {"w": "forward", "s": "backward", "a": "left", "d": "right",
           "space": "up", "ctrl": "down"}


def _on(word: str) -> bool:
    return word.lower() in ("on", "1", "true")


def cmd_play(args):
    """Interactive session: the reference's per-frame input loop
    (processInput src/main.cpp:509-528, mouse_callback :530-551) driven by
    scripted/stdin events instead of GLFW callbacks.

    Event lines (one per frame; '#' comments and blanks skipped):
      key w [dt]            WASD/space/ctrl camera move (default dt 1/30 s)
      mouse DX DY           mouse-look (pixels; reference sensitivity)
      material IDX:K=V      live material edit (same syntax as --material;
                            the ImGui editor mid-session, main.cpp:384-415)
      light pos X Y Z       live light edits (main.cpp:417-429)
      light color R G B
      light intensity V
      bounces N             max reflection depth (ImGui slider,
                            main.cpp:377-379)
      fresnel on|off        Fresnel reflection toggle (main.cpp:380-382)
      bvh on|off            BVH traversal toggle (ImGui useBVH checkbox,
                            main.cpp:377-382; builds the tree lazily and
                            re-prepares the split tables on each flip)
      mt on|off             Moller-Trumbore triangle test toggle
                            (main.cpp:400-407)
      renderer NAME         switch renderer mid-session (any --renderer
                            choice; pallas-split prepares its tables once)
      wait                  render a frame with no input
      quit                  stop

    Each event renders one frame. Frames go to --out-dir when given
    (every --save-every'th), and per-frame stats are printed as JSON.
    """
    from raytracer_tpu_torch.core import camera as cam_ops
    from raytracer_tpu_torch.core.scene import to_numpy
    from raytracer_tpu_torch.io import write_png
    from raytracer_tpu_torch.render import split_scene
    from raytracer_tpu_torch.utils.timing import FrameTimer, block_until_ready

    cfg, sc, bvh, dev = _build(args)
    cam = sc.camera
    renderer = args.renderer
    bvh_full = bvh      # built tree kept across `bvh off` -> `bvh on`
    split = None
    if renderer == "pallas-split":
        # persistent prepared scene: live material edits refresh it with
        # update_materials instead of a per-frame prepare
        split = _prepare(sc.flat, bvh, dev)
    stream = (sys.stdin if args.script == "-"
              else open(args.script, "r", encoding="utf-8"))
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
    timer = FrameTimer()
    frame = 0
    default_dt = 1.0 / args.fps_assumed
    try:
        for raw in stream:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if parts[0] == "quit":
                break
            elif parts[0] == "key":
                direction = _KEYMAP.get(parts[1].lower())
                if direction is None:
                    print(f"# unknown key {parts[1]!r}", file=sys.stderr)
                    continue
                dt = float(parts[2]) if len(parts) > 2 else default_dt
                cam = cam_ops.move(cam, direction, dt)
            elif parts[0] == "mouse":
                cam = cam_ops.mouse_look(cam, float(parts[1]),
                                         float(parts[2]))
            elif parts[0] == "material":
                sc.flat = _apply_material_spec(sc.flat, parts[1])
                if split is not None:
                    split = split_scene.update_materials(split, sc.flat)
            elif parts[0] == "light":
                kind = parts[1]
                vals = [float(v) for v in parts[2:]]
                sc.light = _apply_light(
                    sc.light,
                    pos=vals if kind == "pos" else None,
                    color=vals if kind == "color" else None,
                    intensity=vals[0] if kind == "intensity" else None)
            elif parts[0] == "bounces":
                # the prepared split tables stay valid (geometry and
                # materials are untouched)
                cfg = cfg.replace(max_bounces=int(parts[1]))
            elif parts[0] == "fresnel":
                cfg = cfg.replace(use_fresnel=_on(parts[1]))
            elif parts[0] == "bvh":
                # mid-session useBVH flip (main.cpp:377-382): the same
                # state as launching with/without --no-bvh — the tree is
                # built on the first `on`, the shadow offset follows
                # cfg.use_bvh, and the split tables are re-prepared so
                # that their leaf-box gates follow the toggle
                on = _on(parts[1])
                cfg = cfg.replace(use_bvh=on)
                if on and bvh_full is None:
                    from raytracer_tpu_torch.accel import build_bvh, linearize
                    bvh_full = linearize(build_bvh(sc.flat,
                                                   sc.bvh_max_depth))
                bvh = bvh_full if on else None
                if split is not None:
                    split = _prepare(sc.flat, bvh, dev)
            elif parts[0] == "mt":
                # mid-session useMollerTrumbore flip (main.cpp:400-407)
                cfg = cfg.replace(use_mt=_on(parts[1]))
            elif parts[0] == "renderer":
                name = parts[1]
                if name not in RENDERERS:
                    print(f"# unknown renderer {name!r}", file=sys.stderr)
                    continue
                renderer = name
                if renderer == "pallas-split" and split is None:
                    split = _prepare(sc.flat, bvh, dev)
            elif parts[0] != "wait":
                print(f"# unknown event {parts[0]!r}", file=sys.stderr)
                continue
            img = block_until_ready(
                _render_frame(cfg, sc, sc.flat, bvh, renderer, dev,
                              camera=cam, split=split))
            timer.tick()
            if args.out_dir and frame % max(args.save_every, 1) == 0:
                write_png(os.path.join(args.out_dir,
                                       f"play_{frame:04d}.png"), img)
            pos = to_numpy(cam.position).round(4).tolist()
            print(json.dumps({"frame": frame, "pos": pos,
                              "fps": round(timer.fps, 2)}))
            frame += 1
    finally:
        if stream is not sys.stdin:
            stream.close()
    print(f"# {frame} frames rendered")


def cmd_bench(args):
    """Frames per second of one renderer. ``pallas-split`` prepares its
    tables once, before the timed frames (the JAX command line prepares
    them in every frame)."""
    from raytracer_tpu_torch.utils.timing import benchmark

    cfg, sc, bvh, dev = _build(args)
    flat = sc.flat
    split = (_prepare(flat, bvh, dev) if args.renderer == "pallas-split"
             else None)

    def run():
        return _render_frame(cfg, sc, flat, bvh, args.renderer, dev,
                             split=split)

    stats = benchmark(run, warmup=2, iters=args.iters,
                      rays_per_call=cfg.num_pixels)
    if dev.type == "cuda":
        import torch
        device = torch.cuda.get_device_name(dev)
    else:
        device = str(dev)
    stats.update(scene=sc.name, renderer=args.renderer,
                 width=cfg.width, height=cfg.height,
                 bounces=cfg.max_bounces, device=device)
    print(json.dumps(stats))


def main(argv=None):
    p = argparse.ArgumentParser(prog="raytracer_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--scene", type=int, default=3, choices=[1, 2, 3])
        sp.add_argument("--width", type=int, default=800)
        sp.add_argument("--height", type=int, default=600)
        sp.add_argument("--bounces", type=int, default=3)
        sp.add_argument("--no-bvh", action="store_true")
        sp.add_argument("--fresnel", action="store_true")
        sp.add_argument("--mt", action="store_true",
                        help="Moller-Trumbore triangle test")
        sp.add_argument("--sort-bounces", action="store_true",
                        help="re-sort bounce rays into coherent packets "
                             "between bounces (pallas-split: the sorted-"
                             "continuation hybrid)")
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("--ray-chunk", type=int, default=8192)
        sp.add_argument("--renderer", default="wavefront", choices=RENDERERS)
        # live-editor equivalents (ImGui panel, main.cpp:384-429)
        sp.add_argument("--material", action="append", metavar="IDX:K=V",
                        help="edit material, e.g. 0:color=1,0,0 "
                             "4:specular=0.8 (repeatable)")
        sp.add_argument("--light-pos", type=float, nargs=3)
        sp.add_argument("--light-color", type=float, nargs=3)
        sp.add_argument("--light-intensity", type=float)
        sp.add_argument("--device", default="cuda",
                        help="torch device: cuda (default; raises without "
                             "a card) or cpu (the plain versions)")

    sp = sub.add_parser("render", help="render one frame to PNG")
    common(sp)
    sp.add_argument("--out", default="out.png")
    sp.set_defaults(fn=cmd_render)

    sp = sub.add_parser("animate", help="render an animated sequence")
    common(sp)
    sp.add_argument("--frames", type=int, default=10)
    sp.add_argument("--fps-assumed", type=float, default=30.0)
    sp.add_argument("--refit-every", type=int, default=1)
    sp.add_argument("--dynamic", action="store_true",
                    help="animate + refresh or LBVH rebuild on the device")
    sp.add_argument("--out-dir", default="frames")
    sp.set_defaults(fn=cmd_animate)

    sp = sub.add_parser("play", help="interactive session driven by "
                                     "scripted/stdin key-mouse events")
    common(sp)
    sp.add_argument("--script", default="-",
                    help="event file, or - for stdin (default)")
    sp.add_argument("--fps-assumed", type=float, default=30.0,
                    help="default delta-time for key events without one")
    sp.add_argument("--out-dir", default=None,
                    help="save frames here (omit to skip PNG output)")
    sp.add_argument("--save-every", type=int, default=1)
    sp.set_defaults(fn=cmd_play)

    sp = sub.add_parser("bench", help="benchmark a renderer")
    common(sp)
    sp.add_argument("--iters", type=int, default=10)
    sp.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
