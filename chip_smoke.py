#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (raytracer_tpu_torch) on one NVIDIA
card. Run from the repository root:

    python3 chip_smoke.py

It builds the CUDA kernels from csrc/ with nvcc, holds each kernel against
its plain PyTorch version on the card, drives the main path (render() of
scenes 1 and 2 at 800x600 with 3 bounces, and the closest-hit query on the
frame's primary rays) with every launch counter set to 0 just before and
read just after, times it with CUDA events, and prints one JSON line per
kernel and, last, {"ok": true, "device": {...}}. Any failed check raises,
so the script exits non-zero and prints no result. Without a CUDA device
it exits non-zero at once.
"""

import json
import os
import re
import subprocess
import sys
import time

T0 = time.perf_counter()

# Peak rates of one H100 SXM at 700 W (NVIDIA data sheet): HBM bytes/s and
# f32 operations/s outside the tensor cores. The bound counts every f32
# operation of the walks' tests as one operation against this peak.
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# f32 operations (arithmetic, compares, min/max, selects) of one test, as
# counted in csrc/raytrace.cuh: slab probe of a node, Gram-fused triangle
# test with its strict-< update, sphere and plane/wall pre-pass tests.
OPS_NODE, OPS_TRI, OPS_SPHERE, OPS_PLANEWALL = 27, 48, 30, 71

FRAME_W, FRAME_H, BOUNCES = 800, 600, 3
CHECK_W, CHECK_H = 200, 150
N_RAYS = 4096
N_PIXELS = 4096
TIMED_FRAMES = 20


def log(msg):
    print(f"[{time.perf_counter() - T0:6.1f}s] {msg}", flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from raytracer_tpu_torch.accel import build_bvh, linearize
    from raytracer_tpu_torch.config import RenderConfig
    from raytracer_tpu_torch.core import camera as cam_ops
    from raytracer_tpu_torch.geom.direct import INF
    from raytracer_tpu_torch.render import kernels, split_scene, whitted
    from raytracer_tpu_torch.render import wholeframe as wf
    from raytracer_tpu_torch.render.split import (closest_hit,
                                                  closest_hit_plain,
                                                  make_closest_hit, render)
    from raytracer_tpu_torch.scenes import generate_scene

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())

    # -- phase 1: the card ---------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    card = smi[torch.cuda.current_device()].strip()
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    log(f"phase 1: {kind}, {torch.cuda.device_count()} device(s), torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")

    # -- phase 2: build ----------------------------------------------------
    stale = kernels.BUILD_DIR / "lock"
    if stale.exists():
        stale.unlink()
    t = time.perf_counter()
    _, build_log, _ = kernels.build(force=True)
    kernels.library()
    log(f"phase 2: nvcc built {len(kernels.SOURCES)} sources in "
        f"{time.perf_counter() - t:.1f}s")
    for name, regs, spill in ptxas_summary(build_log):
        log(f"  {name}: {regs} registers, {spill}")

    # -- the scenes (host prep; device tables) -----------------------------
    scenes = {}
    t = time.perf_counter()
    for which in (1, 2):
        sc = generate_scene(which, device=dev)
        lin = linearize(build_bvh(sc.flat, sc.bvh_max_depth))
        split = split_scene.prepare(sc.flat, lin)
        scenes[which] = (sc, lin, split, whitted._attr_table(sc.flat))
    log(f"scenes 1, 2 prepared in {time.perf_counter() - t:.1f}s")
    gen = torch.Generator().manual_seed(1234)
    err = {"wholeframe_kernel": 0.0, "closest_hit_kernel": 0.0}
    held = {"wholeframe_kernel": [], "closest_hit_kernel": []}

    # -- phase 3: closest_hit_kernel against closest_hit_plain ----------------
    t = time.perf_counter()
    for which, (sc, _, split, _) in scenes.items():
        o_r = (torch.rand(N_RAYS, 3, generator=gen) * 80 - 40).to(dev)
        d_r = torch.randn(N_RAYS, 3, generator=gen)
        d_r = (d_r / d_r.norm(dim=1, keepdim=True)).to(dev)
        o_s, d_s = pixel_rays(cam_ops, sc.camera,
                              torch.randint(0, FRAME_W * FRAME_H, (N_RAYS,),
                                            generator=gen).to(dev))
        o = torch.cat([o_r, o_s]).contiguous()
        d = torch.cat([d_r, d_s]).contiguous()
        for mode in (1, 0, 2):   # Gram (default), raw, Moller-Trumbore
            tk, gk = closest_hit(split, o, d, mode)
            tp, gp = closest_hit_plain(split, o, d, mode)
            agree = (gk == gp).float().mean().item()
            both = (gk == gp) & (tp < INF)
            rel = ((tk - tp).abs() / tp.abs().clamp_min(1e-30))[both]
            rel = rel.max().item() if rel.numel() else 0.0
            u = torch.rand(2 * N_RAYS, generator=gen).to(dev)
            limit = torch.where(tp < INF, tp * (0.5 + u), 100 * u)
            ok_ = closest_hit(split, o, d, mode, max_t=limit)[0] == 0
            op_ = closest_hit_plain(split, o, d, mode, max_t=limit)[0] == 0
            occ_agree = (ok_ == op_).float().mean().item()
            log(f"phase 3: scene {which} tri mode {mode}: gid agree "
                f"{agree:.6f}, max rel dt {rel:.3g}, occlusion agree "
                f"{occ_agree:.6f} ({int(op_.sum())} occluded)")
            check(agree >= 0.9999 and occ_agree >= 0.9999 and rel <= 1e-5,
                  "closest_hit_kernel disagrees with closest_hit_plain")
            err["closest_hit_kernel"] = max(err["closest_hit_kernel"],
                                            (tk - tp).abs()[both].max().item()
                                            if both.any() else 0.0)
    held["closest_hit_kernel"].append(
        f"phase 3: {2 * N_RAYS} random and camera rays x 3 triangle tests x "
        "closest and occlusion, scenes 1 and 2")
    log(f"phase 3 done in {time.perf_counter() - t:.1f}s")

    # -- phase 4: wholeframe_kernel against wholeframe_plain ------------------
    t = time.perf_counter()
    small = RenderConfig(width=CHECK_W, height=CHECK_H, max_bounces=BOUNCES)
    variants = [("default", small)]
    variants += [(n, small.replace(**kw)) for n, kw in (
        ("raw", dict(use_gram_tri=False)), ("mt+fresnel", dict(
            use_mt=True, use_fresnel=True)), ("no shadows, 5 bounces", dict(
                enable_shadows=False, max_bounces=5)))]
    for which, (sc, _, split, tab) in scenes.items():
        par = wf.make_params(sc.camera, sc.light)
        for name, cfg in (variants if which == 1 else variants[:1]):
            ik = wf.wholeframe(split, tab, par, cfg)
            ip = wf.wholeframe_plain(split, tab, par, cfg)
            diff = (ik - ip).abs().amax(-1)
            flips = int((diff > 1e-4).sum())
            rest = diff[diff <= 1e-4]
            log(f"phase 4: scene {which} {CHECK_W}x{CHECK_H} {name}: max-abs "
                f"{diff.max().item():.3g}, {int((diff > 2e-5).sum())} px > "
                f"2e-5, {flips} px > 1e-4")
            check(bool(torch.isfinite(ik).all()), "non-finite pixels")
            check(flips <= CHECK_W * CHECK_H // 1000,
                  "wholeframe_kernel disagrees with wholeframe_plain")
            err["wholeframe_kernel"] = max(err["wholeframe_kernel"],
                                           rest.max().item())
    held["wholeframe_kernel"].append(
        f"phase 4: {CHECK_W}x{CHECK_H}, {BOUNCES} bounces, scenes 1 and 2, "
        "and raw / MT+Fresnel / unshadowed 5-bounce variants on scene 1")
    log(f"phase 4 done in {time.perf_counter() - t:.1f}s")

    # -- phase 5: the main path at full width ---------------------------------
    cfg = RenderConfig(width=FRAME_W, height=FRAME_H, max_bounces=BOUNCES)
    check(cfg == RenderConfig(), "the main path is the default config")
    counters = (wf.wholeframe, closest_hit)
    for fn in counters:
        fn.launches = 0
    frames, queries = {}, {}
    t = time.perf_counter()
    for which, (sc, lin, split, _) in scenes.items():
        frames[which] = render(sc.flat, lin, sc.camera, sc.light, cfg,
                               split=split)
        o, d = cam_ops.camera_rays(sc.camera, FRAME_W, FRAME_H)
        o, d = o.reshape(-1, 3).contiguous(), d.reshape(-1, 3).contiguous()
        query = make_closest_hit(split, cfg)
        t_hit, sid, hit = query(o, d)
        # is each hit point lit? rays from just before it toward the light
        p = (o + (t_hit - 1e-3)[:, None] * d)[hit]
        to_light = sc.light.position - p
        dist = to_light.norm(dim=1)
        lit_o, lit_d = p.contiguous(), (to_light / dist[:, None]).contiguous()
        shadowed = query.occlusion(lit_o, lit_d, dist)
        queries[which] = (o, d, t_hit, sid, hit, lit_o, lit_d, dist,
                          shadowed)
    torch.cuda.synchronize()
    launches = {"wholeframe_kernel": wf.wholeframe.launches,
                "closest_hit_kernel": closest_hit.launches}
    log(f"phase 5: main path (render + closest hits + occlusion, scenes 1 "
        f"and 2) in {time.perf_counter() - t:.1f}s; launches {launches}")
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the main path")

    for which, (sc, _, split, tab) in scenes.items():
        img = frames[which]
        check(img.shape == (FRAME_H, FRAME_W, 3), f"frame shape {img.shape}")
        check(bool(torch.isfinite(img).all()), "non-finite pixels")
        check(img.std().item() > 1e-3, "constant frame")
        pix = torch.randint(0, FRAME_W * FRAME_H, (N_PIXELS,), generator=gen)
        ref = wf.wholeframe_plain(split, tab, wf.make_params(sc.camera,
                                                             sc.light),
                                  cfg, pixels=pix.to(dev))
        diff = (img.reshape(-1, 3)[pix.to(dev)] - ref).abs().amax(-1)
        flips = int((diff > 1e-4).sum())
        log(f"phase 5: scene {which} {FRAME_W}x{FRAME_H}: mean "
            f"{img.mean().item():.4f}, {N_PIXELS} plain pixels max-abs "
            f"{diff.max().item():.3g}, {flips} px > 1e-4")
        check(flips <= N_PIXELS // 1000, "frame disagrees with the plain "
              "version")
        err["wholeframe_kernel"] = max(err["wholeframe_kernel"],
                                       diff[diff <= 1e-4].max().item())
        o, d, t_hit, sid, hit, lit_o, lit_d, dist, shadowed = queries[which]
        sub = torch.randint(0, o.shape[0], (N_RAYS,), generator=gen).to(dev)
        tp, gp = closest_hit_plain(split, o[sub], d[sub], cfg.tri_mode)
        agree = (gp.clamp_min(0) == sid[sub]).float().mean().item()
        sub = torch.randint(0, lit_o.shape[0], (N_RAYS,),
                            generator=gen).to(dev)
        occ_p = closest_hit_plain(split, lit_o[sub], lit_d[sub],
                                  cfg.tri_mode, max_t=dist[sub])[0] == 0
        occ_agree = (occ_p == shadowed[sub]).float().mean().item()
        log(f"phase 5: scene {which} closest hits: {hit.float().mean():.3f} "
            f"of rays hit, {shadowed.float().mean():.3f} of hits shadowed; "
            f"{N_RAYS} plain rays agree {agree:.6f} / {occ_agree:.6f}")
        check(agree >= 0.9999 and occ_agree >= 0.9999,
              "main-path closest hits disagree with the plain version")
    held["wholeframe_kernel"].append(
        f"phase 5: {N_PIXELS} seeded pixels of each {FRAME_W}x{FRAME_H} "
        "frame, scenes 1 and 2")
    held["closest_hit_kernel"].append(
        f"phase 5: {N_RAYS} primary rays and {N_RAYS} light rays of each "
        "full frame, scenes 1 and 2")

    # -- timing ---------------------------------------------------------------
    timing = {}
    for which, (sc, lin, split, tab) in scenes.items():
        render(sc.flat, lin, sc.camera, sc.light, cfg, split=split)
        ms = cuda_ms(lambda: render(sc.flat, lin, sc.camera, sc.light, cfg,
                                    split=split), TIMED_FRAMES)
        timing[which] = ms
        log(f"scene {which} render {FRAME_W}x{FRAME_H}x{BOUNCES}: "
            f"{ms:.3f} ms/frame, {1000 / ms:.1f} FPS ({card})")

    k1 = {}
    stats = torch.zeros(3, dtype=torch.int64, device=dev)
    for which, (sc, _, split, tab) in scenes.items():
        par = wf.make_params(sc.camera, sc.light)
        ms = cuda_ms(lambda: wf.wholeframe(split, tab, par, cfg),
                     TIMED_FRAMES)
        t = time.perf_counter()
        plain_ms = cuda_ms(lambda: wf.wholeframe_plain(split, tab, par, cfg),
                           1)
        stats.zero_()
        wf.wholeframe(split, tab, par, cfg, stats=stats)
        bound, ops, by = bound_ms(stats, split,
                                  out_bytes=FRAME_W * FRAME_H * 12,
                                  in_bytes=table_bytes(split)
                                  + tab.numel() * 4 + par.numel() * 4)
        k1[which] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                         bound_by=by, tests=stats.tolist())
        per_px = [round(x / (FRAME_W * FRAME_H), 1) for x in stats.tolist()]
        log(f"scene {which}: wholeframe_kernel {ms:.3f} ms, wholeframe_plain "
            f"{plain_ms:.1f} ms ({time.perf_counter() - t:.1f}s); tests per "
            f"pixel {per_px} (pre, node, triangle), {ops:.3g} ops -> bound "
            f"{bound:.4f} ms")
    k1_ms, k1_plain_ms = k1[1]["ms"], k1[1]["plain_ms"]
    k1_bound, k1_by = k1[1]["bound_ms"], k1[1]["bound_by"]
    sc, lin, split, tab = scenes[1]

    o, d = queries[1][0], queries[1][1]
    k2_ms = cuda_ms(lambda: closest_hit(split, o, d, cfg.tri_mode),
                    TIMED_FRAMES)
    k2_plain_ms = cuda_ms(lambda: closest_hit_plain(split, o, d,
                                                    cfg.tri_mode), 1)
    stats.zero_()
    closest_hit(split, o, d, cfg.tri_mode, stats=stats)
    k2_bound, _, k2_by = bound_ms(stats, split, out_bytes=o.shape[0] * 8,
                                  in_bytes=table_bytes(split)
                                  + o.numel() * 8)
    log(f"closest_hit_kernel {k2_ms:.3f} ms, closest_hit_plain "
        f"{k2_plain_ms:.1f} ms ({o.shape[0]} primary rays, scene 1); tests "
        f"{stats.tolist()}, bound {k2_bound:.4f} ms")

    rows = [
        dict(name="wholeframe_kernel", route="cuda",
             source="raytracer_tpu_torch/csrc/raytrace.cu",
             replaces="raytracer_tpu/render/wholeframe.py:75",
             launches=launches["wholeframe_kernel"],
             max_abs_err=err["wholeframe_kernel"], ms=k1_ms,
             plain_ms=k1_plain_ms, bound_ms=k1_bound, bound_by=k1_by,
             library_ms=None,
             frame_ms={str(k): v for k, v in timing.items()},
             per_scene={str(k): v for k, v in k1.items()},
             held_by=held["wholeframe_kernel"]),
        dict(name="closest_hit_kernel", route="cuda",
             source="raytracer_tpu_torch/csrc/raytrace.cu",
             replaces="raytracer_tpu/render/pallas_split.py:961",
             launches=launches["closest_hit_kernel"],
             max_abs_err=err["closest_hit_kernel"], ms=k2_ms,
             plain_ms=k2_plain_ms, bound_ms=k2_bound, bound_by=k2_by,
             library_ms=None, held_by=held["closest_hit_kernel"]),
    ]
    log(f"done in {time.perf_counter() - T0:.1f}s")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


def pixel_rays(cam_ops, camera, pix):
    """Primary rays through flat pixel indices of the 800x600 frame."""
    import torch
    from raytracer_tpu_torch.geom.direct import div_rn
    x = (pix % FRAME_W).to(torch.float32)
    y = (pix // FRAME_W).to(torch.float32)
    o, d = cam_ops.get_rays(camera, div_rn(2.0 * x, FRAME_W) - 1.0,
                            1.0 - div_rn(2.0 * y, FRAME_H))
    return o.contiguous(), d.contiguous()


def cuda_ms(fn, reps):
    """Mean ms per call of ``fn`` over ``reps`` calls, by CUDA events."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def table_bytes(split):
    return sum(t.numel() * t.element_size() for t in split.device_args())


def bound_ms(stats, split, out_bytes, in_bytes):
    """Least time for this run's tests: the larger of the bytes (each input
    read once, each output written once) over the memory rate and the
    counted f32 operations over the f32 peak. Returns (ms, operations,
    which of the two bounds it)."""
    pre, node, tri = stats.tolist()
    n_pw = split.n_other - split.n_sph
    ops_pre = ((split.n_sph * OPS_SPHERE + n_pw * OPS_PLANEWALL)
               / max(split.n_other, 1))
    ops = pre * ops_pre + node * OPS_NODE + tri * OPS_TRI
    by_bytes = (in_bytes + out_bytes) / PEAK_BYTES
    by_ops = ops / PEAK_F32
    return (1e3 * max(by_bytes, by_ops), ops,
            "bytes" if by_bytes > by_ops else "operations")


def ptxas_summary(build_log):
    """(kernel, registers, spills) per compiled entry from nvcc -Xptxas -v."""
    out, name, spill = [], None, ""
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            k = re.search(r"rt(\d+)(\w+?)I(Li\d+E)?(Lb[01]E)?", m.group(1))
            name = m.group(1) if not k else k.group(2) + "<" + ",".join(
                g[2:-1] for g in k.groups()[2:] if g) + ">"
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spill = f"{m.group(1)}/{m.group(2)} bytes spilled (st/ld)"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, int(m.group(1)), spill))
            name = None
    return out


if __name__ == "__main__":
    sys.exit(main())
