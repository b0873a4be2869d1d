#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (raytracer_tpu_torch) on one NVIDIA
card. Run from the repository root:

    python3 chip_smoke.py

It builds the CUDA kernels from csrc/ with nvcc and holds each kernel
(wholeframe_kernel in its raygen, emit and consume modes, bit for bit,
closest_hit_kernel, fused_kernel, resolve_kernel, packet_kernel,
occlusion_kernel, brute_kernel, closest_attrs_kernel) against its plain
PyTorch version on the card. Then it drives the main paths at 800x600
with 3 bounces, each with every launch counter set to 0 just before it
and read just after: the one-launch frame of scenes 1 and 2 with the
closest-hit and occlusion queries; the sorted-continuation hybrid
(render(sort_bounces=True)) of scenes 1 and 2, and scene 2 with
second_sort; the per-bounce route (wholeframe.USE_WHOLEFRAME off) of
scenes 1 and 2; the packet-BVH renderer (also with packet.USE_OCCLUSION),
the brute-force renderer and the wavefront renderer of scenes 1 and 2,
whose frames are held against the wavefront's; the USE_KERNEL_ATTRS
route of scenes 1 and 2, held against the per-bounce frame; the
differentiable route (render(differentiable=True)) of scene 1 with the
loss and gradients of bench.py's grad leg, held against the same
gradients through the plain closest hit; 5 steps of
diff.fit_scene_params through diff.make_kernel_renderer, each with its
launches of closest_hit_kernel and of the row gather's kernels
(gather_rows_kernel and row_grads_kernel, render/row_gather.py); the row
gather on the grad leg's own tables, ids and gradients (phase 5h: the
forward bit for bit index_select, the backward bit for bit index_add_ on
exact gradients at the same ids and within a bar of the float64 sum on
its own, its counts of rays and row adds, the loss and gradients against
those through index_select); and the animated
frame loop (render/dynamic.py, phases 6-6d): the LBVH rebuilt on the card
from animated scenes 1 and 2, equal to the CPU build with no host sync
from the animation to the packet tree, packet_kernel and
occlusion_kernel over it bit for bit, the animated split streams (scene
1 bouncing through the one-launch frame, scene 2's wheels through the
sort_bounces hybrid) timed over 20 chained frames with frame 5 held
against a static render, and the "pallas" frames (LBVH rebuild + packet
renderer) timed and held against the wavefront frame. Phase 7 drives the
port's command line (raytracer_tpu_torch.cli) in-process, with every
plain version of a kernel set to raise: render to PNG (equal to the
direct render byte for byte), bench, the brute-force oracle on the card
against the production frames, a scripted play session held frame for
frame against direct renders, and animate --dynamic. Phase 8 drives the
strip-sharded route (raytracer_tpu_torch.parallel): the window mode of
wholeframe_kernel bit for bit against its plain version, the strip
frames of scenes 1 and 2 on 2 and 4 strips of the card (and over every
card where there are more than one) equal to split.render's, the
sharded differentiable route's gradients against the single device's,
the multi-device dry run, and the examples' --kernel and --kernel-camera
fits for a few steps. It times each
kernel on the main paths' inputs by CUDA events over back-to-back calls
(the call, which holds the host's issue time where that is longer) and by
torch.profiler (the device), closest_hit_kernel on both scenes' primary
rays and in occlusion mode on the light rays of their hits (the timed
call held bit for bit against the plain version on every 97th ray),
fused_kernel on the same primary rays (held bit for bit against
fused_plain on all of them), brute_kernel with its gate and row tests
and a bound counted from the rows its gate leaves, the lockstep
kernels' warp node and row steps and SIMD efficiency (wholeframe_kernel
in its three modes, closest_hit_kernel, packet_kernel, occlusion_kernel,
fused_kernel with its closest and shadow legs apart, the closest leg's
counts taken from closest_hit_kernel on the same rays,
closest_attrs_kernel), gather_rows_kernel and row_grads_kernel on the
grad leg's largest calls beside index_select and index_add_, the frames
by CUDA events, and prints one
JSON line of the kernels and, last, {"ok": true, "device": {...}}. Any
failed check raises, so the script exits non-zero and prints no result.
Without a CUDA device it exits non-zero at once.
"""

import json
import math
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
N_FUSED = 8192
TIMED_FRAMES = 20
# resolve_kernel and index_select take ~0.01-0.3 ms: more calls a timing
RESOLVE_CALLS = 50
# the spin kernels around a profiler window (kernel_times): ~1 us
SPIN_CYCLES = 1000
# The hybrid re-associates f32 sums only (the JAX package's bar,
# tests/test_pallas_bvh.py:84-106).
HYBRID_ATOL = 1e-6
# The per-bounce route against the one-launch frame: pixels over 1e-4 at
# most 0.5% of the frame. Both trace the same hits; the per-bounce route's
# primary rays come from camera_rays (PyTorch's vector norm) where the
# kernel's raygen rounds its own root, so a direction may move by an ulp,
# which a grazing highlight (pow(., 32)) amplifies. On the CPU at 200x150
# the plain versions differ on 0.12% of scene 2's pixels and 0.013% of
# scene 1's.
PER_BOUNCE_MAX_FRACTION = 0.005
# An odd frame size for phase 4: partial tiles and partial warps.
ODD_W, ODD_H = 197, 149
# Per-ray f32 operations of resolve_kernel (3 subtractions, |rel|^2 + eps,
# sqrt, division, 3 blended normal components).
OPS_RESOLVE = 25
# f32 operations of the packed-row tests (csrc/raytrace.cuh: row_plane,
# row_wall_inside, row_bary_inside, row_mt, with the strict-< update) by
# shape type, and of packet_kernel's node probe with its cull compares.
OPS_ROW = {0: OPS_SPHERE, 1: 26, 2: 43, 3: 49}
OPS_ROW_MT = 58
OPS_NODE_CULL = OPS_NODE + 2
# brute_kernel's gate of a run: the node probe without its cull compares.
OPS_GATE = OPS_NODE - 2
# The packet and brute-force frames against the wavefront frame (the JAX
# package's bars, tests/test_pallas_bvh.py:33 and tests/test_pallas.py:36).
PACKET_ATOL, BRUTE_ATOL = 2e-5, 1e-4
# The USE_KERNEL_ATTRS frame against the per-bounce frame: both shade the
# same hits with the same formulas; only the shadow ray's direction is
# rounded differently (fused_kernel multiplies by 1/dist, the trace
# divides by PyTorch's vector norm), which may flip a grazing shadow. At
# most this share of the pixels may differ by more than KERNEL_ATTRS_ATOL.
KERNEL_ATTRS_ATOL = 1e-6
KERNEL_ATTRS_MAX_FRACTION = 1e-4
# The grad leg (bench.py::grad_split): gradients through the kernels
# against the same computation through the plain closest hit, within
# this share of the largest component (the backward's scatter-adds may
# sum in any order).
GRAD_RTOL_OF_MAX = 1e-4
# The row gather's backward (row_grads_kernel) sums in another order than
# index_add_: each row of its result within ROW_RTOL of the row's summed
# magnitudes (the norm of sum |g|) of the float64 sum; the leaves'
# gradients within LEAF_RTOL (relative norm) of those through index_select,
# whose index_add_ rows lie up to ~2e-3 from the float64 sum at full HD
# (tests/test_torch_row_gather_card.py)
ROW_RTOL, LEAF_RTOL = 1e-4, 1e-2
FIT_STEPS, FIT_LR = 5, 4.0
# The animated streams (phases 6-6d): a frame's delta time; the animated
# states that phase 6 rebuilds the LBVH of (scene 1's spheres bounced to
# ANIM_T, scene 2's wheels turned ANIM_FRAMES frames).
FRAME_DT = 1 / 30
ANIM_T, ANIM_FRAMES = 0.7, 5
# Calls a timing of the host-bound LBVH build and "pallas" frames (~45-100
# ms each on the H100's host).
SLOW_REPS = 5
# The examples' --kernel and --kernel-camera fits in phase 8e.
SMOKE_FIT_STEPS = 20


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
    from raytracer_tpu_torch.accel.linearize import shape_leaf_boxes
    from raytracer_tpu_torch.render import (brute, kernels, packet,
                                            row_gather, split_scene,
                                            wavefront, whitted)
    from raytracer_tpu_torch import diff as rt_diff
    from raytracer_tpu_torch.render import split as split_mod
    from raytracer_tpu_torch.render import wholeframe as wf
    from raytracer_tpu_torch.render.split import (closest_hit,
                                                  closest_hit_attrs,
                                                  closest_hit_attrs_plain,
                                                  closest_hit_plain, fused,
                                                  fused_plain,
                                                  make_closest_hit, render,
                                                  resolve, resolve_plain)
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
    names = ("wholeframe_kernel", "closest_hit_kernel", "fused_kernel",
             "resolve_kernel", "packet_kernel", "occlusion_kernel",
             "brute_kernel", "closest_attrs_kernel", "gather_rows_kernel",
             "row_grads_kernel")
    err = {k: 0.0 for k in names}
    held = {k: [] for k in names}
    counters = dict(zip(names, (wf.wholeframe, closest_hit, fused, resolve,
                                packet.packet_hit, packet.occlusion,
                                brute.brute_hit, closest_hit_attrs,
                                row_gather.gather_rows,
                                row_gather.row_grads)))

    # -- phase 3: closest_hit_kernel against closest_hit_plain ----------------
    t = time.perf_counter()
    n_q = N_RAYS + 17   # a partial block and warp
    for which, (sc, _, split, _) in scenes.items():
        o_r = (torch.rand(N_RAYS, 3, generator=gen) * 80 - 40).to(dev)
        d_r = torch.randn(N_RAYS, 3, generator=gen)
        d_r = (d_r / d_r.norm(dim=1, keepdim=True)).to(dev)
        o_s, d_s = pixel_rays(cam_ops, sc.camera,
                              torch.randint(0, FRAME_W * FRAME_H, (N_RAYS,),
                                            generator=gen).to(dev))
        o_q, d_q = query_rays(cam_ops, sc.camera, gen, dev, n_q)
        o = torch.cat([o_r, o_s, o_q]).contiguous()
        d = torch.cat([d_r, d_s, d_q]).contiguous()
        u = torch.rand(o.shape[0], generator=gen).to(dev)
        for mode in (1, 0, 2):   # Gram (default), raw, Moller-Trumbore
            tk, gk = closest_hit(split, o, d, mode)
            tp, gp = closest_hit_plain(split, o, d, mode)
            limit = torch.where(tp < INF, tp * (0.5 + u), 100 * u)
            limit[:8], limit[8:16] = float("inf"), float("nan")
            ok_ = closest_hit(split, o, d, mode, max_t=limit)
            op_ = closest_hit_plain(split, o, d, mode, max_t=limit)
            dt = (tk - tp).abs()[tp < INF].max().item()
            log(f"phase 3: scene {which} tri mode {mode}: {o.shape[0]} rays "
                f"({int((tp < INF).sum())} hits): max-abs dt {dt:.3g}, gid "
                f"differs on {int((gk != gp).sum())}, occlusion on "
                f"{int((ok_[0] != op_[0]).sum())} "
                f"({int((op_[0] == 0).sum())} occluded)")
            check(torch.equal(tk, tp) and torch.equal(gk, gp)
                  and torch.equal(ok_[0], op_[0])
                  and torch.equal(ok_[1], op_[1]),
                  "closest_hit_kernel disagrees with closest_hit_plain")
            err["closest_hit_kernel"] = max(err["closest_hit_kernel"], dt)
    held["closest_hit_kernel"].append(
        f"phase 3: {2 * N_RAYS + n_q} random and camera rays (of them {n_q} "
        "with a tenth parked, 8 NaN, 8 of zero direction) x 3 triangle "
        "tests x closest and occlusion, scenes 1 and 2: bit-exact")
    log(f"phase 3 done in {time.perf_counter() - t:.1f}s")

    # -- phase 3b: fused_kernel against fused_plain ---------------------------
    t = time.perf_counter()
    shadow_eps = RenderConfig().shadow_eps
    st_f = torch.zeros(5, dtype=torch.int64, device=dev)
    st_c = torch.zeros(5, dtype=torch.int64, device=dev)
    n_q = N_RAYS + 17   # with N_FUSED: not a multiple of a block or a warp
    for which, (sc, _, split, _) in scenes.items():
        half = N_FUSED // 2
        o_r = torch.rand(half, 3, generator=gen) * 80 - 40
        d_r = torch.randn(half, 3, generator=gen)
        d_r = d_r / d_r.norm(dim=1, keepdim=True)
        o_s, d_s = pixel_rays(cam_ops, sc.camera,
                              torch.randint(0, FRAME_W * FRAME_H, (half,),
                                            generator=gen).to(dev))
        o = torch.cat([o_r.to(dev), o_s])
        d = torch.cat([d_r.to(dev), d_s])
        parked = (torch.rand(N_FUSED, generator=gen) < 0.1).to(dev)
        o[parked] = whitted.PARK_ORIGIN
        d[parked] = whitted._PARK_DIR
        # and query_rays' parked, NaN and zero-direction rays
        o_q, d_q = query_rays(cam_ops, sc.camera, gen, dev, n_q)
        o = torch.cat([o, o_q]).contiguous()
        d = torch.cat([d, d_q]).contiguous()
        parked = ~(o[:, 0] < 1e30)
        warps = -(-o.shape[0] // 32)
        lp = sc.light.position.contiguous()
        for mode in (1, 0, 2):
            st_f.zero_()
            st_c.zero_()
            tk, gk, sk = fused(split, o, d, lp, mode, shadow_eps, stats=st_f)
            tp, gp, sp_ = fused_plain(split, o, d, lp, mode, shadow_eps)
            closest_hit(split, o, d, mode, stats=st_c)
            hit = tp < INF
            dt = (tk - tp).abs()[hit & (tk < INF)].max().item()
            # the closest leg walks as closest_hit_kernel does on the same
            # rays in the same warps; the rest is the shadow leg's
            legs = {"closest": st_c, "shadow": st_f - st_c}
            log(f"phase 3b: scene {which} tri mode {mode}: {o.shape[0]} rays "
                f"({int(parked.sum())} parked, {int((~hit).sum())} miss, "
                f"{int(sp_.sum())} shadowed): t differs on "
                f"{int((tk != tp).sum())}, gid on {int((gk != gp).sum())}, "
                f"in_shadow on {int((sk != sp_).sum())}; "
                + "; ".join(f"{k} leg {fmt_steps(warp_steps(v, warps))}"
                            for k, v in legs.items()))
            check(torch.equal(tk, tp) and torch.equal(gk, gp)
                  and torch.equal(sk, sp_),
                  "fused_kernel disagrees with fused_plain")
            check(bool((tk[parked] == INF).all() and not sk[parked].any()),
                  "a parked ray did not come out as an unshadowed miss")
            check(all(int(v[4]) > 0 and bool((v >= 0).all())
                      for v in legs.values()),
                  "a leg of fused_kernel took no row step")
            err["fused_kernel"] = max(err["fused_kernel"], dt)
    held["fused_kernel"].append(
        f"phase 3b: {N_FUSED + n_q} random and camera rays (a tenth parked; "
        f"of them {n_q} with 8 NaN and 8 of zero direction) x 3 triangle "
        "tests, scenes 1 and 2: t, gid and in_shadow bit-exact")
    log(f"phase 3b done in {time.perf_counter() - t:.1f}s")

    # -- phase 3c: resolve_kernel against resolve_plain -----------------------
    t = time.perf_counter()
    primary, tabs16 = {}, {}
    for which, (sc, _, split, tab) in scenes.items():
        tab16 = tabs16[which] = whitted._attr_table(sc.flat, padded=True)
        check(torch.equal(tab16[:, :15], tab) and not tab16[:, 15].any(),
              "the padded attribute table is not the table and a zero "
              "column")
        o, d = cam_ops.camera_rays(sc.camera, FRAME_W, FRAME_H)
        o, d = o.reshape(-1, 3).contiguous(), d.reshape(-1, 3).contiguous()
        t_hit, gid = closest_hit(split, o, d, RenderConfig().tri_mode)
        p = (o + t_hit[:, None] * d).contiguous()
        g = gid.to(torch.float32)
        # the frame's rays, and N_RAYS + 17 of them (a partial block and
        # warp)
        sub = torch.randint(0, g.numel(), (N_RAYS + 17,),
                            generator=gen).to(dev)
        for g_, p_ in ((g, p), (g[sub], p[sub].contiguous())):
            ak = resolve(tab16, g_, p_)
            ap = resolve_plain(tab16, g_, p_)
            e = (ak - ap).abs().max().item()
            log(f"phase 3c: scene {which}: {g_.numel()} primary hits "
                f"({int((g_ < 0).sum())} with gid -1): max-abs over the 11 "
                f"attributes {e:.3g}")
            check(bool((g_ < 0).any()) and torch.equal(ak, ap)
                  and torch.equal(ap, resolve_plain(tab, g_, p_)),
                  "resolve_kernel disagrees with resolve_plain")
            err["resolve_kernel"] = max(err["resolve_kernel"], e)
        primary[which] = (o, d, g, p)
    held["resolve_kernel"].append(
        f"phase 3c: the {FRAME_W}x{FRAME_H} primary rays' hit points and "
        f"gids (misses as -1), and {N_RAYS + 17} of them, scenes 1 and 2: "
        "bit-exact")
    log(f"phase 3c done in {time.perf_counter() - t:.1f}s")

    # -- phase 3e: closest_attrs_kernel against closest_hit_attrs_plain -----
    t = time.perf_counter()
    for which, (sc, _, split, _) in scenes.items():
        o_q, d_q = query_rays(cam_ops, sc.camera, gen, dev)
        o = torch.cat([primary[which][0], o_q]).contiguous()
        d = torch.cat([primary[which][1], d_q]).contiguous()
        for mode in (1, 0, 2):
            st_f.zero_()
            st_c.zero_()
            tk, gk, ak = closest_hit_attrs(split, o, d, mode, stats=st_f)
            tp, gp, ap = closest_hit_attrs_plain(split, o, d, mode)
            closest_hit(split, o, d, mode, stats=st_c)
            t_err = (tk - tp).abs().max().item()
            a_err = (ak - ap).abs().max().item()
            g_bad = int((gk != gp).sum())
            hit = tp < INF
            log(f"phase 3e: scene {which} tri mode {mode}: {o.shape[0]} "
                f"rays ({int(hit.sum())} hits): t max-abs {t_err:.3g}, gid "
                f"differs on {g_bad}, attributes max-abs {a_err:.3g}; "
                f"{fmt_steps(warp_steps(st_f, -(-o.shape[0] // 32)))}")
            # the walk is closest_hit_kernel's, on the same rays and warps
            check(torch.equal(st_f, st_c) and int(st_f[4]) > 0,
                  "closest_attrs_kernel's counts are not closest_hit_kernel's")
            check(torch.equal(tk, tp) and torch.equal(gk, gp)
                  and torch.equal(ak, ap),
                  "closest_attrs_kernel disagrees with "
                  "closest_hit_attrs_plain")
            check(bool((ak[:, ~hit] == 0).all()) and bool(
                (ak[3:6, hit] > 0).any()), "miss attributes not zero, or "
                "no coloured hit")
            err["closest_attrs_kernel"] = max(err["closest_attrs_kernel"],
                                              t_err, a_err)
    held["closest_attrs_kernel"].append(
        f"phase 3e: the {FRAME_W}x{FRAME_H} primary rays and {N_RAYS} "
        "random and camera rays (a tenth parked, 8 NaN, 8 of zero "
        "direction) x 3 triangle tests, scenes 1 and 2: t, gid and the 11 "
        "attributes bit-exact; lane tests and warp steps those of "
        "closest_hit_kernel")
    log(f"phase 3e done in {time.perf_counter() - t:.1f}s")

    # -- phase 3d: packet, occlusion and brute kernels against their plain
    # versions ----------------------------------------------------------------
    t = time.perf_counter()
    trees, brute_rows = {}, {}
    n_q = N_RAYS + 17   # a partial block and warp
    for which, (sc, lin, _, _) in scenes.items():
        o, d = query_rays(cam_ops, sc.camera, gen, dev, n_q)
        u = torch.rand(n_q, generator=gen).to(dev)
        perm, counts = brute.sort_scene_by_type(sc.flat)
        for use_mt in (False, True):
            t_by_cull = {}
            for t_cull in (False, True):
                tree = packet.make_tree(lin, sc.flat, t_cull=t_cull)
                trees[which, t_cull] = tree
                tk, rk = packet.packet_hit(tree, o, d, use_mt, t_cull)
                tp, rp = packet.packet_plain(tree, o, d, use_mt, t_cull)
                dt = (tk - tp).abs().max().item()
                agree = (rk == rp).float().mean().item()
                limit = torch.where(tp < INF, tp * (0.5 + u), 100 * u)
                limit[:8], limit[8:16] = float("inf"), float("nan")
                ok_ = packet.occlusion(tree, o, d, limit, use_mt, t_cull)
                op_ = packet.occlusion_plain(tree, o, d, limit, use_mt,
                                             t_cull)
                occ_agree = (ok_ == op_).float().mean().item()
                t_by_cull[t_cull] = (tk, rk)
                err["packet_kernel"] = max(err["packet_kernel"], dt)
                err["occlusion_kernel"] = max(
                    err["occlusion_kernel"],
                    (ok_.float() - op_.float()).abs().max().item())
                log(f"phase 3d: scene {which} mt {int(use_mt)} t_cull "
                    f"{int(t_cull)}: packet max-abs dt {dt:.3g}, row agree "
                    f"{agree:.6f} ({int((tp < INF).sum())} hits); occlusion "
                    f"agree {occ_agree:.6f} ({int(op_.sum())} occluded)")
                check(dt == 0 and agree == 1.0 and occ_agree == 1.0,
                      "packet/occlusion kernel disagrees with its plain "
                      "version")
            (t0_, r0_), (t1_, r1_) = t_by_cull[False], t_by_cull[True]
            flips = int(((t0_ != t1_) | (r0_ != r1_)).sum())
            log(f"phase 3d: scene {which} mt {int(use_mt)}: t_cull on and "
                f"off differ on {flips} of {n_q} rays")
            check(flips == 0, "t_cull on and off disagree")
            for gate in (False, True):
                boxes = shape_leaf_boxes(lin, sc.num_shapes) if gate else None
                rows = brute.pack_rows_ext(sc.flat, perm, boxes)
                brute_rows[which, gate] = rows
                tp, rp = brute.brute_plain(rows, counts, o, d, use_mt, gate)
                # the run table, and (gate on) one run a row: more runs
                # than shared memory holds, staged in chunks
                tables = [("runs", brute.box_runs(rows, counts, gate))]
                if gate:
                    tables.append(("one run a row", single_runs(rows)))
                for label, runs in tables:
                    tk, rk = brute.brute_hit(rows, counts, o, d, use_mt, gate,
                                             runs)
                    dt = (tk - tp).abs().max().item()
                    agree = (rk == rp).float().mean().item()
                    log(f"phase 3d: scene {which} mt {int(use_mt)} gate "
                        f"{int(gate)}, {runs.shape[0]} {label}: brute "
                        f"max-abs dt {dt:.3g}, row agree {agree:.6f} "
                        f"({int((tp < INF).sum())} hits)")
                    check(torch.equal(tk, tp) and torch.equal(rk, rp),
                          "brute_kernel disagrees with brute_plain")
                    err["brute_kernel"] = max(err["brute_kernel"], dt)
    # brute_kernel's plane loop: no reference scene has a plane
    typed = typed_scene(dev)
    o, d = query_rays(cam_ops, cam_ops.from_euler(fov_deg=60, aspect=4 / 3,
                                                  device=dev), gen, dev, n_q)
    perm, counts = brute.sort_scene_by_type(typed)
    # packet_kernel's warp walk on every shape type (planes, degenerate
    # walls: the nodes t-culling must not skip), all four variants
    typed_lin = linearize(build_bvh(typed, 3))
    rows_typed = {False: brute.pack_rows_ext(typed, perm),
                  True: brute.pack_rows_ext(typed, perm, shape_leaf_boxes(
                      typed_lin, typed.num_shapes))}
    for use_mt in (False, True):
        by_cull = []
        for t_cull in (False, True):
            tree = packet.make_tree(typed_lin, typed, t_cull=t_cull)
            tk, rk = packet.packet_hit(tree, o, d, use_mt, t_cull)
            tp, rp = packet.packet_plain(tree, o, d, use_mt, t_cull)
            by_cull.append((tk, rk))
            log(f"phase 3d: typed scene mt {int(use_mt)} t_cull "
                f"{int(t_cull)}: packet max-abs dt "
                f"{(tk - tp).abs().max().item():.3g}, row agree "
                f"{(rk == rp).float().mean().item():.6f} "
                f"({int((tp < INF).sum())} hits)")
            check(torch.equal(tk, tp) and torch.equal(rk, rp),
                  "packet_kernel disagrees with packet_plain on the typed "
                  "scene")
        check(torch.equal(by_cull[0][0], by_cull[1][0])
              and torch.equal(by_cull[0][1], by_cull[1][1]),
              "t_cull on and off disagree on the typed scene")
    for use_mt in (False, True):
        for gate in (False, True):
            rows_t = rows_typed[gate]
            tk, rk = brute.brute_hit(rows_t, counts, o, d, use_mt, gate)
            tp, rp = brute.brute_plain(rows_t, counts, o, d, use_mt, gate)
            dt = (tk - tp).abs().max().item()
            agree = (rk == rp).float().mean().item()
            types = sorted(set(typed.shape_type[perm.long().to(dev)][
                rp.long()][tp < INF].tolist()))
            log(f"phase 3d: typed scene {counts} mt {int(use_mt)} gate "
                f"{int(gate)}: brute max-abs dt {dt:.3g}, row agree "
                f"{agree:.6f}; types hit {types}")
            check(torch.equal(tk, tp) and torch.equal(rk, rp)
                  and 1 in types,
                  "brute_kernel disagrees with brute_plain on the typed "
                  "scene")
    for name in ("packet_kernel", "occlusion_kernel", "brute_kernel"):
        held[name].append(
            f"phase 3d: {n_q} random and camera rays (a tenth parked, 8 "
            "NaN, 8 of zero direction) x barycentric and MT x "
            + ("gate on and off (gate on also with one run a row, "
               "staged in chunks)" if name == "brute_kernel" else
               "t_cull on and off") + ", scenes 1 and 2"
            + ("" if name == "occlusion_kernel" else
               " and a scene with a plane"))
    log(f"phase 3d done in {time.perf_counter() - t:.1f}s")

    # -- phase 4: wholeframe_kernel against wholeframe_plain ------------------
    t = time.perf_counter()
    small = RenderConfig(width=CHECK_W, height=CHECK_H, max_bounces=BOUNCES)
    variants = [("default", small)]
    variants += [(n, small.replace(**kw)) for n, kw in (
        ("raw", dict(use_gram_tri=False)), ("mt+fresnel", dict(
            use_mt=True, use_fresnel=True)), ("no shadows, 5 bounces", dict(
                enable_shadows=False, max_bounces=5)))]
    variants.append((f"odd size {ODD_W}x{ODD_H}",
                     small.replace(width=ODD_W, height=ODD_H)))
    for which, (sc, _, split, tab) in scenes.items():
        par = wf.make_params(sc.camera, sc.light)
        for name, cfg in variants:
            ik = wf.wholeframe(split, tab, par, cfg)
            ip = wf.wholeframe_plain(split, tab, par, cfg)
            diff = (ik - ip).abs().amax(-1)
            log(f"phase 4: scene {which} {cfg.width}x{cfg.height} {name}: "
                f"max-abs {diff.max().item():.3g}, "
                f"{int((diff > 0).sum())} px differ")
            check(bool(torch.isfinite(ik).all()), "non-finite pixels")
            check(torch.equal(ik, ip),
                  "wholeframe_kernel disagrees with wholeframe_plain")
            err["wholeframe_kernel"] = max(err["wholeframe_kernel"],
                                           diff.max().item())
    held["wholeframe_kernel"].append(
        f"phase 4: {CHECK_W}x{CHECK_H}, {BOUNCES} bounces, scenes 1 and 2, "
        f"default, raw, MT+Fresnel, unshadowed 5-bounce and {ODD_W}x{ODD_H}: "
        "bit-exact")
    log(f"phase 4 done in {time.perf_counter() - t:.1f}s")

    # -- phase 4b: the emit and consume modes against the plain modes --------
    t = time.perf_counter()
    for which, (sc, _, split, tab) in scenes.items():
        par = wf.make_params(sc.camera, sc.light)
        ck, sk = wf.wholeframe(split, tab, par, small, bounces=1,
                               emit_state=True)
        cp, sp_ = wf.wholeframe_plain(split, tab, par, small, bounces=1,
                                      emit_state=True)
        rays6, perm = wf._repack(sp_, 6)
        rays9, _ = wf._repack(sp_, 9)
        ret = perm.to(torch.int32)
        k6, ks6 = wf.wholeframe(split, tab, par, small, bounces=BOUNCES - 1,
                                emit_state=True, rays=rays6, ret=ret)
        p6, ps6 = wf.wholeframe_plain(split, tab, par, small,
                                      bounces=BOUNCES - 1, emit_state=True,
                                      rays=rays6, ret=ret)
        k9 = wf.wholeframe(split, tab, par, small, bounces=BOUNCES - 1,
                           rays=rays9, ret=ret)
        p9 = wf.wholeframe_plain(split, tab, par, small, bounces=BOUNCES - 1,
                                 rays=rays9, ret=ret)
        pairs = [(ck, cp), (k6, p6), (k9, p9), (sk, sp_), (ks6, ps6)]
        c_err = max((a - b).abs().max().item() for a, b in pairs[:3])
        s_err = max((a - b).abs().max().item() for a, b in pairs[3:])
        log(f"phase 4b: scene {which} {CHECK_W}x{CHECK_H}: emit (bounce 1) "
            f"and consume (bounces 2-{BOUNCES}, 6 and 9 rows, sorted "
            f"stream, {int((sp_[0] >= 1e30).sum())} parked): colour max-abs "
            f"{c_err:.3g}, state max-abs {s_err:.3g}")
        check(bool(torch.isfinite(ck).all() and torch.isfinite(k6).all()),
              "non-finite pixels")
        check(all(torch.equal(a, b) for a, b in pairs),
              "emit/consume modes disagree with wholeframe_plain")
        err["wholeframe_kernel"] = max(err["wholeframe_kernel"], c_err,
                                       s_err)
    held["wholeframe_kernel"].append(
        f"phase 4b: emit and consume modes at {CHECK_W}x{CHECK_H}, "
        f"{BOUNCES} bounces, scenes 1 and 2 (colours and state): bit-exact")
    log(f"phase 4b done in {time.perf_counter() - t:.1f}s")

    # -- phase 5: the main path at full width ---------------------------------
    cfg = RenderConfig(width=FRAME_W, height=FRAME_H, max_bounces=BOUNCES)
    check(cfg == RenderConfig(), "the main path is the default config")
    total = {k: 0 for k in names}
    by_mode = {}

    def reset():
        for fn in counters.values():
            fn.launches = 0
        wf.wholeframe.mode_launches.clear()

    def read():
        got = {k: fn.launches for k, fn in counters.items()}
        for k, n in got.items():
            total[k] += n
        for k, n in wf.wholeframe.mode_launches.items():
            by_mode[k] = by_mode.get(k, 0) + n
        return got

    reset()
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
    launches = read()
    log(f"phase 5: main path (render + closest hits + occlusion, scenes 1 "
        f"and 2) in {time.perf_counter() - t:.1f}s; launches {launches}")
    for name in ("wholeframe_kernel", "closest_hit_kernel"):
        check(launches[name] > 0, f"{name} was not launched on the main "
              "path")

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

    # -- phase 5b: the sorted-continuation hybrid at full width --------------
    hyb = cfg.replace(sort_bounces=True)
    hybrid_err = {}
    for which, name, c in ((2, "hybrid", hyb), (1, "hybrid", hyb),
                           (2, "hybrid second_sort",
                            hyb.replace(second_sort=True))):
        sc, lin, split, _ = scenes[which]
        t = time.perf_counter()
        reset()
        img = render(sc.flat, lin, sc.camera, sc.light, c, split=split)
        torch.cuda.synchronize()
        got = read()
        want = {k: 0 for k in names}
        want["wholeframe_kernel"] = 3 if c.second_sort else 2
        diff = (img - frames[which]).abs().max().item()
        hybrid_err[f"scene {which} {name}"] = diff
        log(f"phase 5b: scene {which} {name} {FRAME_W}x{FRAME_H}x{BOUNCES} "
            f"in {time.perf_counter() - t:.2f}s: launches {got}, modes "
            f"{dict(wf.wholeframe.mode_launches)}; max-abs {diff:.3g} "
            "against the one-launch frame")
        check(got == want, f"the {name} frame launched {got}, not {want}")
        check(bool(torch.isfinite(img).all()) and diff <= HYBRID_ATOL,
              f"the {name} frame of scene {which} differs from the "
              "one-launch frame")

    # -- phase 5c: the per-bounce route at full width ------------------------
    per_bounce_over, pb_frames = {}, {}
    wf.USE_WHOLEFRAME = False
    try:
        for which in (1, 2):
            sc, lin, split, _ = scenes[which]
            t = time.perf_counter()
            reset()
            img = render(sc.flat, lin, sc.camera, sc.light, cfg, split=split)
            torch.cuda.synchronize()
            got = read()
            want = {k: 0 for k in names}
            want["fused_kernel"] = want["resolve_kernel"] = BOUNCES
            pb_frames[which] = img
            diff = (img - frames[which]).abs().amax(-1)
            over = int((diff > 1e-4).sum())
            per_bounce_over[which] = over
            log(f"phase 5c: scene {which} per-bounce {FRAME_W}x{FRAME_H}x"
                f"{BOUNCES} in {time.perf_counter() - t:.2f}s: launches "
                f"{got}; against the one-launch frame max-abs "
                f"{diff.max().item():.3g}, {over} px > 1e-4 (bound "
                f"{int(PER_BOUNCE_MAX_FRACTION * diff.numel())})")
            check(got == want, f"the per-bounce frame launched {got}, not "
                  f"{want}")
            check(bool(torch.isfinite(img).all())
                  and over <= PER_BOUNCE_MAX_FRACTION * diff.numel(),
                  "the per-bounce frame differs from the one-launch frame")
    finally:
        wf.USE_WHOLEFRAME = True
    # -- phase 5d: the packet, brute-force and wavefront renderers ----------
    renderers = {
        "packet": (packet.render, {"packet_kernel": 2 * BOUNCES}),
        "packet+occlusion": (packet.render, {
            "packet_kernel": BOUNCES, "occlusion_kernel": BOUNCES}),
        "brute": (brute.render, {"brute_kernel": 2 * BOUNCES}),
    }
    alt_frames, alt_err, wave_s = {}, {}, {}
    wave_cfg = cfg.replace(ray_chunk=FRAME_W * FRAME_H)   # one wave
    for which in (1, 2):
        sc, lin, _, _ = scenes[which]
        t = time.perf_counter()
        reset()
        wave = wavefront.render(sc.flat, lin, sc.camera, sc.light, wave_cfg)
        torch.cuda.synchronize()
        got = read()
        wave_s[which] = time.perf_counter() - t
        log(f"phase 5d: scene {which} wavefront {FRAME_W}x{FRAME_H}x"
            f"{BOUNCES} in {wave_s[which]:.2f}s: launches {got}")
        check(not any(got.values()), "the wavefront frame launched kernels")
        check(bool(torch.isfinite(wave).all()) and wave.std().item() > 1e-3,
              "the wavefront frame is not finite or constant")
        for name, (render_fn, launched) in renderers.items():
            packet.USE_OCCLUSION = name == "packet+occlusion"
            try:
                t = time.perf_counter()
                reset()
                img = render_fn(sc.flat, lin, sc.camera, sc.light, cfg)
                torch.cuda.synchronize()
                got = read()
            finally:
                packet.USE_OCCLUSION = False
            want = {k: launched.get(k, 0) for k in names}
            vs_wave = (img - wave).abs().max().item()
            over = int(((img - frames[which]).abs().amax(-1) > 1e-4).sum())
            alt_frames[which, name] = img
            alt_err[f"scene {which} {name}"] = dict(
                max_abs_vs_wavefront=vs_wave, px_over_1e4_vs_one_launch=over)
            bar = BRUTE_ATOL if name == "brute" else PACKET_ATOL
            bound = int(PER_BOUNCE_MAX_FRACTION * FRAME_W * FRAME_H)
            log(f"phase 5d: scene {which} {name} {FRAME_W}x{FRAME_H}x"
                f"{BOUNCES} in {time.perf_counter() - t:.2f}s: launches "
                f"{got}; max-abs {vs_wave:.3g} against the wavefront frame "
                f"(bar {bar:g}), {over} px > 1e-4 against the one-launch "
                f"frame (bound {bound})")
            check(got == want, f"the {name} frame launched {got}, not {want}")
            check(bool(torch.isfinite(img).all()) and vs_wave <= bar,
                  f"the {name} frame differs from the wavefront frame")
            # packet_kernel and occlusion_kernel give each ray the plain
            # walk's hit bit for bit, so these frames are the wavefront's
            check(name == "brute" or vs_wave == 0,
                  f"the {name} frame is not the wavefront frame")
            check(over <= bound,
                  f"the {name} frame differs from the one-launch frame")
    held["packet_kernel"].append(
        f"phase 5d: packet frames of scenes 1 and 2 at {FRAME_W}x"
        f"{FRAME_H} against the wavefront frame")
    held["brute_kernel"].append(
        f"phase 5d: brute-force frames of scenes 1 and 2 at {FRAME_W}x"
        f"{FRAME_H} against the wavefront frame")

    # -- phase 5e: the USE_KERNEL_ATTRS route at full width -----------------
    attrs_err = {}
    split_mod.USE_KERNEL_ATTRS = True
    try:
        for which in (1, 2):
            sc, lin, split, _ = scenes[which]
            t = time.perf_counter()
            reset()
            img = render(sc.flat, lin, sc.camera, sc.light, cfg, split=split)
            torch.cuda.synchronize()
            got = read()
            want = {k: 0 for k in names}
            want["closest_attrs_kernel"] = want["closest_hit_kernel"] = \
                BOUNCES
            diff_ = (img - pb_frames[which]).abs().amax(-1)
            over = int((diff_ > KERNEL_ATTRS_ATOL).sum())
            attrs_err[f"scene {which}"] = dict(
                max_abs_vs_per_bounce=diff_.max().item(),
                px_over_1e6_vs_per_bounce=over)
            log(f"phase 5e: scene {which} USE_KERNEL_ATTRS {FRAME_W}x"
                f"{FRAME_H}x{BOUNCES} in {time.perf_counter() - t:.2f}s: "
                f"launches {got}; against the per-bounce frame max-abs "
                f"{diff_.max().item():.3g}, {over} px > "
                f"{KERNEL_ATTRS_ATOL:g} (bound "
                f"{int(KERNEL_ATTRS_MAX_FRACTION * diff_.numel())})")
            check(got == want, f"the kernel-attrs frame launched {got}, not "
                  f"{want}")
            check(bool(torch.isfinite(img).all())
                  and over <= KERNEL_ATTRS_MAX_FRACTION * diff_.numel(),
                  "the kernel-attrs frame differs from the per-bounce frame")
    finally:
        split_mod.USE_KERNEL_ATTRS = False
    held["closest_attrs_kernel"].append(
        f"phase 5e: USE_KERNEL_ATTRS frames of scenes 1 and 2 at {FRAME_W}x"
        f"{FRAME_H} against the per-bounce frames")

    # -- phase 5f: the grad leg (bench.py::grad_split) -----------------------
    g_sc, g_lin, g_split, _ = scenes[1]
    renderer = rt_diff.make_kernel_renderer(g_lin, g_split)
    t = time.perf_counter()
    reset()
    with torch.no_grad():
        target = renderer(g_sc.flat, g_sc.camera, g_sc.light, cfg)
    torch.cuda.synchronize()
    got = read()
    want = {k: 0 for k in names}
    want["closest_hit_kernel"] = 2 * BOUNCES
    diff_ = (target - pb_frames[1]).abs().amax(-1)
    over = int((diff_ > 1e-4).sum())
    log(f"phase 5f: scene 1 differentiable {FRAME_W}x{FRAME_H}x{BOUNCES} in "
        f"{time.perf_counter() - t:.2f}s: launches {got}; against the "
        f"per-bounce frame max-abs {diff_.max().item():.3g}, {over} px > "
        "1e-4")
    check(got == want, f"the differentiable frame launched {got}, not "
          f"{want}")
    check(bool(torch.isfinite(target).all())
          and over <= PER_BOUNCE_MAX_FRACTION * diff_.numel(),
          "the differentiable frame differs from the per-bounce frame")

    flat1 = g_sc.flat

    def grad_loss(p):
        s_ = flat1.replace(
            sphere_center=torch.cat([p["center"][None],
                                     flat1.sphere_center[1:]]),
            mat_color=torch.cat([p["color"][None], flat1.mat_color[1:]]))
        img_ = renderer(s_, g_sc.camera, g_sc.light, cfg)
        return rt_diff.image_loss(img_, target)

    p0 = {"center": (flat1.sphere_center[0] + 0.3).requires_grad_(True),
          "color": (flat1.mat_color[0] * 0.8).requires_grad_(True)}

    def loss_and_grads():
        val = grad_loss(p0)
        return (val,) + torch.autograd.grad(val, [p0["center"], p0["color"]])

    # an evaluation gathers the attribute rows and the packed rows of the
    # hit and shadow queries each bounce; the shadow rays' t only decides a
    # comparison, so their rows get no gradient and no backward launch
    want_grad = dict(want, gather_rows_kernel=3 * BOUNCES,
                     row_grads_kernel=2 * BOUNCES)
    reset()
    val, g_center, g_color = loss_and_grads()
    torch.cuda.synchronize()
    got = read()
    check(got == want_grad, f"the grad leg launched {got}, not {want_grad}")
    grads = torch.cat([g_center, g_color])
    closest_kernel = split_mod.closest_hit
    split_mod.closest_hit = (lambda split_, o_, d_, mode_, max_t=None,
                             stats=None: closest_hit_plain(split_, o_, d_,
                                                           mode_, max_t))
    try:
        val_p, gc_p, gm_p = loss_and_grads()
    finally:
        split_mod.closest_hit = closest_kernel
    grads_p = torch.cat([gc_p, gm_p])
    g_err = (grads - grads_p).abs().max().item()
    g_max = grads_p.abs().max().item()
    log(f"phase 5f: loss {val.item():.6g} (plain closest {val_p.item():.6g});"
        f" d/d centre {g_center.tolist()}, d/d colour {g_color.tolist()}; "
        f"max-abs against the plain closest's gradients {g_err:.3g} (bar "
        f"{GRAD_RTOL_OF_MAX:g} x {g_max:.3g})")
    check(bool(torch.isfinite(grads).all()) and bool((grads != 0).any())
          and bool(torch.isfinite(val)), "grad leg: gradients not finite "
          "or all zero")
    check(g_err <= GRAD_RTOL_OF_MAX * g_max
          and abs(val.item() - val_p.item()) <= 1e-6 * abs(val_p.item()),
          "grad leg: the kernel route disagrees with the plain closest")

    # -- phase 5g: fit_scene_params through make_kernel_renderer -------------
    init = {"sphere_center": torch.cat([g_sc.flat.sphere_center[:1] + 0.3,
                                        g_sc.flat.sphere_center[1:]]),
            "mat_color": torch.cat([g_sc.flat.mat_color[:1] * 0.8,
                                    g_sc.flat.mat_color[1:]])}
    fit_hist, fit_ms, fit_launches = [], [], []
    params = init
    for _ in range(FIT_STEPS):
        reset()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        params, hist = rt_diff.fit_scene_params(
            g_sc.flat, g_sc.camera, g_sc.light, cfg, target, params, steps=1,
            lr=FIT_LR, renderer=renderer)
        end.record()
        torch.cuda.synchronize()
        fit_ms.append(start.elapsed_time(end))
        got = read()
        fit_launches.append({k: got[k] for k in ("closest_hit_kernel",
                                                 "gather_rows_kernel",
                                                 "row_grads_kernel")})
        fit_hist += hist
    log(f"phase 5g: {FIT_STEPS} SGD steps (lr {FIT_LR:g}) of scene 1's "
        f"sphere 0 centre and colour at {FRAME_W}x{FRAME_H}x{BOUNCES}: loss "
        f"{fit_hist}; ms per step {[round(x, 3) for x in fit_ms]}; "
        f"launches per step {fit_launches}")
    check(all(map(math.isfinite, fit_hist)) and fit_hist[-1] < fit_hist[0],
          "the fit's loss did not fall")
    want_step = {k: want_grad[k] for k in fit_launches[0]}
    check(fit_launches == [want_step] * FIT_STEPS,
          f"a fit step did not launch {want_step}")
    check(all(bool(torch.isfinite(v).all()) for v in params.values()),
          "the fitted parameters are not finite")
    # -- phase 5h: the row gather on the grad leg's own ids and gradients --
    gathers, backs, row_gather_calls, rays_per_add = row_gather_paths(
        loss_and_grads, dev, err, held)
    log(f"main paths: launches {total}, wholeframe_kernel by mode "
        f"{by_mode}")

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
    wstats = torch.zeros(5, dtype=torch.int64, device=dev)
    for which, (sc, _, split, tab) in scenes.items():
        par = wf.make_params(sc.camera, sc.light)
        ms = cuda_ms(lambda: wf.wholeframe(split, tab, par, cfg),
                     TIMED_FRAMES)
        dms = device_ms(lambda: wf.wholeframe(split, tab, par, cfg),
                        TIMED_FRAMES)
        t = time.perf_counter()
        plain_ms = cuda_ms(lambda: wf.wholeframe_plain(split, tab, par, cfg),
                           1)
        wstats.zero_()
        wf.wholeframe(split, tab, par, cfg, stats=wstats)
        bound, ops, by = bound_ms(wstats[:3], split,
                                  out_bytes=FRAME_W * FRAME_H * 12,
                                  in_bytes=table_bytes(split)
                                  + tab.numel() * 4 + par.numel() * 4)
        steps = warp_steps(wstats, frame_warps(FRAME_W, FRAME_H))
        k1[which] = dict(ms=ms, device_ms=dms, plain_ms=plain_ms,
                         bound_ms=bound, bound_by=by,
                         tests=wstats.tolist()[:3], **steps)
        per_px = [round(x / (FRAME_W * FRAME_H), 1)
                  for x in wstats.tolist()[:3]]
        log(f"scene {which}: wholeframe_kernel {ms:.3f} ms (device "
            f"{fmt(dms)}), wholeframe_plain "
            f"{plain_ms:.1f} ms ({time.perf_counter() - t:.1f}s); tests per "
            f"pixel {per_px} (pre, node, triangle; the shadow legs' any-hit)"
            f", {ops:.3g} ops -> bound {bound:.4f} ms; {fmt_steps(steps)}")
    k1_ms, k1_plain_ms = k1[1]["ms"], k1[1]["plain_ms"]
    k1_bound, k1_by = k1[1]["bound_ms"], k1[1]["bound_by"]
    sc, lin, split, tab = scenes[1]

    # closest_hit_kernel on each frame's primary rays (closest) and on the
    # light rays of their hits (occlusion against the light distance)
    k2 = {}
    st5 = torch.zeros(5, dtype=torch.int64, device=dev)
    for which, (sc, lin, split, tab) in scenes.items():
        o, d, _, _, _, lit_o, lit_d, dist, _ = queries[which]
        for mode, (oq, dq, lim) in (("closest", (o, d, None)),
                                    ("occlusion", (lit_o, lit_d, dist))):
            def run(st=None):
                return closest_hit(split, oq, dq, cfg.tri_mode, max_t=lim,
                                   stats=st)
            n = oq.shape[0]
            ms = cuda_ms(run, TIMED_FRAMES)
            dms = device_ms(run, TIMED_FRAMES)
            plain_ms = cuda_ms(lambda: closest_hit_plain(
                split, oq, dq, cfg.tri_mode, max_t=lim), 1)
            # the timed call's result on every 97th ray, against the plain
            # version on those rays
            st5.zero_()
            got = run(st5)
            sub = torch.arange(0, n, 97, device=dev)
            want = closest_hit_plain(split, oq[sub], dq[sub], cfg.tri_mode,
                                     max_t=None if lim is None else lim[sub])
            check(all(torch.equal(a[sub], b) for a, b in zip(got, want)),
                  f"scene {which}: closest_hit_kernel ({mode}) disagrees "
                  "with closest_hit_plain on the timed rays")
            bound, _, by = bound_ms(st5[:3], split, out_bytes=n * 8,
                                    in_bytes=table_bytes(split) + n * (
                                        24 if lim is None else 28))
            lanes = st5.tolist()[:3]
            steps = warp_steps(st5, -(-n // 32))
            k2.setdefault(which, {})[mode] = dict(
                ms=ms, device_ms=dms, plain_ms=plain_ms, rays=n,
                bound_ms=bound, bound_by=by, tests=lanes, **steps,
                counts=st5.tolist())
            log(f"scene {which}: closest_hit_kernel {mode} {ms:.3f} ms "
                f"(device {fmt(dms)}), closest_hit_plain {plain_ms:.1f} ms "
                f"({n} {'primary' if lim is None else 'light'} rays); "
                f"tests {lanes} (pre, node, triangle), {fmt_steps(steps)}; "
                f"bound {bound:.4f} ms ({by})")
    held["closest_hit_kernel"].append(
        "timing: every 97th of the timed rays (the primary rays, closest; "
        "the light rays of their hits, occlusion), scenes 1 and 2: "
        "bit-exact")
    k2_top = k2[1]["closest"]

    # the hybrid and per-bounce frames
    hyb_ms, pb_ms = {}, {}
    for which, (sc, lin, split, tab) in scenes.items():
        hyb_ms[which] = cuda_ms(lambda: render(sc.flat, lin, sc.camera,
                                               sc.light, hyb, split=split),
                                TIMED_FRAMES)
        log(f"scene {which} hybrid render {FRAME_W}x{FRAME_H}x{BOUNCES}: "
            f"{hyb_ms[which]:.3f} ms/frame (one-launch {timing[which]:.3f})")
    wf.USE_WHOLEFRAME = False
    try:
        for which, (sc, lin, split, tab) in scenes.items():
            render(sc.flat, lin, sc.camera, sc.light, cfg, split=split)
            pb_ms[which] = cuda_ms(lambda: render(sc.flat, lin, sc.camera,
                                                  sc.light, cfg, split=split),
                                   TIMED_FRAMES)
            log(f"scene {which} per-bounce render {FRAME_W}x{FRAME_H}x"
                f"{BOUNCES}: {pb_ms[which]:.3f} ms/frame")
    finally:
        wf.USE_WHOLEFRAME = True

    # the hybrid's parts: emit launch, re-pack + un-sort + composite,
    # continuation launch (scene 2 first, the production hybrid)
    modes, parts, streams = {}, {}, {}
    for which in (2, 1):
        sc, lin, split, tab = scenes[which]
        par = wf.make_params(sc.camera, sc.light)
        acc1, state = wf.wholeframe(split, tab, par, cfg, bounces=1,
                                    emit_state=True)
        rays, perm = wf._repack(state, 6)
        ret = perm.to(torch.int32)
        rel = wf.wholeframe(split, tab, par, cfg, bounces=BOUNCES - 1,
                            rays=rays, ret=ret)
        streams[which] = (rays, ret)

        def glue():
            _, p_ = wf._repack(state, 6)
            p_.to(torch.int32)
            return acc1.reshape(-1, 3) + state[6:9].t() * wf._unsort(rel, p_)

        key = whitted._bounce_sort_key(state[0:3].t(), state[3:6].t(),
                                       state[0] < 1e30)
        e_ms = cuda_ms(lambda: wf.wholeframe(split, tab, par, cfg, bounces=1,
                                             emit_state=True), TIMED_FRAMES)
        e_dms = device_ms(lambda: wf.wholeframe(
            split, tab, par, cfg, bounces=1, emit_state=True), TIMED_FRAMES)
        g_ms = cuda_ms(glue, TIMED_FRAMES)
        glue_ms = dict(
            key=cuda_ms(lambda: whitted._bounce_sort_key(
                state[0:3].t(), state[3:6].t(), state[0] < 1e30),
                TIMED_FRAMES),
            sort=cuda_ms(lambda: torch.sort(key, stable=True), TIMED_FRAMES),
            gather=cuda_ms(lambda: state[0:6].index_select(1, perm),
                           TIMED_FRAMES),
            unsort_composite=cuda_ms(
                lambda: acc1.reshape(-1, 3) + state[6:9].t()
                * wf._unsort(rel, perm), TIMED_FRAMES))
        c_ms = cuda_ms(lambda: wf.wholeframe(split, tab, par, cfg,
                                             bounces=BOUNCES - 1, rays=rays,
                                             ret=ret), TIMED_FRAMES)
        c_dms = device_ms(lambda: wf.wholeframe(
            split, tab, par, cfg, bounces=BOUNCES - 1, rays=rays, ret=ret),
            TIMED_FRAMES)
        n = FRAME_W * FRAME_H
        fixed = table_bytes(split) + tab.numel() * 4 + par.numel() * 4
        wstats.zero_()
        wf.wholeframe(split, tab, par, cfg, bounces=1, emit_state=True,
                      stats=wstats)
        e_bound, _, e_by = bound_ms(wstats[:3], split,
                                    out_bytes=n * 12 + n * 36,
                                    in_bytes=fixed)
        e_tests = wstats.tolist()[:3]
        e_steps = warp_steps(wstats, frame_warps(FRAME_W, FRAME_H))
        wstats.zero_()
        wf.wholeframe(split, tab, par, cfg, bounces=BOUNCES - 1, rays=rays,
                      ret=ret, stats=wstats)
        c_bound, _, c_by = bound_ms(wstats[:3], split, out_bytes=n * 12,
                                    in_bytes=fixed + n * (24 + 4))
        c_tests = wstats.tolist()[:3]
        c_steps = warp_steps(wstats, -(-n // 32))
        live = int((state[0] < 1e30).sum())
        parts[which] = dict(emit_ms=e_ms, repack_unsort_composite_ms=g_ms,
                            continuation_ms=c_ms, glue_parts_ms=glue_ms,
                            live_after_bounce_1=live)
        modes[which] = {
            "raygen+emit": dict(ms=e_ms, device_ms=e_dms, bound_ms=e_bound,
                                bound_by=e_by, tests=e_tests, **e_steps),
            "consume": dict(ms=c_ms, device_ms=c_dms, bound_ms=c_bound,
                            bound_by=c_by, tests=c_tests, **c_steps)}
        log(f"scene {which} hybrid parts: emit {e_ms:.3f} ms (device "
            f"{fmt(e_dms)}, bound {e_bound:.4f}; {fmt_steps(e_steps)}), "
            f"re-pack + un-sort + composite {g_ms:.3f} ms, continuation "
            f"{c_ms:.3f} ms (device {fmt(c_dms)}, bound {c_bound:.4f}; "
            f"{fmt_steps(c_steps)}; {live} of {n} rays live after bounce "
            "1); the glue alone: "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in glue_ms.items()))
    sc, lin, split, tab = scenes[2]
    par = wf.make_params(sc.camera, sc.light)
    rays, ret = streams[2]
    t = time.perf_counter()
    modes[2]["raygen+emit"]["plain_ms"] = cuda_ms(
        lambda: wf.wholeframe_plain(split, tab, par, cfg, bounces=1,
                                    emit_state=True), 1)
    modes[2]["consume"]["plain_ms"] = cuda_ms(
        lambda: wf.wholeframe_plain(split, tab, par, cfg,
                                    bounces=BOUNCES - 1, rays=rays, ret=ret),
        1)
    log(f"scene 2 plain emit {modes[2]['raygen+emit']['plain_ms']:.1f} ms, "
        f"plain consume {modes[2]['consume']['plain_ms']:.1f} ms "
        f"({time.perf_counter() - t:.1f}s)")

    # fused_kernel and resolve_kernel on each frame's primary rays
    k3, k5 = {}, {}
    for which, (sc, lin, split, tab) in scenes.items():
        o, d, g, p = primary[which]
        n = o.shape[0]
        lp = sc.light.position.contiguous()
        ms = cuda_ms(lambda: fused(split, o, d, lp, cfg.tri_mode,
                                   shadow_eps), TIMED_FRAMES)
        dms = device_ms(lambda: fused(split, o, d, lp, cfg.tri_mode,
                                      shadow_eps), TIMED_FRAMES)
        ref = []
        plain_ms = cuda_ms(lambda: ref.append(fused_plain(
            split, o, d, lp, cfg.tri_mode, shadow_eps)), 1)
        st5.zero_()
        got = fused(split, o, d, lp, cfg.tri_mode, shadow_eps, stats=st5)
        # the frame's rays in image order, a warp on 32 pixels of one row
        check(all(torch.equal(a, b) for a, b in zip(got, ref[0])),
              f"scene {which}: fused_kernel disagrees with fused_plain on "
              f"the {n} primary rays")
        # fused_kernel counts its two legs together. The closest leg's
        # counts are closest_hit_kernel's on the same rays and warps (k2),
        # the shadow leg's are the rest: derived, not read from the kernel
        closest_st = torch.tensor(k2[which]["closest"]["counts"], device=dev)
        legs = {"closest": closest_st, "shadow": st5 - closest_st}
        bound, _, by = bound_ms(st5[:3], split, out_bytes=n * 9,
                                in_bytes=table_bytes(split) + n * 24 + 12)
        k3[which] = dict(ms=ms, device_ms=dms, plain_ms=plain_ms,
                         bound_ms=bound, bound_by=by, tests=st5.tolist()[:3],
                         **warp_steps(st5, -(-n // 32)),
                         legs={k: dict(tests=v.tolist()[:3],
                                       **warp_steps(v, -(-n // 32)))
                               for k, v in legs.items()},
                         legs_from="closest leg: closest_hit_kernel's counts "
                         "on the same rays; shadow leg: fused_kernel's "
                         "total less them")
        check(all(int(v[4]) > 0 and bool((v >= 0).all())
                  for v in legs.values()),
              f"scene {which}: a leg of fused_kernel took no row step")
        log(f"scene {which}: fused_kernel {ms:.3f} ms (device {fmt(dms)}), "
            f"fused_plain "
            f"{plain_ms:.1f} ms ({n} primary rays); tests "
            f"{st5.tolist()[:3]} (the shadow leg's any-hit), bound "
            f"{bound:.4f} ms ({by}); {fmt_steps(k3[which])}; "
            + "; ".join(f"{k} leg tests {v['tests']}, {fmt_steps(v)}"
                        for k, v in k3[which]["legs"].items()))

        # the kernel, and index_select of the rows (the gather alone) on
        # the same padded table and on the 15-column one, each by CUDA
        # events (the call) and by the profiler (the device)
        idx = g.clamp_min(0).long()
        tab16 = tabs16[which]
        ms = cuda_ms(lambda: resolve(tab16, g, p), RESOLVE_CALLS)
        dms = device_ms(lambda: resolve(tab16, g, p), RESOLVE_CALLS)
        hms = host_ms(lambda: resolve(tab16, g, p), RESOLVE_CALLS)
        plain_ms = cuda_ms(lambda: resolve_plain(tab16, g, p), 1)
        lib = {}
        for name_, tab_ in (("padded", tab16), ("15 columns", tab)):
            lib[name_] = dict(
                ms=cuda_ms(lambda: tab_.index_select(0, idx), RESOLVE_CALLS),
                device_ms=device_ms(lambda: tab_.index_select(0, idx),
                                    RESOLVE_CALLS, csrc=False),
                host_ms=host_ms(lambda: tab_.index_select(0, idx),
                                RESOLVE_CALLS))
        bound, by = bound_of(in_bytes=n * 16 + tab16.numel() * 4,
                             out_bytes=n * 44, ops=n * OPS_RESOLVE)
        # the library's yardstick: the faster of the two gathers
        best = min(lib, key=lambda k: lib[k]["ms"])
        k5[which] = dict(ms=ms, device_ms=dms, host_ms=hms,
                         plain_ms=plain_ms,
                         library_ms=lib[best]["ms"],
                         library_device_ms=lib[best]["device_ms"],
                         library_table=best,
                         index_select=lib, bound_ms=bound, bound_by=by)
        log(f"scene {which}: resolve_kernel {ms:.4f} ms (device "
            f"{fmt(dms, 4)}, the wrapper's host issue {hms:.4f} ms), "
            f"resolve_plain {plain_ms:.2f} ms; "
            + "; ".join(f"index_select of the {k} table {v['ms']:.4f} ms "
                        f"(device {fmt(v['device_ms'], 4)}, host issue "
                        f"{v['host_ms']:.4f} ms)"
                        for k, v in lib.items())
            + f"; bound {bound:.4f} ms ({by})")

    held["fused_kernel"].append(
        f"timing: all {FRAME_W}x{FRAME_H} primary rays in image order, "
        "scenes 1 and 2: t, gid and in_shadow bit-exact")

    # packet_kernel, occlusion_kernel and brute_kernel on each frame's
    # primary rays (occlusion_kernel: the light rays of the primary hits),
    # their plain versions on 4096 of them; the renderers' frames
    k678, alt_ms, idle = {}, {}, {}
    for which, (sc, lin, split, tab) in scenes.items():
        o, d, t_hit, _, hit, lit_o, lit_d, dist, _ = queries[which]
        tree = trees[which, True]
        rows_g = brute_rows[which, True]
        perm, counts = brute.sort_scene_by_type(sc.flat)
        runs_g = brute.box_runs(rows_g, counts)
        sub = torch.randint(0, o.shape[0], (N_RAYS,), generator=gen).to(dev)
        lsub = torch.randint(0, lit_o.shape[0], (N_RAYS,),
                             generator=gen).to(dev)
        o_s, d_s = o[sub].contiguous(), d[sub].contiguous()
        lo_s, ld_s = lit_o[lsub].contiguous(), lit_d[lsub].contiguous()
        dist_s = dist[lsub].contiguous()
        tbytes = sum(x.numel() * x.element_size() for x in (
            tree.leaf_start, tree.leaf_count, tree.skip, tree.nodes,
            tree.rows))
        runs = {
            "packet_kernel": (
                lambda: packet.packet_hit(tree, o, d, False, True),
                lambda: packet.packet_plain(tree, o_s, d_s, False, True),
                lambda st: packet.packet_hit(tree, o, d, False, True,
                                             stats=st),
                o.shape[0], tbytes + o.shape[0] * 24, o.shape[0] * 8),
            "occlusion_kernel": (
                lambda: packet.occlusion(tree, lit_o, lit_d, dist, False,
                                         True),
                lambda: packet.occlusion_plain(tree, lo_s, ld_s, dist_s,
                                               False, True),
                lambda st: packet.occlusion(tree, lit_o, lit_d, dist, False,
                                            True, stats=st),
                lit_o.shape[0], tbytes + lit_o.shape[0] * 28,
                lit_o.shape[0]),
            "brute_kernel": (
                lambda: brute.brute_hit(rows_g, counts, o, d, False, True,
                                        runs_g),
                lambda: brute.brute_plain(rows_g, counts, o_s, d_s, False,
                                          True),
                lambda st: brute.brute_hit(rows_g, counts, o, d, False, True,
                                           runs_g, stats=st),
                o.shape[0], (rows_g.numel() + runs_g.numel()) * 4
                + o.shape[0] * 24, o.shape[0] * 8)}
        for name, (run, plain, with_stats, n, in_b, out_b) in runs.items():
            ms = cuda_ms(run, TIMED_FRAMES)
            dms = device_ms(run, TIMED_FRAMES)
            plain_ms = cuda_ms(plain, 1)
            extra = {}
            if name == "brute_kernel":
                # the gate's work: a gate per run, and the row tests of the
                # rows whose box the ray hits, counted here in PyTorch
                stats.zero_()
                with_stats(stats)
                gates, lane_rows, w_row = stats.tolist()
                need = needed_rows(runs_g, counts, o, d)
                check(sum(need) == lane_rows, "brute_kernel's row tests are "
                      "not the rows whose leaf box the ray hits")
                ops = gates * OPS_GATE + sum(
                    c * OPS_ROW[k] for k, c in enumerate(need))
                every = n * sum(c * OPS_ROW[k] for k, c in enumerate(counts))
                tests = dict(runs=runs_g.shape[0], gates=gates,
                             row_tests=lane_rows, row_tests_by_type=need,
                             warp_row_steps=w_row,
                             row_steps_per_warp=w_row / -(-n // 32),
                             simd_efficiency=lane_rows / max(32 * w_row, 1),
                             every_row_tests=n * sum(counts))
                extra["bound_ms_every_row"] = bound_of(
                    in_bytes=in_b, out_bytes=out_b, ops=every)[0]
            else:
                # the warp walk's lockstep steps too: node steps and row
                # steps summed over the warps
                st5 = torch.zeros(5, dtype=torch.int64, device=dev)
                with_stats(st5)
                other, node, tri, w_node, w_row = st5.tolist()
                ops = (other * row_ops_other(sc.flat) + node * OPS_NODE_CULL
                       + tri * OPS_ROW[3])
                tests = dict(other_rows=other, nodes=node, triangles=tri,
                             warp_node_steps=w_node, warp_row_steps=w_row,
                             **warp_steps(st5, -(-n // 32), other + tri))
            bound, by = bound_of(in_bytes=in_b, out_bytes=out_b, ops=ops)
            k678.setdefault(name, {})[which] = dict(
                ms=ms, device_ms=dms, plain_ms=plain_ms, plain_rays=N_RAYS,
                rays=n, bound_ms=bound, bound_by=by, tests=tests, **extra)
            log(f"scene {which}: {name} {ms:.3f} ms (device {fmt(dms)}) on "
                f"{n} rays, plain "
                f"{plain_ms:.1f} ms on {N_RAYS}; tests {tests}, bound "
                f"{bound:.4f} ms ({by})"
                + "".join(f", {k} {v:.4f}" for k, v in extra.items()))

        ms = {}
        for name in ("packet", "packet+occlusion", "brute"):
            render_fn = brute.render if name == "brute" else packet.render
            packet.USE_OCCLUSION = name == "packet+occlusion"
            try:
                ms[name] = cuda_ms(lambda: render_fn(
                    sc.flat, lin, sc.camera, sc.light, cfg), TIMED_FRAMES)
            finally:
                packet.USE_OCCLUSION = False
        # the packet frame without the square-block pixel remap: the rays
        # in row order, the block shape patched for this one timing
        block_shape = packet._block_shape
        packet._block_shape = lambda tile: (1, tile)
        try:
            flat_order = packet.render(sc.flat, lin, sc.camera, sc.light, cfg)
            ms["packet, rows in image order"] = cuda_ms(lambda: packet.render(
                sc.flat, lin, sc.camera, sc.light, cfg), TIMED_FRAMES)
        finally:
            packet._block_shape = block_shape
        check(bool((flat_order == alt_frames[which, "packet"]).all()),
              "the pixel remap changed the packet frame")
        ms["wavefront (once, host clock)"] = 1e3 * wave_s[which]
        alt_ms[which] = ms
        for name in ("packet", "brute"):
            render_fn = brute.render if name == "brute" else packet.render
            busy, ours = device_busy_ms(lambda: render_fn(
                sc.flat, lin, sc.camera, sc.light, cfg))
            idle[f"scene {which} {name}"] = dict(
                device_busy_ms=busy, port_kernels_ms=ours,
                frame_ms=ms[name],
                idle_share=None if busy is None else 1 - busy / ms[name])
            log(f"scene {which} {name} frame: kernels busy the card "
                + ("(not measured: the profiler saw no device time)"
                   if busy is None else f"{busy:.3f} of {ms[name]:.3f} ms "
                   f"({ours:.3f} ms in csrc kernels), idle share "
                   f"{1 - busy / ms[name]:.3f}"))
        log(f"scene {which} frames {FRAME_W}x{FRAME_H}x{BOUNCES}: "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items()))

    # closest_attrs_kernel on each frame's primary rays; the
    # USE_KERNEL_ATTRS frames; the grad leg's forward and forward+backward
    k4, ka_ms = {}, {}
    for which, (sc, lin, split, tab) in scenes.items():
        o, d = primary[which][0], primary[which][1]
        n = o.shape[0]
        ms = cuda_ms(lambda: closest_hit_attrs(split, o, d, cfg.tri_mode),
                     TIMED_FRAMES)
        dms = device_ms(lambda: closest_hit_attrs(split, o, d, cfg.tri_mode),
                        TIMED_FRAMES)
        plain_ms = cuda_ms(lambda: closest_hit_attrs_plain(
            split, o, d, cfg.tri_mode), 1)
        st5.zero_()
        closest_hit_attrs(split, o, d, cfg.tri_mode, stats=st5)
        check(st5.tolist() == k2[which]["closest"]["counts"],
              f"scene {which}: closest_attrs_kernel's counts are not "
              "closest_hit_kernel's on the same rays")
        # beyond the walk, a hit's normal costs what resolve's does
        bound, _, by = bound_ms(st5[:3], split, out_bytes=n * (8 + 44),
                                in_bytes=table_bytes(split) + n * 24,
                                extra_ops=n * OPS_RESOLVE)
        k4[which] = dict(ms=ms, device_ms=dms, plain_ms=plain_ms,
                         bound_ms=bound, bound_by=by, tests=st5.tolist()[:3],
                         **warp_steps(st5, -(-n // 32)))
        split_mod.USE_KERNEL_ATTRS = True
        try:
            frame = (lambda: render(sc.flat, lin, sc.camera, sc.light, cfg,
                                    split=split))
            ka_ms[which] = cuda_ms(frame, TIMED_FRAMES)
            busy, _ = device_busy_ms(frame)
        finally:
            split_mod.USE_KERNEL_ATTRS = False
        k4[which]["frame_idle_share"] = (None if busy is None
                                         else 1 - busy / ka_ms[which])
        log(f"scene {which}: closest_attrs_kernel {ms:.3f} ms (device "
            f"{fmt(dms)}), "
            f"closest_hit_attrs_plain {plain_ms:.1f} ms ({n} primary rays); "
            f"tests {st5.tolist()[:3]}, bound {bound:.4f} ms ({by}); "
            f"{fmt_steps(k4[which])}; "
            f"USE_KERNEL_ATTRS frame {ka_ms[which]:.3f} ms (per-bounce "
            f"{pb_ms[which]:.3f}), device busy "
            + ("not measured" if busy is None else f"{busy:.3f} ms"))

    def forward():
        with torch.no_grad():
            return grad_loss(p0)

    fwd_ms = cuda_ms(forward, TIMED_FRAMES // 4)
    fwd_bwd_ms = cuda_ms(loss_and_grads, TIMED_FRAMES // 4)
    top_fwd_bwd = top_device_ops(loss_and_grads, 8)
    busy, ours = device_busy_ms(loss_and_grads)
    log("grad leg: the device's busiest kernels of one fwd+bwd: "
        + ("not measured (the profiler saw no device time)"
           if top_fwd_bwd is None else
           "; ".join(f"{k} {v:.3f} ms" for k, v in top_fwd_bwd)))
    grad_leg = dict(fwd_ms=fwd_ms, fwd_bwd_ms=fwd_bwd_ms,
                    bwd_over_fwd=fwd_bwd_ms / fwd_ms, loss=val.item(),
                    grad_center=g_center.tolist(),
                    grad_color=g_color.tolist(),
                    max_abs_vs_plain_closest=g_err,
                    launches_per_evaluation=2 * BOUNCES,
                    top_device_ops_fwd_bwd_ms=top_fwd_bwd,
                    fwd_bwd_device_busy_ms=busy,
                    fwd_bwd_csrc_kernels_ms=ours,
                    fwd_bwd_idle_share=None if busy is None
                    else 1 - busy / fwd_bwd_ms)
    log(f"grad leg (scene 1, {FRAME_W}x{FRAME_H}x{BOUNCES}): fwd_ms "
        f"{fwd_ms:.3f}, fwd_bwd_ms {fwd_bwd_ms:.3f}, bwd_over_fwd "
        f"{fwd_bwd_ms / fwd_ms:.3f}; fit {sum(fit_ms) / FIT_STEPS:.3f} ms "
        "per step; fwd+bwd kernels busy the card "
        + ("(not measured)" if busy is None else
           f"{busy:.3f} ms ({ours:.3f} in csrc kernels), idle share "
           f"{1 - busy / fwd_bwd_ms:.3f}"))

    # the row gather's kernels on the grad leg's largest call of each table
    # (phase 5h), beside their plain versions and index_select / index_add_
    k_gather, k_grads = row_gather_times(gathers, backs, dev)

    # the lockstep kernels' warp steps side by side
    lockstep = {}
    for which in scenes:
        lockstep[f"scene {which} wholeframe_kernel raygen"] = k1[which]
        lockstep[f"scene {which} wholeframe_kernel raygen+emit"] = \
            modes[which]["raygen+emit"]
        lockstep[f"scene {which} wholeframe_kernel consume"] = \
            modes[which]["consume"]
        for mode in ("closest", "occlusion"):
            lockstep[f"scene {which} closest_hit_kernel {mode}"] = \
                k2[which][mode]
        for name in ("packet_kernel", "occlusion_kernel"):
            lockstep[f"scene {which} {name}"] = k678[name][which]["tests"]
        lockstep[f"scene {which} fused_kernel"] = k3[which]
        for leg, v in k3[which]["legs"].items():
            lockstep[f"scene {which} fused_kernel {leg} leg"] = v
        lockstep[f"scene {which} closest_attrs_kernel"] = k4[which]
    for k, v in lockstep.items():
        log(f"lockstep walks: {k}: {fmt_steps(v)}")

    # -- phases 6-6d: the animated frame loop (render/dynamic.py) -----------
    # last: in a run where these phases came before the timing section,
    # every profiler window after them recorded no device ms
    animated = animated_paths(scenes, cfg, dev, gen, reset, read, names)
    held["packet_kernel"].append(
        f"phase 6b: {N_RAYS + 17} seeded rays over the LBVH trees of the "
        "animated scenes 1 and 2 (t_cull on): bit-exact; phase 6d: the "
        f"pallas frames at {CHECK_W}x{CHECK_H} against the wavefront frame "
        "of the same LBVH")
    held["occlusion_kernel"].append(
        f"phase 6b: {N_RAYS + 17} seeded rays over the LBVH trees of the "
        "animated scenes 1 and 2 (t_cull on): bit-exact")
    held["wholeframe_kernel"].append(
        "phase 6c: frame 5 of the animated split streams of scenes 1 and 2 "
        "against a static render of the same scene (pixels over 1e-4 under "
        "0.5%, median at most 1e-6)")

    # -- phase 7: the command line (raytracer_tpu_torch.cli) -----------------
    phase7 = cli_paths(dev, card, reset, read, names)
    for k, v in phase7.items():
        print(json.dumps({"phase": k, **v}), flush=True)
    held["wholeframe_kernel"].append(
        "phase 7a: the command line's PNGs of scene 1 (one launch) and scene "
        "2 (hybrid) equal to_uint8 of split.render byte for byte; 7c: the "
        "one-launch frames and scene 2's hybrid against the brute-force "
        "oracle on the card; 7d: play frames equal direct renders")

    # -- phase 8: the strip-sharded route and the examples' fits -------------
    phase8 = sharded_paths(scenes, cfg, dev, reset, read, names, err)
    for k, v in phase8.items():
        print(json.dumps({"phase": k, **v}), flush=True)
    held["wholeframe_kernel"].append(
        f"phase 8a: the window mode at {ODD_W}x{ODD_H} in 3 strips, raygen, "
        "emit and consume: bit-exact; 8b: the strip-sharded frames of scene "
        "1 (one launch) and scene 2 (hybrid) equal split.render's")
    log(f"all paths: launches {total}, wholeframe_kernel by mode {by_mode}")

    rows = [
        dict(name="wholeframe_kernel", route="cuda",
             source="raytracer_tpu_torch/csrc/raytrace.cu",
             replaces="raytracer_tpu/render/wholeframe.py:75",
             launches=total["wholeframe_kernel"],
             launches_by_mode=by_mode,
             max_abs_err=err["wholeframe_kernel"], ms=k1_ms,
             device_ms=k1[1]["device_ms"], plain_ms=k1_plain_ms, bound_ms=k1_bound, bound_by=k1_by,
             library_ms=None,
             frame_ms={str(k): v for k, v in timing.items()},
             per_scene={str(k): v for k, v in k1.items()},
             modes={str(k): v for k, v in modes.items()},
             hybrid_frame_ms={str(k): v for k, v in hyb_ms.items()},
             hybrid_parts_ms={str(k): v for k, v in parts.items()},
             hybrid_max_abs_vs_one_launch=hybrid_err,
             strip_sharded=phase8["8b"],
             held_by=held["wholeframe_kernel"]),
        dict(name="closest_hit_kernel", route="cuda",
             source="raytracer_tpu_torch/csrc/raytrace.cu",
             replaces="raytracer_tpu/render/pallas_split.py:961",
             launches=total["closest_hit_kernel"],
             max_abs_err=err["closest_hit_kernel"], ms=k2_top["ms"],
             device_ms=k2_top["device_ms"], plain_ms=k2_top["plain_ms"],
             bound_ms=k2_top["bound_ms"], bound_by=k2_top["bound_by"],
             library_ms=None,
             per_scene={str(k): v for k, v in k2.items()},
             held_by=held["closest_hit_kernel"]),
        dict(name="fused_kernel", route="cuda",
             source="raytracer_tpu_torch/csrc/raytrace.cu",
             replaces="raytracer_tpu/render/pallas_split.py:905",
             launches=total["fused_kernel"],
             max_abs_err=err["fused_kernel"], ms=k3[2]["ms"],
             device_ms=k3[2]["device_ms"], plain_ms=k3[2]["plain_ms"], bound_ms=k3[2]["bound_ms"],
             bound_by=k3[2]["bound_by"], library_ms=None,
             per_scene={str(k): v for k, v in k3.items()},
             per_bounce_frame_ms={str(k): v for k, v in pb_ms.items()},
             per_bounce_px_over_1e4={str(k): v
                                     for k, v in per_bounce_over.items()},
             held_by=held["fused_kernel"]),
        dict(name="resolve_kernel", route="cuda",
             source="raytracer_tpu_torch/csrc/raytrace.cu",
             replaces="raytracer_tpu/render/pallas_split.py:978",
             launches=total["resolve_kernel"],
             max_abs_err=err["resolve_kernel"], ms=k5[2]["ms"],
             device_ms=k5[2]["device_ms"], plain_ms=k5[2]["plain_ms"], bound_ms=k5[2]["bound_ms"],
             bound_by=k5[2]["bound_by"], library_ms=k5[2]["library_ms"],
             per_scene={str(k): v for k, v in k5.items()},
             held_by=held["resolve_kernel"]),
    ]
    for name, replaces in (
            ("packet_kernel", "raytracer_tpu/render/pallas_bvh.py:169"),
            ("occlusion_kernel", "raytracer_tpu/render/pallas_bvh.py:268"),
            ("brute_kernel", "raytracer_tpu/render/pallas_kernel.py:95")):
        top = k678[name][2]
        rows.append(dict(
            name=name, route="cuda",
            source="raytracer_tpu_torch/csrc/raytrace.cu", replaces=replaces,
            launches=total[name], max_abs_err=err[name], ms=top["ms"],
            device_ms=top["device_ms"], plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
            bound_by=top["bound_by"], library_ms=None,
            per_scene={str(k): v for k, v in k678[name].items()},
            held_by=held[name]))
        if "bound_ms_every_row" in top:
            rows[-1]["bound_ms_every_row"] = top["bound_ms_every_row"]
    for name in ("packet_kernel", "occlusion_kernel"):
        rows[-3 if name == "packet_kernel" else -2]["lbvh"] = {
            str(k): v for k, v in animated["kernels"][name].items()}
    rows[-3]["lbvh_build"] = {str(k): v
                              for k, v in animated["build"].items()}
    rows[-3]["animated_pallas_frames"] = {
        str(k): v for k, v in animated["pallas"].items()}
    rows[0]["animated_split_streams"] = {
        str(k): v for k, v in animated["streams"].items()}
    rows[-3]["frame_ms"] = {str(k): v for k, v in alt_ms.items()}
    rows[-3]["frames_vs_wavefront_and_one_launch"] = alt_err
    rows[-3]["frame_device_idle"] = idle
    rows.append(dict(
        name="closest_attrs_kernel", route="cuda",
        source="raytracer_tpu_torch/csrc/raytrace.cu",
        replaces="raytracer_tpu/render/pallas_split.py:967",
        launches=total["closest_attrs_kernel"],
        max_abs_err=err["closest_attrs_kernel"], ms=k4[2]["ms"],
        device_ms=k4[2]["device_ms"], plain_ms=k4[2]["plain_ms"], bound_ms=k4[2]["bound_ms"],
        bound_by=k4[2]["bound_by"], library_ms=None,
        per_scene={str(k): v for k, v in k4.items()},
        kernel_attrs_frame_ms={str(k): v for k, v in ka_ms.items()},
        kernel_attrs_vs_per_bounce=attrs_err,
        grad_leg=grad_leg,
        fit=dict(steps=FIT_STEPS, lr=FIT_LR, loss=fit_hist, step_ms=fit_ms,
                 launches_per_step=fit_launches),
        held_by=held["closest_attrs_kernel"]))
    for name, ks, replaces, lib in (
            ("gather_rows_kernel", k_gather,
             "raytracer_tpu/diff/kernel_vjp.py:42 and "
             "raytracer_tpu/render/whitted.py:174 (jnp.take)",
             "index_select"),
            ("row_grads_kernel", k_grads, "the backward of those jnp.take "
             "(XLA's scatter-add)", "index_add_")):
        top = ks[max(ks)]   # the packed rows' 24 columns
        rows.append(dict(
            name=name, route="cuda",
            source="raytracer_tpu_torch/csrc/raytrace.cu",
            replaces=replaces, launches=total[name], max_abs_err=err[name],
            ms=top["ms"], device_ms=top["device_ms"],
            plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
            bound_by=top["bound_by"], library_ms=top["library_ms"],
            library_device_ms=top["library_device_ms"], library=lib,
            per_table={str(w): k for w, k in ks.items()},
            held_by=held[name]))
    rows[-1]["calls"] = row_gather_calls
    rows[-1]["rays_per_add"] = rays_per_add
    log(f"done in {time.perf_counter() - T0:.1f}s")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


def row_gather_paths(loss_and_grads, dev, err, held):
    """Phase 5h: one evaluation of the grad leg (``loss_and_grads``, scene
    1) with row_gather's wrappers recording their tables, ids and
    gradients, and one through index_select's views (``engages`` off).
    Holds every gather bit for bit against index_select; every backward
    call bit for bit against index_add_ on exact gradients at its ids (its
    stats: the rays with a gradient that is not zero), and within ROW_RTOL
    of each row's summed magnitudes of the float64 sum on its own
    gradients; the loss bit for bit and the leaves' gradients within
    LEAF_RTOL of index_select's path. Returns (the gathers, the backward
    calls, each backward call's counts and gaps, rays a row add)."""
    import torch
    from raytracer_tpu_torch.render import row_gather
    t = time.perf_counter()
    gathers, backs = [], []
    real_gather, real_grads = row_gather.gather_rows, row_gather.row_grads

    def gather_seen(table, sid, widths):
        gathers.append((table.detach(), sid, widths))
        return real_gather(table, sid, widths)

    def grads_seen(grads, sid, n_tab, widths, stats=None):
        out = real_grads(grads, sid, n_tab, widths, stats)
        backs.append((grads, sid, n_tab, widths, out))
        return out

    # the wrappers count their launches on the module's names, these two
    # here; this evaluation's counts are not read
    gather_seen.launches = grads_seen.launches = 0
    row_gather.gather_rows, row_gather.row_grads = gather_seen, grads_seen
    try:
        val_k, *leaf_k = loss_and_grads()
    finally:
        row_gather.gather_rows, row_gather.row_grads = real_gather, real_grads
    engages = row_gather.engages
    row_gather.engages = lambda table: False   # views of index_select rows
    try:
        val_i, *leaf_i = loss_and_grads()
    finally:
        row_gather.engages = engages
    torch.cuda.synchronize()
    check(len(gathers) == 3 * BOUNCES and len(backs) == 2 * BOUNCES,
          f"phase 5h: {len(gathers)} gathers and {len(backs)} backward "
          f"calls, not {3 * BOUNCES} and {2 * BOUNCES}")
    for table, sid, widths in gathers:
        got = torch.cat([g.reshape(sid.shape[0], -1)
                         for g in real_gather(table, sid, widths)], 1)
        check(torch.equal(got, table.index_select(0, sid.long())),
              f"phase 5h: gather_rows of {sum(widths)} columns is not "
              "index_select")
    # exact gradients (multiples of 2**-10, |sum| < 2**14) on each call's
    # ids, zero on the rays whose own gradients are all zero and None for
    # the groups that had none: the sums are exact, so index_add_'s too
    gen_d = torch.Generator(device=dev).manual_seed(18)
    row_gather_calls = []
    for grads, sid, n_tab, widths, out in backs:
        n = sid.shape[0]

        def nonzero(gs):
            m = torch.zeros(n, dtype=torch.bool, device=dev)
            for g in gs:
                if g is not None:
                    m |= (g.reshape(n, -1) != 0).any(1)
            return m

        live = nonzero(grads)
        exact = [None if g is None else
                 torch.randint(-2, 3, g.shape, generator=gen_d, device=dev)
                 .float().div_(1024)
                 .mul_(live.view(-1, *[1] * (g.dim() - 1)))
                 for g in grads]
        st = torch.zeros(2, dtype=torch.int64, device=dev)
        got = real_grads(exact, sid, n_tab, widths, st)
        rays, adds = st.tolist()
        check(torch.equal(got, row_gather.row_grads_plain(exact, sid, n_tab,
                                                          widths)),
              f"phase 5h: row_grads of {sum(widths)} columns is not "
              "index_add_ on exact gradients")
        check(rays == int(nonzero(exact).sum())
              and (0 < adds <= rays or rays == 0),
              f"phase 5h: row_grads counted {rays} rays and {adds} adds")
        # the step's own gradients: the float64 sum is the yardstick
        st.zero_()
        real_grads(grads, sid, n_tab, widths, st)
        rays, adds = st.tolist()
        g64 = [None if g is None else g.double() for g in grads]
        sum64 = row_gather.row_grads_plain(g64, sid, n_tab, widths)
        scale = row_gather.row_grads_plain(
            [None if g is None else g.abs() for g in g64], sid, n_tab,
            widths).norm(dim=1).clamp_min(1e-300)
        lib = row_gather.row_grads_plain(grads, sid, n_tab, widths)
        gap = ((out.double() - sum64).norm(dim=1) / scale).max().item()
        lib_gap = ((lib.double() - sum64).norm(dim=1) / scale).max().item()
        row_gather_calls.append(dict(
            columns=sum(widths), rays=n, rays_summed=rays, row_adds=adds,
            rays_per_add=rays / max(adds, 1), gap_vs_float64=gap,
            index_add_gap_vs_float64=lib_gap))
        check(rays == int(live.sum()),
              "phase 5h: row_grads counted other rays than the step's")
        check(gap <= ROW_RTOL, f"phase 5h: a row of row_grads lies {gap:.3g} "
              f"of its summed magnitudes from the float64 sum (bar "
              f"{ROW_RTOL:g})")
        err["row_grads_kernel"] = max(err["row_grads_kernel"], gap)
    leaf_gap = max(((a - b).norm() / b.norm()).item()
                   for a, b in zip(leaf_k, leaf_i))
    rays_per_add = (sum(c["rays_summed"] for c in row_gather_calls)
                    / max(sum(c["row_adds"] for c in row_gather_calls), 1))
    log(f"phase 5h: scene 1 {FRAME_W}x{FRAME_H}x{BOUNCES}: {len(gathers)} "
        f"gathers bit for bit index_select; {len(backs)} backward calls bit "
        "for bit index_add_ on exact gradients; on the step's own gradients "
        "each row within "
        + ", ".join(f"{c['gap_vs_float64']:.3g}" for c in row_gather_calls)
        + " of its summed magnitudes from the float64 sum (index_add_: "
        + ", ".join(f"{c['index_add_gap_vs_float64']:.3g}"
                    for c in row_gather_calls)
        + f"), {rays_per_add:.2f} rays a row add; against index_select's "
        f"views: loss {val_k.item():.9g} / {val_i.item():.9g}, leaves' "
        f"gradients {leaf_gap:.3g} apart (bar {LEAF_RTOL:g}); "
        f"{time.perf_counter() - t:.1f}s")
    check(val_k.item() == val_i.item(),
          "phase 5h: the loss through the gather kernels is not the loss "
          "through index_select")
    check(leaf_gap <= LEAF_RTOL, "phase 5h: the gradients through the "
          "gather kernels differ from those through index_select")
    held["gather_rows_kernel"].append(
        f"phase 5h: the {3 * BOUNCES} gathers of scene 1's grad leg at "
        f"{FRAME_W}x{FRAME_H}, their own tables and ids: bit-exact "
        "against index_select")
    held["row_grads_kernel"].append(
        f"phase 5h: the {2 * BOUNCES} backward calls of scene 1's grad leg "
        f"at {FRAME_W}x{FRAME_H}: bit-exact against index_add_ on exact "
        f"gradients at their ids, within {ROW_RTOL:g} of each row's summed "
        "magnitudes of the float64 sum on their own gradients; the loss "
        "bit for bit and the leaves' gradients within "
        f"{LEAF_RTOL:g} of those through index_select")
    return gathers, backs, row_gather_calls, rays_per_add


def row_gather_times(gathers, backs, dev):
    """ms (CUDA events), device ms (torch.profiler), host issue ms and the
    bytes bound of gather_rows_kernel and row_grads_kernel on the largest
    recorded call of each table (``row_gather_paths``), beside their plain
    versions and the library's index_select / index_add_. Returns the two
    {columns: dict}."""
    import torch
    from raytracer_tpu_torch.render import row_gather
    k_gather, k_grads = {}, {}
    for table, sid, widths in gathers:
        w = sum(widths)
        if sid.shape[0] >= k_gather.get(w, {}).get("rays", -1):
            k_gather[w] = dict(rays=sid.shape[0], args=(table, sid, widths))
    for grads, sid, n_tab, widths, _ in backs:
        w = sum(widths)
        if sid.shape[0] >= k_grads.get(w, {}).get("rays", -1):
            k_grads[w] = dict(rays=sid.shape[0],
                              args=(grads, sid, n_tab, widths))

    def timed(fn, lib, plain):
        return dict(ms=cuda_ms(fn, RESOLVE_CALLS),
                    device_ms=device_ms(fn, RESOLVE_CALLS),
                    host_ms=host_ms(fn, RESOLVE_CALLS),
                    plain_ms=cuda_ms(plain, RESOLVE_CALLS),
                    library_ms=cuda_ms(lib, RESOLVE_CALLS),
                    library_device_ms=device_ms(lib, RESOLVE_CALLS,
                                                csrc=False),
                    library_host_ms=host_ms(lib, RESOLVE_CALLS))

    for w, k in k_gather.items():
        table, sid, widths = k.pop("args")
        n, idx = sid.shape[0], sid.long()
        bound, by = bound_of(in_bytes=n * 4 + table.numel() * 4,
                             out_bytes=n * w * 4, ops=0)
        k.update(timed(lambda: row_gather.gather_rows(table, sid, widths),
                       lambda: table.index_select(0, idx),
                       lambda: row_gather.gather_rows_plain(table, sid,
                                                            widths)),
                 columns=w, bound_ms=bound, bound_by=by)
    for w, k in k_grads.items():
        grads, sid, n_tab, widths = k.pop("args")
        n, idx = sid.shape[0], sid.long()
        cols = torch.cat([sid.new_zeros(n, v, dtype=torch.float32)
                          if g is None else g.reshape(n, v)
                          for g, v in zip(grads, widths)], 1)
        acc = torch.zeros(n_tab, w, device=dev)
        with_grad = sum(v for g, v in zip(grads, widths) if g is not None)
        bound, by = bound_of(in_bytes=n * 4 + n * with_grad * 4,
                             out_bytes=n_tab * w * 4, ops=0)
        k.update(timed(lambda: row_gather.row_grads(grads, sid, n_tab,
                                                    widths),
                       lambda: acc.index_add_(0, idx, cols),
                       lambda: row_gather.row_grads_plain(grads, sid, n_tab,
                                                          widths)),
                 columns=w, columns_with_grad=with_grad, bound_ms=bound,
                 bound_by=by)
    for name, ks, lib in (("gather_rows_kernel", k_gather, "index_select"),
                          ("row_grads_kernel", k_grads, "index_add_")):
        for w, k in sorted(ks.items()):
            log(f"grad leg: {name} on {k['rays']} rays of {w} columns "
                f"{k['ms']:.4f} ms (device {fmt(k['device_ms'], 4)}, host "
                f"issue {k['host_ms']:.4f} ms), plain {k['plain_ms']:.4f} "
                f"ms; {lib} {k['library_ms']:.4f} ms (device "
                f"{fmt(k['library_device_ms'], 4)}, host issue "
                f"{k['library_host_ms']:.4f} ms); bound "
                f"{k['bound_ms']:.4f} ms ({k['bound_by']})")
    return k_gather, k_grads


def animated_paths(scenes, cfg, dev, gen, reset, read, names):
    """Phases 6-6d, the animated frame loop (render/dynamic.py). 6: the
    LBVH rebuilt on the card from the animated states of scenes 1 and 2
    (scene 1's spheres bounced to ANIM_T, scene 2's wheels turned
    ANIM_FRAMES times) equals the same build on the CPU table for table,
    and the animation, the build, the cull flags and make_tree make no
    host sync (sync debug mode "error"); the build's ms and launches. 6b:
    packet_kernel and occlusion_kernel over both LBVH trees bit for bit
    against their plain versions on seeded rays, then timed on the
    frame's primary rays and the light rays of their hits. 6c: the
    animated "split" streams at full width, 20 chained frames: scene 1's
    bounce through the one-launch frame, scene 2's wheels through
    update_dynamic and the sort_bounces hybrid; launches a frame, idle
    share, syncs a frame, and frame 5 against a static render of the same
    scene. 6d: the "pallas" frames (LBVH rebuild + packet renderer) timed
    with the rebuild's share, and at CHECK_W x CHECK_H held against the
    "wavefront" frame of the same tree. Returns the numbers for the
    kernels line."""
    import numpy as np
    import torch
    from raytracer_tpu_torch.accel import build_bvh, linearize, refit_grow
    from raytracer_tpu_torch.accel.lbvh import (build_lbvh,
                                                node_cullable_flags_device)
    from raytracer_tpu_torch.anim.animation import (bounce_spheres,
                                                    device_bounce,
                                                    device_wheels,
                                                    rotate_wheels)
    from raytracer_tpu_torch.core import camera as cam_ops
    from raytracer_tpu_torch.core.scene import WALL
    from raytracer_tpu_torch.geom.aabb import (shape_aabbs_device,
                                               shape_centers_device)
    from raytracer_tpu_torch.geom.direct import INF, wall_basis
    from raytracer_tpu_torch.render import dynamic, packet
    from raytracer_tpu_torch.render.split import render

    out = dict(build={}, kernels={"packet_kernel": {},
                                  "occlusion_kernel": {}},
               streams={}, pallas={})
    lin_fields = ("bounds", "leaf_start", "leaf_count", "skip", "perm")

    # the sync debug mode sees a host sync: .item() raises under "error"
    # and warns under "warn"
    probe = torch.ones(1, device=dev)
    try:
        no_sync(probe.item)
        raised = False
    except RuntimeError:
        raised = True
    check(raised and syncs(probe.item) >= 1,
          "torch.cuda.set_sync_debug_mode does not see a host sync")

    # -- phase 6: the LBVH on the card against the CPU build --------------
    t0 = time.perf_counter()
    lbvh_trees = {}
    for which in (1, 2):
        sc = scenes[which][0]
        bounce = (device_bounce(sc.bounce_params, dev)
                  if sc.bounce_params else None)
        wheels = device_wheels(sc.wheels, dev)

        def animate(flat):
            if bounce is not None:
                return bounce_spheres(flat, bounce, ANIM_T)
            for _ in range(ANIM_FRAMES):
                flat = rotate_wheels(flat, wheels, FRAME_DT)
            return flat

        def rebuild():
            flat = animate(sc.flat)
            inputs = (*shape_aabbs_device(flat), shape_centers_device(flat))
            lin = build_lbvh(*inputs)
            _, _, w_deg = wall_basis(flat.plane_normal)
            mask = w_deg & (flat.shape_type == WALL)
            flags = node_cullable_flags_device(lin, mask)
            return (flat, inputs, mask, lin, flags,
                    packet.make_tree(lin, flat, cull_flags=flags))

        rebuild()   # the first call makes the cached device constants
        flat, inputs, mask, lin, flags, tree = no_sync(rebuild)
        torch.cuda.synchronize()
        lin_c = build_lbvh(*(x.cpu() for x in inputs))
        flags_c = node_cullable_flags_device(lin_c, mask.cpu())
        same = [f for f in lin_fields
                if not torch.equal(getattr(lin, f).cpu(), getattr(lin_c, f))]
        check(not same and torch.equal(flags.cpu(), flags_c),
              f"scene {which}: the LBVH built on the card differs from the "
              f"CPU build in {same or 'the cull flags'}")
        check(lin.num_nodes == 2 * flat.num_shapes - 1
              and int(tree.leaf_count.sum()) == flat.num_shapes,
              "the LBVH is not 2n - 1 nodes of one-shape leaves")

        def build():
            return build_lbvh(*inputs)
        ms = cuda_ms(build, SLOW_REPS)
        issue_ms = host_ms(build, SLOW_REPS)
        times = kernel_times(build)
        launches = sum(c for _, _, c in times) if times else None
        busy = sum(t for _, t, _ in times) if times else None
        whole_ms = cuda_ms(rebuild, SLOW_REPS)
        out["build"][which] = dict(
            nodes=lin.num_nodes, ms=ms, host_issue_ms=issue_ms,
            device_busy_ms=busy, launches=launches,
            animate_build_flags_tree_ms=whole_ms,
            cullable_nodes=int(flags.sum()))
        log(f"phase 6: scene {which} LBVH of {flat.num_shapes} shapes "
            f"({lin.num_nodes} nodes, {int(flags.sum())} cullable) built "
            "on the card under sync debug mode 'error' (animation, AABBs, "
            "centres, build, cull flags, make_tree): equal to the CPU build "
            f"table for table; build {ms:.3f} ms a call ({SLOW_REPS} "
            f"builds, CUDA events), host issue {issue_ms:.3f} ms, "
            f"{launches if launches is not None else 'not measured'} "
            f"launches, device busy {fmt(busy)}; animation + build + flags "
            f"+ tree {whole_ms:.3f} ms")
        lbvh_trees[which] = (flat, lin, tree)
    log(f"phase 6 done in {time.perf_counter() - t0:.1f}s")

    # -- phase 6b: packet_kernel and occlusion_kernel over the LBVH trees --
    t0 = time.perf_counter()
    n_q = N_RAYS + 17   # a partial block and warp
    for which, (flat, lin, tree) in lbvh_trees.items():
        sc = scenes[which][0]
        o, d = query_rays(cam_ops, sc.camera, gen, dev, n_q)
        u = torch.rand(n_q, generator=gen).to(dev)
        tk, rk = packet.packet_hit(tree, o, d, cfg.use_mt, True)
        (tp, rp), p_ms = timed_once(lambda: packet.packet_plain(
            tree, o, d, cfg.use_mt, True))
        limit = torch.where(tp < INF, tp * (0.5 + u), 100 * u)
        limit[:8], limit[8:16] = float("inf"), float("nan")
        ok_ = packet.occlusion(tree, o, d, limit, cfg.use_mt, True)
        op_, o_ms = timed_once(lambda: packet.occlusion_plain(
            tree, o, d, limit, cfg.use_mt, True))
        log(f"phase 6b: scene {which} LBVH: packet {int((tp < INF).sum())} "
            f"hits, t differs on {int((tk != tp).sum())}, row on "
            f"{int((rk != rp).sum())}; occlusion {int(op_.sum())} occluded, "
            f"differs on {int((ok_ != op_).sum())} of {n_q} rays")
        check(torch.equal(tk, tp) and torch.equal(rk, rp)
              and torch.equal(ok_, op_),
              "packet/occlusion kernel disagrees with its plain version on "
              "the LBVH")
        # timing: the frame's primary rays, the light rays of their hits
        o_f, d_f = cam_ops.camera_rays(sc.camera, FRAME_W, FRAME_H)
        o_f, d_f = o_f.reshape(-1, 3).contiguous(), d_f.reshape(-1, 3)\
            .contiguous()
        t_f, _ = packet.packet_hit(tree, o_f, d_f, cfg.use_mt, True)
        hit = t_f < INF
        p = (o_f + (t_f - 1e-3)[:, None] * d_f)[hit]
        to_light = sc.light.position - p
        dist = to_light.norm(dim=1)
        lit_o = p.contiguous()
        lit_d = (to_light / dist[:, None]).contiguous()
        tbytes = sum(x.numel() * x.element_size() for x in (
            tree.leaf_start, tree.leaf_count, tree.skip, tree.nodes,
            tree.rows))
        runs = {
            "packet_kernel": (
                lambda st=None: packet.packet_hit(tree, o_f, d_f, cfg.use_mt,
                                                  True, stats=st),
                o_f.shape[0], tbytes + o_f.shape[0] * 24,
                o_f.shape[0] * 8, p_ms),
            "occlusion_kernel": (
                lambda st=None: packet.occlusion(tree, lit_o, lit_d, dist,
                                                 cfg.use_mt, True, stats=st),
                lit_o.shape[0], tbytes + lit_o.shape[0] * 28,
                lit_o.shape[0], o_ms)}
        for name, (run, n, in_b, out_b, plain_ms) in runs.items():
            ms = cuda_ms(run, TIMED_FRAMES)
            dms = device_ms(run, TIMED_FRAMES)
            st5 = torch.zeros(5, dtype=torch.int64, device=dev)
            run(st5)
            other, node, tri, w_node, w_row = st5.tolist()
            ops = (other * row_ops_other(flat) + node * OPS_NODE_CULL
                   + tri * OPS_ROW[3])
            bound, by = bound_of(in_bytes=in_b, out_bytes=out_b, ops=ops)
            tests = dict(other_rows=other, nodes=node, triangles=tri,
                         warp_node_steps=w_node, warp_row_steps=w_row,
                         **warp_steps(st5, -(-n // 32), other + tri))
            out["kernels"][name][which] = dict(
                tree=f"LBVH of the animated scene, {lin.num_nodes} nodes",
                ms=ms, device_ms=dms, plain_ms=plain_ms, plain_rays=n_q,
                rays=n, bound_ms=bound, bound_by=by, tests=tests)
            log(f"phase 6b: scene {which} {name} on the LBVH: {ms:.3f} ms "
                f"(device {fmt(dms)}) on {n} rays, plain {plain_ms:.1f} ms "
                f"on {n_q}; bound {bound:.4f} ms ({by}); {fmt_steps(tests)}")
    log(f"phase 6b done in {time.perf_counter() - t0:.1f}s")

    # -- phase 6c: the animated "split" streams at full width --------------
    streams = ((1, "bounce, one-launch", cfg, 1),
               (2, "wheels, sort_bounces hybrid",
                cfg.replace(sort_bounces=True), 2))
    for which, label, c, per_frame in streams:
        t0 = time.perf_counter()
        sc = scenes[which][0]
        frame = dynamic.make_frame_fn(sc, c, renderer="split")
        frame(sc.flat, sc.camera, sc.light, 0.0, FRAME_DT)   # warm-up
        no_sync(lambda: frame.update(sc.flat, FRAME_DT, FRAME_DT))
        n_sync = syncs(lambda: frame(sc.flat, sc.camera, sc.light, FRAME_DT,
                                     FRAME_DT))

        def chain(count):
            cur = sc.flat
            for k in range(count):
                img, cur = frame(cur, sc.camera, sc.light, k * FRAME_DT,
                                 FRAME_DT)
            return img, cur
        reset()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        chain(TIMED_FRAMES)
        end.record()
        torch.cuda.synchronize()
        got = read()
        ms = start.elapsed_time(end) / TIMED_FRAMES
        want = {k: 0 for k in names}
        want["wholeframe_kernel"] = per_frame * TIMED_FRAMES
        check(got == want, f"the {label} stream launched {got}, not {want}")
        busy, ours = device_busy_ms(lambda: frame(
            sc.flat, sc.camera, sc.light, FRAME_DT, FRAME_DT))
        update_ms = cuda_ms(lambda: frame.update(sc.flat, FRAME_DT,
                                                 FRAME_DT), TIMED_FRAMES)
        # frame 5 against a static render of the same scene: scene 1 over
        # the grow-refit of the reference tree, scene 2 a fresh prepare
        img5, flat5 = chain(6)
        if which == 1:
            ref_lin = linearize(refit_grow(build_bvh(
                sc.flat, sc.bvh_max_depth), flat5))
        else:
            ref_lin = linearize(build_bvh(flat5, sc.bvh_max_depth))
        ref = render(flat5, ref_lin, sc.camera, sc.light, c)
        diff = (img5 - ref).abs().amax(-1)
        share = (diff > 1e-4).float().mean().item()
        median = float(np.median(diff.cpu().numpy()))
        moved = (img5 - frame(sc.flat, sc.camera, sc.light, 0.0,
                              FRAME_DT)[0]).abs().max().item()
        out["streams"][which] = dict(
            stream=label, frame_ms=ms, fps=1000 / ms,
            update_ms=update_ms, device_busy_ms=busy, csrc_kernels_ms=ours,
            idle_share=None if busy is None else 1 - busy / ms,
            launches_per_frame=per_frame, host_syncs_per_frame=n_sync,
            frame5_share_over_1e4=share, frame5_median_abs=median)
        log(f"phase 6c: scene {which} {label} {FRAME_W}x{FRAME_H}x"
            f"{BOUNCES}: {ms:.3f} ms a frame over {TIMED_FRAMES} chained "
            f"frames ({1000 / ms:.1f} FPS), launches {got}; animation + "
            f"refresh {update_ms:.3f} ms, no host sync (sync debug mode "
            f"'error'); {n_sync} host syncs a frame (the render's; 'warn' "
            "mode); kernels busy the card "
            + ("(not measured)" if busy is None else
               f"{busy:.3f} ms ({ours:.3f} in csrc kernels), idle share "
               f"{1 - busy / ms:.3f}")
            + f"; frame 5 against a static render: {share:.5f} of pixels "
            f"> 1e-4, median {median:.3g}, moved {moved:.3g} from frame 0; "
            f"{time.perf_counter() - t0:.1f}s")
        check(bool(torch.isfinite(img5).all()) and share < 0.005
              and median <= 1e-6 and moved > 1e-3,
              f"the {label} stream's frame 5 differs from the static render")

    # -- phase 6d: the "pallas" frames (LBVH rebuild + packet renderer) ----
    small = cfg.replace(width=CHECK_W, height=CHECK_H)
    for which in (1, 2):
        t0 = time.perf_counter()
        sc = scenes[which][0]
        frame = dynamic.make_frame_fn(sc, cfg, renderer="pallas")
        frame(sc.flat, sc.camera, sc.light, 0.0, FRAME_DT)   # warm-up
        res = {}
        for label, occl, launched in (
                ("pallas", False, {"packet_kernel": 2 * BOUNCES}),
                ("pallas, USE_OCCLUSION", True,
                 {"packet_kernel": BOUNCES, "occlusion_kernel": BOUNCES})):
            packet.USE_OCCLUSION = occl
            try:
                reset()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                start.record()
                cur = sc.flat
                for k in range(SLOW_REPS):
                    img, cur = frame(cur, sc.camera, sc.light, k * FRAME_DT,
                                     FRAME_DT)
                end.record()
                torch.cuda.synchronize()
                got = read()
                ms = start.elapsed_time(end) / SLOW_REPS
                busy, ours = device_busy_ms(lambda: frame(
                    sc.flat, sc.camera, sc.light, FRAME_DT, FRAME_DT))
                n_sync = syncs(lambda: frame(sc.flat, sc.camera, sc.light,
                                             FRAME_DT, FRAME_DT))
            finally:
                packet.USE_OCCLUSION = False
            want = {k: launched.get(k, 0) * SLOW_REPS for k in names}
            check(got == want, f"the {label} frame launched {got}, not "
                  f"{want}")
            check(bool(torch.isfinite(img).all()) and img.std().item() > 1e-3,
                  f"the {label} frame is not finite or constant")
            res[label] = dict(frame_ms=ms, device_busy_ms=busy,
                              csrc_kernels_ms=ours,
                              host_syncs_per_frame=n_sync,
                              idle_share=None if busy is None
                              else 1 - busy / ms)
        update_ms = cuda_ms(lambda: frame.update(sc.flat, FRAME_DT,
                                                 FRAME_DT), SLOW_REPS)
        p_frame = dynamic.make_frame_fn(sc, small, renderer="pallas")
        w_frame = dynamic.make_frame_fn(
            sc, small.replace(ray_chunk=CHECK_W * CHECK_H),
            renderer="wavefront")
        ip, _ = p_frame(sc.flat, sc.camera, sc.light, 0.5, FRAME_DT)
        iw, _ = w_frame(sc.flat, sc.camera, sc.light, 0.5, FRAME_DT)
        vs_wave = (ip - iw).abs().max().item()
        out["pallas"][which] = dict(
            **res, lbvh_update_ms=update_ms,
            lbvh_share=update_ms / res["pallas"]["frame_ms"],
            max_abs_vs_wavefront_small=vs_wave)
        log(f"phase 6d: scene {which} pallas {FRAME_W}x{FRAME_H}x{BOUNCES}: "
            + ", ".join(f"{k} {v['frame_ms']:.3f} ms a frame over "
                        f"{SLOW_REPS} chained frames (idle share "
                        + ("not measured" if v["idle_share"] is None else
                           f"{v['idle_share']:.3f}")
                        + f", {v['host_syncs_per_frame']} host syncs)"
                        for k, v in res.items())
            + f"; animation + LBVH + flags {update_ms:.3f} ms "
            f"({update_ms / res['pallas']['frame_ms']:.3f} of the frame); "
            f"at {CHECK_W}x{CHECK_H} max-abs {vs_wave:.3g} against the "
            f"wavefront frame (bar {PACKET_ATOL:g}); "
            f"{time.perf_counter() - t0:.1f}s")
        check(bool(torch.isfinite(ip).all()) and vs_wave <= PACKET_ATOL,
              "the pallas frame differs from the wavefront frame")
    return out


# The scripted play session of phase 7d: each event renders one frame.
PLAY_EVENTS = ("key w 0.5", "mouse 40 -25", "material 0:color=1,0,0",
               "light pos 5 -20 10", "bvh off", "bvh on",
               "renderer pallas-bvh", "renderer pallas",
               "renderer reference", "renderer cpu", "quit")
# The plain versions that a pallas* renderer must not reach on the card.
PLAIN_FNS = (("wholeframe", "wholeframe_plain"), ("packet", "packet_plain"),
             ("packet", "occlusion_plain"), ("brute", "brute_plain"),
             ("split", "closest_hit_plain"), ("split", "fused_plain"),
             ("split", "resolve_plain"), ("split", "closest_hit_attrs_plain"))


def cli_paths(dev, card, reset, read, names, size=(FRAME_W, FRAME_H),
              play_size=(CHECK_W, CHECK_H)):
    """Phase 7, the port's command line (``raytracer_tpu_torch.cli``)
    driven in-process, each command with the launch counts set to 0 just
    before it and read just after, with every plain version of a kernel
    set to raise (the command line never renders a pallas* renderer
    through one on the card). 7a: ``render`` of scene 1 and of scene 2
    with --sort-bounces (pallas-split) to PNGs that must equal, byte for
    byte, ``to_uint8`` of ``split.render`` of the same inputs. 7b:
    ``bench --iters 20`` (pallas-split) on scenes 1 and 2. 7c: the
    brute-force oracle (``render/reference.py`` with the reference tree's
    leaf boxes) on the card against the one-launch frames and scene 2's
    hybrid: pixels beyond 2e-5 and 1e-4 (at most PER_BOUNCE_MAX_FRACTION
    of the frame), max-abs, frame ms and peak memory; and a forced tie
    of batched.closest_hit; the oracle also against the packet frame
    (the wavefront frame, phase 5d). 7d: a scripted ``play`` session whose every
    saved frame equals a direct call of the same renderer with the same
    camera, scene and configuration. 7e: ``animate --dynamic`` of scene
    2 (pallas-split): frames written and the last fps. Returns the
    results, one dict a sub-phase."""
    import contextlib
    import io
    import tempfile

    import numpy as np
    import torch
    from raytracer_tpu_torch import cli
    from raytracer_tpu_torch.accel import build_bvh, linearize
    from raytracer_tpu_torch.accel.linearize import shape_leaf_boxes
    from raytracer_tpu_torch.config import RenderConfig
    from raytracer_tpu_torch.core import camera as cam_ops
    from raytracer_tpu_torch.core.scene import SceneBuilder
    from raytracer_tpu_torch.geom import batched
    from raytracer_tpu_torch.io.image import read_png, to_uint8
    from raytracer_tpu_torch.render import (brute, cpu_fallback, packet,
                                            reference, wholeframe)
    from raytracer_tpu_torch.render import split as split_mod
    from raytracer_tpu_torch.scenes import generate_scene

    w, h = size
    dev_flag = ["--device", str(dev)]
    out = {}
    modules = {"wholeframe": wholeframe, "packet": packet, "brute": brute,
               "split": split_mod}

    def no_plain(name):
        def raiser(*a, **k):
            raise AssertionError(f"the command line reached {name} on "
                                 f"{dev}")
        return raiser

    @contextlib.contextmanager
    def kernels_only():
        saved = [(modules[m], f, getattr(modules[m], f))
                 for m, f in PLAIN_FNS]
        if dev.type == "cuda":
            for mod, f, _ in saved:
                setattr(mod, f, no_plain(f))
        try:
            yield
        finally:
            for mod, f, fn in saved:
                setattr(mod, f, fn)

    def run(argv, want):
        """cli.main(argv) with the counts set to 0 before and read after;
        each kernel in ``want`` must have launched that many times (None:
        at least once), every other kernel none. Returns (its stdout,
        the counts)."""
        buf = io.StringIO()
        with kernels_only(), contextlib.redirect_stdout(buf):
            reset()
            cli.main(argv + dev_flag)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            got = read()
        text = buf.getvalue()
        print(text, end="", flush=True)
        for k in names:
            n = want.get(k, 0)
            check(got[k] > 0 if n is None else got[k] == n,
                  f"{' '.join(argv[:3])}: {k} launched {got[k]} times, "
                  f"not {'at least once' if n is None else n}")
        return text, got

    def scene(which, width, height):
        sc = generate_scene(which, aspect=width / height, device=dev)
        return sc, linearize(build_bvh(sc.flat, sc.bvh_max_depth))

    tmp = tempfile.TemporaryDirectory()
    try:
        # -- 7a: render to PNG, held against split.render byte for byte ---
        t0 = time.perf_counter()
        out["7a"] = {}
        for which, sort in ((1, False), (2, True)):
            path = os.path.join(tmp.name, f"scene{which}.png")
            argv = ["render", "--scene", str(which), "--width", str(w),
                    "--height", str(h), "--bounces", str(BOUNCES),
                    "--renderer", "pallas-split", "--out", path]
            _, got = run(argv + (["--sort-bounces"] if sort else []),
                         {"wholeframe_kernel": 2 if sort else 1})
            sc, lin = scene(which, w, h)
            cfg = RenderConfig(width=w, height=h, max_bounces=BOUNCES,
                               sort_bounces=sort)
            want = to_uint8(split_mod.render(sc.flat, lin, sc.camera,
                                             sc.light, cfg, device=dev))
            png = read_png(path)
            equal = bool(np.array_equal(png, want))
            out["7a"][f"scene {which}"] = dict(
                sort_bounces=sort, png_equals_direct=equal,
                launches={k: v for k, v in got.items() if v})
            check(equal, f"7a: scene {which}'s PNG differs from "
                  "to_uint8(split.render(...))")
        log(f"phase 7a: render --renderer pallas-split to PNG at {w}x{h}: "
            f"{out['7a']} ({time.perf_counter() - t0:.1f}s)")

        # -- 7b: bench --------------------------------------------------
        out["7b"] = {}
        for which in (1, 2):
            iters = 20
            text, _ = run(["bench", "--scene", str(which), "--width",
                           str(w), "--height", str(h), "--renderer",
                           "pallas-split", "--iters", str(iters)],
                          {"wholeframe_kernel": iters + 2})
            stats = json.loads(text.strip().splitlines()[-1])
            stats["card"] = card
            out["7b"][f"scene {which}"] = stats
            print(json.dumps(stats), flush=True)
            check(stats["iters"] == iters and stats["fps"] > 0,
                  "7b: bench printed no frame rate")

        # -- 7c: the oracle on the card ----------------------------------
        out["7c"] = {}
        bound = int(PER_BOUNCE_MAX_FRACTION * w * h)
        for which in (1, 2):
            sc, lin = scene(which, w, h)
            boxes = shape_leaf_boxes(lin, sc.num_shapes)
            cfg = RenderConfig(width=w, height=h, max_bounces=BOUNCES)
            reset()
            if dev.type == "cuda":
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            before = (torch.cuda.memory_allocated() if dev.type == "cuda"
                      else 0)
            oracle, ms = timed_once(lambda: reference.render(
                sc.flat, sc.camera, sc.light, cfg, leaf_boxes=boxes,
                device=dev))
            peak = (torch.cuda.max_memory_allocated() - before
                    if dev.type == "cuda" else None)
            got = read()
            check(not any(got.values()), f"7c: the oracle launched {got}")
            check(bool(torch.isfinite(oracle).all()),
                  "7c: the oracle's frame is not finite")
            res = dict(oracle_ms=ms, oracle_peak_bytes=peak,
                       held_before_bytes=before)
            args = (sc.flat, lin, sc.camera, sc.light)
            routes = {"one-launch": lambda: split_mod.render(
                *args, cfg, device=dev)}
            if which == 2:
                routes["hybrid"] = lambda: split_mod.render(
                    *args, cfg.replace(sort_bounces=True), device=dev)
            # the packet frame equals the wavefront frame (phase 5d), the
            # oracle's counterpart with the raw barycentric test
            routes["packet"] = lambda: packet.render(*args, cfg, device=dev)
            for route, frame in routes.items():
                err = (frame() - oracle).abs().amax(-1)
                res[route] = dict(px_over_2e5=int((err > 2e-5).sum()),
                                  px_over_1e4=int((err > 1e-4).sum()),
                                  max_abs=float(err.max()))
                check(res[route]["px_over_1e4"] <= bound,
                      f"7c: scene {which}: the {route} frame differs from "
                      f"the oracle on {res[route]['px_over_1e4']} pixels "
                      f"over 1e-4 (bound {bound})")
                # the JAX package's bar of the wavefront frame against the
                # oracle with leaf boxes (tests/test_scene2_parity.py:36)
                check(route != "packet"
                      or res[route]["max_abs"] <= PACKET_ATOL,
                      f"7c: scene {which}: the packet frame differs from "
                      f"the oracle by {res[route]['max_abs']:.3g}")
            out["7c"][f"scene {which}"] = res
            log(f"phase 7c: scene {which} oracle {w}x{h}x{BOUNCES}: "
                f"{ms:.1f} ms, peak {fmt_bytes(peak)} above the "
                f"{fmt_bytes(before)} held before; "
                + "; ".join(f"{r} frame: {v['px_over_2e5']} px > 2e-5, "
                            f"{v['px_over_1e4']} px > 1e-4 (bound {bound}), "
                            f"max-abs {v['max_abs']:.3g}"
                            for r, v in res.items() if isinstance(v, dict))
                + f" ({card})")
        # ties go to the lowest shape index on the card, as in the scan
        b = SceneBuilder()
        for c, r in (((0, 0, -5), 1.0), ((0, 0, -4), 0.5),
                     ((3, 0, -8), 1.0), ((0, 0, -4), 0.5)):
            b.add_sphere(c, r)
        g = torch.linspace(-0.07, 0.07, 9, device=dev)
        d = torch.stack([g.repeat(9), g.repeat_interleave(9),
                         -torch.ones(81, device=dev)], 1)
        d = d / d.norm(dim=1, keepdim=True)
        _, sid, hit = batched.closest_hit(batched.precompute(b.build(dev)),
                                          torch.zeros_like(d), d)
        out["7c"]["tie_to_lowest_index"] = bool(hit.all() and (sid == 1).all())
        check(out["7c"]["tie_to_lowest_index"],
              "7c: a tie did not go to the lowest shape index")

        # -- 7d: a scripted play session ---------------------------------
        t0 = time.perf_counter()
        pw, ph = play_size
        script = os.path.join(tmp.name, "session.txt")
        with open(script, "w") as f:
            f.write("\n".join(PLAY_EVENTS) + "\n")
        play_dir = os.path.join(tmp.name, "play")
        frames = PLAY_EVENTS.index("quit")
        _, launched = run(
            ["play", "--scene", "1", "--width", str(pw), "--height", str(ph),
             "--renderer", "pallas-split", "--script", script, "--out-dir",
             play_dir],
            {"wholeframe_kernel": 6, "packet_kernel": 2 * BOUNCES,
             "brute_kernel": 2 * BOUNCES})
        # the same session by direct calls of the renderers
        sc, lin = scene(1, pw, ph)
        cfg = RenderConfig(width=pw, height=ph, max_bounces=BOUNCES)
        flat, cam, light, bvh = sc.flat, sc.camera, sc.light, lin
        direct = {
            "pallas-split": lambda: split_mod.render(
                flat, bvh, cam, light, cfg, device=dev),
            "pallas-bvh": lambda: packet.render(flat, bvh, cam, light, cfg,
                                                device=dev),
            "pallas": lambda: brute.render(flat, bvh, cam, light, cfg,
                                           device=dev),
            "reference": lambda: reference.render(flat, cam, light, cfg,
                                                  device=dev),
            "cpu": lambda: cpu_fallback.render(flat, cam, light, cfg,
                                               device=dev),
        }
        renderer, diffs = "pallas-split", []
        for i, ev in enumerate(PLAY_EVENTS[:frames]):
            kind, *args = ev.split()
            if kind == "key":
                cam = cam_ops.move(cam, cli._KEYMAP[args[0]], float(args[1]))
            elif kind == "mouse":
                cam = cam_ops.mouse_look(cam, float(args[0]), float(args[1]))
            elif kind == "material":
                flat = cli._apply_material_spec(flat, args[0])
            elif kind == "light":
                light = cli._apply_light(light, pos=[float(v)
                                                     for v in args[1:]])
            elif kind == "bvh":
                cfg = cfg.replace(use_bvh=args[0] == "on")
                bvh = lin if args[0] == "on" else None
            elif kind == "renderer":
                renderer = args[0]
            want = to_uint8(direct[renderer]())
            png = read_png(os.path.join(play_dir, f"play_{i:04d}.png"))
            diffs.append(int(np.abs(png.astype(int) - want.astype(int))
                             .max()))
        out["7d"] = dict(events=list(PLAY_EVENTS), frames=frames,
                         max_abs_vs_direct=diffs,
                         launches={k: v for k, v in launched.items() if v})
        log(f"phase 7d: play at {pw}x{ph}, {frames} frames: max-abs (uint8) "
            f"against direct renders {diffs}; launches {out['7d']['launches']}"
            f" ({time.perf_counter() - t0:.1f}s)")
        check(diffs == [0] * frames,
              "7d: a play frame differs from the direct render")

        # -- 7e: animate --dynamic ---------------------------------------
        anim_dir = os.path.join(tmp.name, "anim")
        n_anim = 5
        text, _ = run(["animate", "--dynamic", "--renderer", "pallas-split",
                       "--scene", "2", "--frames", str(n_anim), "--width",
                       str(w), "--height", str(h), "--out-dir", anim_dir],
                      {"wholeframe_kernel": n_anim})
        written = sorted(os.listdir(anim_dir))
        fps = float(re.search(r"last fps=([0-9.]+)", text).group(1))
        out["7e"] = dict(frames_written=len(written), last_fps=fps,
                         card=card)
        log(f"phase 7e: animate --dynamic scene 2 at {w}x{h}: "
            f"{len(written)} frames written, last fps {fps} ({card})")
        check(written == [f"frame_{i:04d}.png" for i in range(n_anim)],
              f"7e: wrote {written}")
    finally:
        tmp.cleanup()
    return out


def sharded_paths(scenes, cfg, dev, reset, read, names, err):
    """Phase 8, the strip-sharded route (raytracer_tpu_torch/parallel) and
    the examples' fits. 8a: wholeframe_kernel's window mode (rows, y_off)
    against wholeframe_plain at ODD_W x ODD_H cut into 3 strips of
    ceil(ODD_H / 3) rows (the last reaching past the image), in raygen,
    emit and consume (the strip's own re-sorted rays, window-order ret),
    bit for bit, and the strips put together equal to the whole frame's
    launch. 8b: render_sharded_split of scene 1 (the one-launch frame) and
    scene 2 (the sort_bounces hybrid) at 800x600x3 on meshes of 2 and 4
    strips on this card, and over every visible card where there are
    more than one: each frame equal to split.render's (torch.equal), its
    launches, its host syncs (sync debug mode "warn"), and its ms by CUDA
    events over TIMED_FRAMES frames beside the single frame's. 8c: the
    sharded differentiable route of scene 1 on 4 shards (ray shards
    through kernel 2, gradients summed over the shards): the loss and the
    gradients of sphere 0's centre and colour against the single-device
    route within GRAD_RTOL_OF_MAX of the largest component, and both
    fwd+bwd ms. 8d: parallel.dryrun.dryrun_multichip on 4 virtual shards
    of this card, and over every visible card where there are more than
    one. 8e: the examples' --kernel and --kernel-camera fits at
    SMOKE_FIT_STEPS steps (their success checks recorded, not raised):
    the loss falls; the recovery errors. Adds 8a's error to
    err["wholeframe_kernel"]; returns the results, one dict a
    sub-phase."""
    import contextlib
    import io
    import shutil
    import tempfile

    import torch
    from raytracer_tpu_torch import diff as rt_diff
    from raytracer_tpu_torch.examples import inverse
    from raytracer_tpu_torch.parallel import make_mesh, render_sharded_split
    from raytracer_tpu_torch.parallel.dryrun import dryrun_multichip
    from raytracer_tpu_torch.render import wholeframe as wf
    from raytracer_tpu_torch.render.split import render
    from raytracer_tpu_torch.render.split_scene import update_dynamic

    out = {}
    n_cards = torch.cuda.device_count()
    multi = (f"over the {n_cards} visible cards" if n_cards > 1 else
             "not run: 1 card visible (the multi-card case is unverified)")

    def sync_all():
        for k in range(n_cards):
            torch.cuda.synchronize(k)

    # -- phase 8a: the window mode against the plain version ---------------
    t0 = time.perf_counter()
    odd = cfg.replace(width=ODD_W, height=ODD_H)
    rows = -(-ODD_H // 3)
    w_err, n_px = 0.0, 0
    for which, (sc, _, split, tab) in scenes.items():
        whole = wf.wholeframe(split, tab, wf.make_params(sc.camera, sc.light),
                              odd)
        parts = []
        for k in range(3):
            par = wf.make_params(sc.camera, sc.light, y_off=k * rows)
            ik = wf.wholeframe(split, tab, par, odd, rows=rows)
            ip = wf.wholeframe_plain(split, tab, par, odd, rows=rows)
            ck, sk = wf.wholeframe(split, tab, par, odd, bounces=1,
                                   emit_state=True, rows=rows)
            cp, sp_ = wf.wholeframe_plain(split, tab, par, odd, bounces=1,
                                          emit_state=True, rows=rows)
            rays, perm = wf._repack(sp_, 9)
            ret = perm.to(torch.int32)
            kk, ks = wf.wholeframe(split, tab, par, odd, bounces=BOUNCES - 1,
                                   emit_state=True, rays=rays, ret=ret,
                                   rows=rows)
            pk, ps = wf.wholeframe_plain(split, tab, par, odd,
                                         bounces=BOUNCES - 1,
                                         emit_state=True, rays=rays, ret=ret,
                                         rows=rows)
            pairs = [(ik, ip), (ck, cp), (sk, sp_), (kk, pk), (ks, ps)]
            w_err = max([w_err] + [(a - b).abs().max().item()
                                   for a, b in pairs])
            check(all(torch.equal(a, b) for a, b in pairs),
                  f"phase 8a: scene {which} strip {k}: the window mode "
                  "disagrees with wholeframe_plain")
            check(bool(torch.isfinite(ik).all()), "non-finite pixels")
            parts.append(ik)
            n_px += ik.shape[0] * ik.shape[1]
        check(torch.equal(torch.cat(parts)[:ODD_H], whole),
              f"phase 8a: scene {which}: the strips differ from the frame")
    torch.cuda.synchronize()
    err["wholeframe_kernel"] = max(err["wholeframe_kernel"], w_err)
    out["8a"] = dict(size=f"{ODD_W}x{ODD_H}x{BOUNCES}", strips=3,
                     rows=rows, modes=["raygen", "raygen+emit",
                                       "consume+emit"],
                     max_abs=w_err, bit_exact=True,
                     seconds=time.perf_counter() - t0)
    log(f"phase 8a: window mode at {ODD_W}x{ODD_H}x{BOUNCES}, 3 strips of "
        f"{rows} rows ({n_px} window pixels a mode, scenes 1 and 2): raygen,"
        f" emit and consume bit-exact against wholeframe_plain (max-abs "
        f"{w_err:.3g}); the strips equal the whole frame; "
        f"{time.perf_counter() - t0:.1f}s")
    reset()   # 8a's launches compare the kernel with its plain version

    # -- phase 8b: strip-sharded frames at full width ----------------------
    meshes = [(f"2 strips on {dev}", make_mesh(2, device=dev)),
              (f"4 strips on {dev}", make_mesh(4, device=dev))]
    if n_cards > 1:
        meshes.append((f"{n_cards} cards", make_mesh()))
    log(f"phase 8b: the multi-card case: {multi}")
    out["8b"] = dict(multi_card=multi, frames={})
    for which, label, c in ((1, "one-launch", cfg),
                            (2, "hybrid", cfg.replace(sort_bounces=True))):
        sc, lin, split, _ = scenes[which]
        ref = render(sc.flat, lin, sc.camera, sc.light, c, split=split)
        one_ms = cuda_ms(lambda: render(sc.flat, lin, sc.camera, sc.light, c,
                                        split=split), TIMED_FRAMES)
        per_strip = 2 if c.sort_bounces else 1
        for name, mesh in meshes:
            t0 = time.perf_counter()

            def frame():
                return render_sharded_split(sc.flat, split, sc.camera,
                                            sc.light, c, mesh)
            frame()   # warm-up (the replicas' first copies)
            sync_all()
            reset()
            img = frame()
            sync_all()
            got = read()
            modes = dict(wf.wholeframe.mode_launches)
            want = {k: 0 for k in names}
            want["wholeframe_kernel"] = per_strip * len(mesh)
            n_sync = syncs(frame)
            ms = cuda_ms(frame, TIMED_FRAMES)
            busy, ours = device_busy_ms(frame)
            equal = torch.equal(img, ref)
            key = f"scene {which} {label}, {name}"
            out["8b"]["frames"][key] = dict(
                ms=ms, single_ms=one_ms, launches=got["wholeframe_kernel"],
                modes=modes, host_syncs=n_sync, device_busy_ms=busy,
                csrc_kernels_ms=ours,
                idle_share=None if busy is None else 1 - busy / ms,
                equal=equal)
            log(f"phase 8b: {key} {c.width}x{c.height}x{BOUNCES}: {ms:.3f} "
                f"ms a frame over {TIMED_FRAMES} (single frame {one_ms:.3f}"
                f" ms), device busy {fmt(busy)} ({fmt(ours)} in csrc "
                f"kernels), launches {got['wholeframe_kernel']} {modes}, "
                f"{n_sync} host syncs "
                f"a frame, torch.equal to split.render: {equal}; "
                f"{time.perf_counter() - t0:.1f}s")
            check(got == want, f"phase 8b: {key} launched {got}, not {want}")
            check(equal, f"phase 8b: {key} differs from split.render "
                  f"(max-abs {(img - ref).abs().max().item():.3g})")

    # -- phase 8c: the sharded differentiable route -------------------------
    t0 = time.perf_counter()
    sc, lin, split, _ = scenes[1]
    flat1 = sc.flat
    with torch.no_grad():
        target = render(flat1, lin, sc.camera, sc.light, cfg, split=split,
                        differentiable=True)
    p0 = {"center": flat1.sphere_center[0] + 0.3,
          "color": flat1.mat_color[0] * 0.8}

    def loss_and_grads(mesh):
        p = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
        s = flat1.replace(
            sphere_center=torch.cat([p["center"][None],
                                     flat1.sphere_center[1:]]),
            mat_color=torch.cat([p["color"][None], flat1.mat_color[1:]]))
        sp = update_dynamic(split, s)
        if mesh is None:
            img = render(s, lin, sc.camera, sc.light, cfg, split=sp,
                         differentiable=True)
        else:
            img = render_sharded_split(s, sp, sc.camera, sc.light, cfg, mesh,
                                       differentiable=True)
        val = rt_diff.image_loss(img, target)
        return (val.detach(),) + torch.autograd.grad(val, [p["center"],
                                                           p["color"]])

    mesh4 = make_mesh(4, device=dev)
    res = {}
    for name, mesh in (("single device", None), ("4 shards", mesh4)):
        reset()
        res[name] = loss_and_grads(mesh)
        torch.cuda.synchronize()
        got = read()
        shards = 1 if mesh is None else 4
        want = {k: 0 for k in names}
        want["closest_hit_kernel"] = 2 * BOUNCES * shards
        want["gather_rows_kernel"] = 3 * BOUNCES * shards
        want["row_grads_kernel"] = 2 * BOUNCES * shards
        check(got == want, f"phase 8c: {name} launched {got}, not {want}")
    one_ms = cuda_ms(lambda: loss_and_grads(None), 5)
    four_ms = cuda_ms(lambda: loss_and_grads(mesh4), 5)
    g1 = torch.cat(res["single device"][1:])
    g4 = torch.cat(res["4 shards"][1:])
    v1, v4 = res["single device"][0].item(), res["4 shards"][0].item()
    g_err = (g4 - g1).abs().max().item()
    g_max = g1.abs().max().item()
    rel = ((g4 - g1).abs() / g1.abs().clamp_min(1e-30)).max().item()
    out["8c"] = dict(loss_single=v1, loss_sharded=v4,
                     grad_single=g1.tolist(), grad_sharded=g4.tolist(),
                     grad_max_abs_err=g_err, grad_max_rel_err=rel,
                     fwd_bwd_ms_single=one_ms, fwd_bwd_ms_sharded=four_ms)
    log(f"phase 8c: scene 1 differentiable {cfg.width}x{cfg.height}x"
        f"{BOUNCES} on 4 shards: loss {v4:.7g} (single device {v1:.7g}); d/d centre "
        f"and colour {g4.tolist()} (single {g1.tolist()}); max-abs "
        f"{g_err:.3g} of largest {g_max:.3g}, max relative {rel:.3g}; "
        f"fwd+bwd {four_ms:.2f} ms (single device {one_ms:.2f}); "
        f"{time.perf_counter() - t0:.1f}s")
    check(bool(torch.isfinite(g4).all()) and bool((g4 != 0).any()),
          "phase 8c: gradients not finite or all zero")
    check(abs(v4 - v1) <= 1e-4 * abs(v1) and g_err <= GRAD_RTOL_OF_MAX * g_max,
          "phase 8c: the sharded gradients differ from the single device's")

    # -- phase 8d: the dry run ---------------------------------------------
    t0 = time.perf_counter()
    out["8d"] = {f"4 shards on {dev}": dryrun_multichip(4, device=dev)}
    if n_cards > 1:
        out["8d"][f"{n_cards} cards"] = dryrun_multichip()
    log(f"phase 8d: dryrun_multichip on 4 shards of {dev}; the multi-card "
        f"dry run: {multi}; {time.perf_counter() - t0:.1f}s")

    # -- phase 8e: the examples' fits ---------------------------------------
    fits = {}
    fit_out = tempfile.mkdtemp(prefix="chip_smoke_fits_")
    for flag, fn, lr in (("--kernel", inverse.main_kernel, 0.1),
                         ("--kernel-camera", inverse.main_kernel_camera,
                          0.02)):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):   # the records
            rec = fn(SMOKE_FIT_STEPS, lr, out=fit_out, device=dev,
                     strict=False)
        errs = {k: rec[k] for k in ("center_err", "pos_err", "yaw_err_deg",
                                    "pitch_err_deg") if k in rec}
        fits[flag] = dict(steps=SMOKE_FIT_STEPS, lr=lr,
                          loss_first=rec["loss_first"],
                          loss_last=rec["loss_last"],
                          loss_best=rec.get("loss_best", rec["loss_last"]),
                          checks_passed=rec["passed"],
                          wall_s=time.perf_counter() - t0, **errs)
        log(f"phase 8e: {flag} at {SMOKE_FIT_STEPS} steps: loss "
            f"{rec['loss_first']:.6g} -> {rec['loss_last']:.6g}, recovery "
            f"errors {errs}, the example's checks passed: {rec['passed']}; "
            f"{time.perf_counter() - t0:.1f}s")
        check(fits[flag]["loss_best"] < rec["loss_first"],
              f"phase 8e: {flag}: the loss did not fall")
    shutil.rmtree(fit_out)
    out["8e"] = fits
    return out


def no_sync(fn):
    """fn() under sync debug mode "error": a host sync raises."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)


def syncs(fn):
    """The host syncs that fn() makes (sync debug mode "warn")."""
    import warnings

    import torch
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in caught)


def fmt_bytes(n):
    return "not measured" if n is None else f"{n / 2**20:.1f} MiB"


def timed_once(fn):
    """(fn(), its ms by CUDA events): one call."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    result = fn()
    end.record()
    torch.cuda.synchronize()
    return result, start.elapsed_time(end)


def pixel_rays(cam_ops, camera, pix):
    """Primary rays through flat pixel indices of the 800x600 frame."""
    import torch
    from raytracer_tpu_torch.geom.direct import div_rn
    x = (pix % FRAME_W).to(torch.float32)
    y = (pix // FRAME_W).to(torch.float32)
    o, d = cam_ops.get_rays(camera, div_rn(2.0 * x, FRAME_W) - 1.0,
                            1.0 - div_rn(2.0 * y, FRAME_H))
    return o.contiguous(), d.contiguous()


def query_rays(cam_ops, camera, gen, dev, n=N_RAYS):
    """n seeded rays: half from random points in random directions, half
    primary rays through random pixels; a tenth parked, 8 with a NaN origin
    and 8 with a zero direction (the shadow rays of ended lanes)."""
    import torch
    half = n // 2
    o = torch.rand(half, 3, generator=gen) * 80 - 40
    d = torch.randn(half, 3, generator=gen)
    d = d / d.norm(dim=1, keepdim=True)
    o_s, d_s = pixel_rays(cam_ops, camera,
                          torch.randint(0, FRAME_W * FRAME_H, (n - half,),
                                        generator=gen).to(dev))
    o = torch.cat([o.to(dev), o_s])
    d = torch.cat([d.to(dev), d_s])
    parked = torch.randperm(n, generator=gen)[:n // 10].to(dev)
    o[parked] = 2e30
    d[parked] = 0.5773502691896258
    o[parked[:8], 1] = float("nan")
    o[parked[8:16]] = 1e30
    d[parked[8:16]] = 0.0
    return o.contiguous(), d.contiguous()


def typed_scene(dev):
    """Spheres, a plane, a finite and a degenerate-basis wall and triangles
    (one degenerate) in front of a default camera: every typed loop of
    brute_kernel."""
    from raytracer_tpu_torch.core import SceneBuilder
    b = SceneBuilder()
    b.add_sphere((0, -0.6, -4), 0.7)
    b.add_sphere((1.2, 0.5, -6), 0.8)
    b.add_plane((0, 0, -1), (0, 0, -9))
    b.add_wall((-3, -2, -7), 2, 3, (-1, 0, -1))
    b.add_wall((-20, 2, -20), 40, 40, (0, 1, 0))
    b.add_triangle((-2.5, -1, -5), (-0.5, -1, -5), (-1.5, 1.2, -5))
    b.add_triangle((1, -1, -3), (2, -1, -3.5), (1.5, 0, -3.2))
    b.add_triangle((-1, 1, -5), (0, 1, -5), (-0.5, 1, -5))
    return b.build(device=dev)


def single_runs(rows):
    """A run table of brute_kernel with one run a row: not maximal, but
    every run still holds rows of one box and one type."""
    import torch
    from raytracer_tpu_torch.render import brute
    n = rows.shape[0]
    idx = torch.arange(n, device=rows.device, dtype=torch.float32)
    return torch.cat([rows[:, brute.F_B0X:brute.PACK_EXT], idx[:, None],
                      torch.ones_like(idx)[:, None]], dim=1).contiguous()


def needed_rows(runs, counts, o, d, chunk=8192):
    """Row tests that brute_kernel's gate leaves, by shape type: summed
    over the rays, the rows of each run whose box the ray hits (box_gate's
    slab test, in PyTorch); a ray of zero direction needs none."""
    import torch
    from raytracer_tpu_torch.geom import rowwise
    keep = (d != 0).any(1)
    o, d = o[keep], d[keep]
    start, cnt = runs[:, 6].long(), runs[:, 7].long()
    ends = torch.tensor(counts, device=runs.device).cumsum(0)
    typ = sum((start >= ends[k]).long() for k in range(3))
    hits = torch.zeros(runs.shape[0], dtype=torch.int64, device=runs.device)
    for c in range(0, o.shape[0], chunk):
        oc, dc = o[c:c + chunk, None], d[c:c + chunk, None]
        tmin, tmax = rowwise.slab(runs[None, :, :6], oc, 1.0 / dc)
        hits += ((tmax >= tmin) & (tmax > 0)).sum(0)
    return [int((hits * cnt)[typ == k].sum()) for k in range(4)]


def row_ops_other(flat):
    """Mean f32 operations of a non-triangle row test over the scene's
    spheres, planes and walls."""
    counts = [int((flat.shape_type == k).sum()) for k in range(3)]
    return sum(c * OPS_ROW[k] for k, c in enumerate(counts)) / max(
        sum(counts), 1)


def kernel_times(fn):
    """(kernel name, device ms, launches) of each kernel of one call of
    ``fn``, from torch.profiler's key_averages; empty when it records no
    device time. A short spin kernel of torch's own (``torch.cuda._sleep``)
    opens and closes the window and is left out: on some machines a window
    loses the record of its first or last kernel (``device_ms`` then reads
    None), and with the spin kernels around the calls it loses one of
    those instead."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(SPIN_CYCLES)
        fn()
        torch.cuda._sleep(SPIN_CYCLES)
        torch.cuda.synchronize()
    times = [(e.key, getattr(e, "self_device_time_total", 0) / 1e3, e.count)
             for e in prof.key_averages()
             if str(getattr(e, "device_type", "")).endswith("CUDA")
             and "spin_kernel" not in e.key]
    return times if sum(t for _, t, _ in times) > 0 else []


def device_ms(fn, reps, csrc=True):
    """Mean device ms per call of ``fn``: the summed device time of the
    kernels that ``reps`` calls launch (torch.profiler), of
    csrc/raytrace.cu's kernels only (namespace rt) with ``csrc``, over
    ``reps``. One call is profiled first for its count of such launches;
    None unless the window of ``reps`` calls records exactly ``reps``
    times as many (a window that lost launches would read low). Beside
    ``cuda_ms``, which also holds the time the card waits for the host to
    issue the next call."""
    def ours(times):
        return [(t, c) for k, t, c in times if "rt::" in k or not csrc]
    per_call = sum(c for _, c in ours(kernel_times(fn)))
    times = ours(kernel_times(lambda: [fn() for _ in range(reps)]))
    if per_call == 0 or sum(c for _, c in times) != reps * per_call:
        return None
    return sum(t for t, _ in times) / reps


def device_busy_ms(fn):
    """The summed device time of the kernels of one call of ``fn`` (the
    frame's launches run on one stream, so they do not overlap), and of
    those of csrc/raytrace.cu (namespace rt); None when the profiler
    records no device time."""
    times = kernel_times(fn)
    if not times:
        return None, None
    return (sum(t for _, t, _ in times),
            sum(t for k, t, _ in times if "rt::" in k))


def top_device_ops(fn, k):
    """The ``k`` kernels of one call of ``fn`` with the most device time,
    as (name, ms); None when the profiler records no device time."""
    times = sorted(kernel_times(fn), key=lambda x: -x[1])
    return [(name[:60], t) for name, t, _ in times[:k]] or None


def host_ms(fn, reps):
    """Mean host ms per call of ``fn`` (host clock, no synchronisation in
    the loop): what issuing one call costs the host."""
    import torch
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t) * 1e3 / reps
    torch.cuda.synchronize()
    return ms


def fmt(ms, digits=3):
    return "not measured" if ms is None else f"{ms:.{digits}f} ms"


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


def frame_warps(w_img, h_img):
    """Warps of wholeframe_kernel's raygen grid: 4 a TILE_W x TILE_H tile
    of 8 x 16 pixels."""
    return 4 * -(-w_img // 8) * -(-h_img // 16)


def warp_steps(st, warps, lane_rows=None):
    """Node and row steps a warp and the SIMD efficiency (lane row tests
    over 32 x the row steps; by default the lanes' triangle tests) from a
    lockstep kernel's 5 counts."""
    lanes, (w_node, w_row) = st.tolist()[:3], st.tolist()[3:]
    lane_rows = lanes[2] if lane_rows is None else lane_rows
    return dict(node_steps_per_warp=w_node / warps,
                row_steps_per_warp=w_row / warps,
                simd_efficiency=lane_rows / max(32 * w_row, 1))


def fmt_steps(steps):
    return (f"node / row steps a warp {steps['node_steps_per_warp']:.2f} / "
            f"{steps['row_steps_per_warp']:.2f}, SIMD efficiency "
            f"{steps['simd_efficiency']:.3f}")


def table_bytes(split):
    return sum(t.numel() * t.element_size() for t in split.device_args())


def bound_of(in_bytes, out_bytes, ops):
    """Least time: the larger of the bytes (each input read once, each
    output written once) over the memory rate and the f32 operations over
    the f32 peak. Returns (ms, which of the two bounds it)."""
    by_bytes = (in_bytes + out_bytes) / PEAK_BYTES
    by_ops = ops / PEAK_F32
    return (1e3 * max(by_bytes, by_ops),
            "bytes" if by_bytes > by_ops else "operations")


def bound_ms(stats, split, out_bytes, in_bytes, extra_ops=0):
    """``bound_of`` for this run's walks, from their counted tests, plus
    ``extra_ops`` outside the walks. Returns (ms, operations, which of
    the two bounds it)."""
    pre, node, tri = stats.tolist()
    n_pw = split.n_other - split.n_sph
    ops_pre = ((split.n_sph * OPS_SPHERE + n_pw * OPS_PLANEWALL)
               / max(split.n_other, 1))
    ops = pre * ops_pre + node * OPS_NODE + tri * OPS_TRI + extra_ops
    ms, by = bound_of(in_bytes, out_bytes, ops)
    return ms, ops, by


def ptxas_summary(build_log):
    """(kernel, registers, spills) per compiled entry from nvcc -Xptxas -v."""
    out, name, spill = [], None, ""
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            k = re.search(r"_ZN2rt\d+(\w+?)(I((?:L[ib]\d+E)+)E|E)",
                          m.group(1))
            name = m.group(1) if not k else k.group(1) + (
                "<" + ",".join(re.findall(r"L[ib](\d+)E", k.group(3)))
                + ">" if k.group(3) else "")
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
