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
gradients through the plain closest hit; and 5 steps of
diff.fit_scene_params through diff.make_kernel_renderer. It times each
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
closest_attrs_kernel), the frames by CUDA events, and prints one
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
FIT_STEPS, FIT_LR = 5, 4.0


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
                                            split_scene, wavefront, whitted)
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
             "brute_kernel", "closest_attrs_kernel")
    err = {k: 0.0 for k in names}
    held = {k: [] for k in names}
    counters = dict(zip(names, (wf.wholeframe, closest_hit, fused, resolve,
                                packet.packet_hit, packet.occlusion,
                                brute.brute_hit, closest_hit_attrs)))

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

    reset()
    val, g_center, g_color = loss_and_grads()
    torch.cuda.synchronize()
    got = read()
    check(got == want, f"the grad leg launched {got}, not {want}")
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
        fit_launches.append(read()["closest_hit_kernel"])
        fit_hist += hist
    log(f"phase 5g: {FIT_STEPS} SGD steps (lr {FIT_LR:g}) of scene 1's "
        f"sphere 0 centre and colour at {FRAME_W}x{FRAME_H}x{BOUNCES}: loss "
        f"{fit_hist}; ms per step {[round(x, 3) for x in fit_ms]}; "
        f"closest_hit_kernel launches per step {fit_launches}")
    check(all(map(math.isfinite, fit_hist)) and fit_hist[-1] < fit_hist[0],
          "the fit's loss did not fall")
    check(fit_launches == [2 * BOUNCES] * FIT_STEPS,
          "a fit step did not launch closest_hit_kernel once a query")
    check(all(bool(torch.isfinite(v).all()) for v in params.values()),
          "the fitted parameters are not finite")
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
                 closest_hit_launches_per_step=fit_launches),
        held_by=held["closest_attrs_kernel"]))
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
