"""A/B timing of the port's kernels across copies of the port:
wholeframe (raygen, emit, consume), resolve, packet, occlusion,
closest_hit (closest and occlusion modes), fused, closest_attrs and
brute, of the frames that run them, and of the grad leg and the fit step
that run closest_hit.

    python3 tools/kernel_ab.py LABEL=DIR [LABEL=DIR ...] [--order a,b,b,a]
        [--rows]

Each DIR holds a copy of ``raytracer_tpu_torch/``: the repo itself (``.``),
another commit unpacked with ``git archive`` into a git-ignored directory,
or a copy with one change. Needs a CUDA card. The kernels of every copy
are built at once (one process each, each into its copy's ``_build/``);
then each label of ``--order`` (default: each label once) is timed in a
process of its own on the 800x600 primary rays of scenes 1 and 2, so that
two versions are compared within one run, e.g. in the order a, b, b, a.

A timed run checks fused_kernel and closest_attrs_kernel against
``fused_plain`` and ``closest_hit_attrs_plain`` (4096 + 17 seeded rays in
each triangle test, every 97th primary ray), wholeframe_kernel against
``wholeframe_plain`` (the
raygen frame, bounce 1 with its emitted state and the continuation on
the re-packed sorted state, on every 97th pixel or ray), resolve_kernel
against ``resolve_plain``,
packet_kernel against ``packet_plain`` (all four variants on 4096 + 17
seeded rays, the primary rays on a sample), occlusion_kernel against
``occlusion_plain`` and closest_hit_kernel in occlusion mode against
``closest_hit_plain`` (a sample of the light rays of the primary hits,
made as chip_smoke.py makes them), closest_hit_kernel against
``closest_hit_plain`` (4096 + 17 seeded rays in each triangle test and
mode, the primary rays on a sample) and brute_kernel against
``brute_plain`` (leaf-box gate on and off on the seeded rays, gate on on a
sample of the primary rays), bit for bit, and prints one line
``RESULT <label> <json>``: the device ms (torch.profiler, chip_smoke.py's
``device_ms``; None when a window lost launches) and the call ms (CUDA
events, ``cuda_ms``) of wholeframe_kernel (raygen on both scenes' 800x600
frames at 3 bounces; on scene 2 also bounce 1 with emit and the
continuation), of resolve_kernel and of ``index_select`` of the
15-column attribute table, of packet_kernel, occlusion_kernel,
closest_hit_kernel in both modes, fused_kernel and closest_attrs_kernel
(with the bound of their counts) and brute_kernel (gate on, as the brute
renderer runs it), their counts where the copy's kernels give them
(packet_kernel's and closest_hit_kernel's warp steps and SIMD efficiency,
brute_kernel's gate and row tests; wholeframe_kernel's tests and, where
it walks in lockstep, its and occlusion_kernel's warp steps), the call
ms and device busy ms of the one-launch, hybrid (``sort_bounces``),
packet + occlusion, per-bounce (``wholeframe.USE_WHOLEFRAME`` off) and
``split.USE_KERNEL_ATTRS`` frames, the brute renderer's frame (call ms),
the grad leg and the fit step on scene 1 (``time_fit``), and the
registers and spills of the kernels. The timers are those of this checkout's
chip_smoke.py, whatever the copy holds. The card's name and power limit
come first.

On each scene at 1920x1080 x 3 bounces (the fit cells' size) it also
times a fit's loss and gradients (``time_row_gather``), and, where the
copy has ``render/row_gather.py``, the same through ``index_select`` in
the same process, the row gather's kernels on that step's own ray ids
and gradients beside ``index_select`` and ``index_add_`` (the yardstick),
and one bounce's gather and backward beside the slices of an
``index_select`` row that the renderers took before. ``--rows`` times
only that part.
"""
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESOLVE_CALLS, PACKET_CALLS, REPEATS = 50, 10, 3
FIT_CALLS, FIT_W, FIT_H = 5, 800, 600
GATHER_W, GATHER_H, GATHER_CALLS = 1920, 1080, 10
KERNELS = ("wholeframe", "resolve", "packet_kernel", "occlusion",
           "closest_hit", "brute_kernel", "fused", "closest_attrs")


def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def time_one(label, root, rows_only=False):
    """Time the copy at ``root`` (its kernels already built)."""
    sys.path.insert(0, root)
    import torch
    from raytracer_tpu_torch.accel import build_bvh, linearize
    from raytracer_tpu_torch.accel.linearize import shape_leaf_boxes
    from raytracer_tpu_torch.config import RenderConfig
    from raytracer_tpu_torch.core import camera as cam_ops
    from raytracer_tpu_torch.render import (brute, kernels, packet,
                                            split_scene, whitted)
    from raytracer_tpu_torch.render import wholeframe as wf
    from raytracer_tpu_torch.render.split import (closest_hit,
                                                  closest_hit_plain, resolve,
                                                  resolve_plain)
    from raytracer_tpu_torch.scenes import generate_scene
    cs = smoke()
    dev = torch.device("cuda")
    padded = hasattr(whitted, "ATTR_PAD_W")
    _, log, _ = kernels.build()
    kernels.library()
    out = dict(label=label, padded_table=padded, registers={
        name: f"{regs}, {spill}" for name, regs, spill in cs.ptxas_summary(log)
        if name.startswith(KERNELS)})
    ok = True
    if rows_only:
        for which in (1, 2):
            r = out[f"scene {which}"] = {}
            ok &= time_row_gather(r, cs, which)
        out["bit_exact"] = bool(ok)
        print("RESULT", label, json.dumps(out), flush=True)
        return 0 if ok else 1
    gen = torch.Generator().manual_seed(5)
    for which in (1, 2):
        sc = generate_scene(which, device=dev)
        lin = linearize(build_bvh(sc.flat, sc.bvh_max_depth))
        split = split_scene.prepare(sc.flat, lin)
        tab15 = whitted._attr_table(sc.flat)
        tab = whitted._attr_table(sc.flat, padded=True) if padded else tab15
        o, d = cam_ops.camera_rays(sc.camera, 800, 600)
        o, d = o.reshape(-1, 3).contiguous(), d.reshape(-1, 3).contiguous()
        t_hit, gid = closest_hit(split, o, d, RenderConfig().tri_mode)
        p = (o + t_hit[:, None] * d).contiguous()
        g = gid.to(torch.float32)
        for n in (g.numel(), cs.N_RAYS + 17):
            ok &= torch.equal(resolve(tab, g[:n].contiguous(),
                                      p[:n].contiguous()),
                              resolve_plain(tab, g[:n], p[:n]))
        idx = g.clamp_min(0).long()
        r = dict(
            resolve_device_ms=[cs.device_ms(lambda: resolve(tab, g, p),
                                            RESOLVE_CALLS)
                               for _ in range(REPEATS)],
            resolve_call_ms=[cs.cuda_ms(lambda: resolve(tab, g, p),
                                        RESOLVE_CALLS)
                             for _ in range(REPEATS)],
            index_select_device_ms=[
                cs.device_ms(lambda: tab15.index_select(0, idx),
                             RESOLVE_CALLS, csrc=False)
                for _ in range(REPEATS)],
            index_select_call_ms=[
                cs.cuda_ms(lambda: tab15.index_select(0, idx), RESOLVE_CALLS)
                for _ in range(REPEATS)])
        oq, dq = cs.query_rays(cam_ops, sc.camera, gen, dev)
        oq = torch.cat([oq, oq[:17]]).contiguous()
        dq = torch.cat([dq, dq[:17]]).contiguous()
        for use_mt in (False, True):
            for t_cull in (False, True):
                tree = packet.make_tree(lin, sc.flat, t_cull=t_cull)
                tk, rk = packet.packet_hit(tree, oq, dq, use_mt, t_cull)
                tp, rp = packet.packet_plain(tree, oq, dq, use_mt, t_cull)
                ok &= torch.equal(tk, tp) and torch.equal(rk, rp)
        tree = packet.make_tree(lin, sc.flat, t_cull=True)

        def run():
            return packet.packet_hit(tree, o, d, False, True)
        tk, rk = run()
        sub = torch.arange(0, o.shape[0], 97, device=dev)
        tp, rp = packet.packet_plain(tree, o[sub], d[sub], False, True)
        ok &= torch.equal(tk[sub], tp) and torch.equal(rk[sub], rp)
        r["packet_device_ms"] = [cs.device_ms(run, PACKET_CALLS)
                                 for _ in range(REPEATS)]
        r["packet_call_ms"] = [cs.cuda_ms(run, PACKET_CALLS)
                               for _ in range(REPEATS)]
        # occlusion_kernel on chip_smoke.py's light rays: from just before
        # each primary hit toward the light
        hit = t_hit < 1e30
        q = (o + (t_hit - 1e-3)[:, None] * d)[hit]
        to_light = sc.light.position - q
        dist = to_light.norm(dim=1)
        lo, ld = q.contiguous(), (to_light / dist[:, None]).contiguous()

        def occ():
            return packet.occlusion(tree, lo, ld, dist, False, True)
        sub = torch.arange(0, lo.shape[0], 97, device=dev)
        ok &= torch.equal(occ()[sub], packet.occlusion_plain(
            tree, lo[sub], ld[sub], dist[sub], False, True))
        r["occlusion_device_ms"] = [cs.device_ms(occ, PACKET_CALLS)
                                    for _ in range(REPEATS)]
        r["occlusion_call_ms"] = [cs.cuda_ms(occ, PACKET_CALLS)
                                  for _ in range(REPEATS)]
        r["packet_tests"] = lane_and_warp_counts(
            lambda st: packet.packet_hit(tree, o, d, False, True, stats=st),
            dev, True)
        r["occlusion_tests"] = lane_and_warp_counts(
            lambda st: packet.occlusion(tree, lo, ld, dist, False, True,
                                        stats=st), dev, True)
        ok &= time_split(r, cs, split, (o, d), (lo, ld, dist), oq, dq,
                         closest_hit, closest_hit_plain)
        ok &= time_fused_attrs(r, cs, split, sc.light.position, o, d, oq, dq)
        ok &= time_brute(r, cs, brute, sc, lin, shape_leaf_boxes, o, d, oq,
                         dq, RenderConfig())
        if which == 1:
            ok &= time_fit(r, cs, sc, lin, split)
        ok &= time_frames(r, cs, wf, packet, sc, lin, split, tab15,
                          RenderConfig(), which)
        ok &= time_row_gather(r, cs, which)
        out[f"scene {which}"] = r
    out["bit_exact"] = bool(ok)
    print("RESULT", label, json.dumps(out), flush=True)
    return 0 if ok else 1


def lane_and_warp_counts(run, dev, rows_of_all_types=False):
    """The 5 counts of a lockstep kernel (its lanes' tests, then its warps'
    node and row steps) with the SIMD efficiency: lane row tests (all
    types, or triangles) over 32 x the row steps; or, for a copy whose
    kernel counts 3 (one thread a ray), those 3."""
    import torch
    try:
        st = torch.zeros(5, dtype=torch.int64, device=dev)
        run(st)
    except ValueError:
        st = torch.zeros(3, dtype=torch.int64, device=dev)
        run(st)
        return dict(tests=st.tolist())
    st = st.tolist()
    rows = st[0] + st[2] if rows_of_all_types else st[2]
    return dict(tests=st[:3], warp_node_row_steps=st[3:],
                simd_efficiency=rows / max(32 * st[4], 1))


def time_frames(r, cs, wf, packet, sc, lin, split, tab, cfg, which):
    """wholeframe_kernel at 800x600 x 3 bounces: raygen (both scenes) and,
    on scene 2, bounce 1 with emit and the continuation on the re-packed
    sorted state (the hybrid's launches), each bit-exact against
    wholeframe_plain on every 97th pixel or ray; device and call ms, tests
    and warp steps. Then the call ms and device busy ms of the one-launch,
    hybrid, packet + occlusion, per-bounce and USE_KERNEL_ATTRS frames."""
    import torch
    from raytracer_tpu_torch.render import split as split_mod
    from raytracer_tpu_torch.render.split import render
    par = wf.make_params(sc.camera, sc.light)
    dev = par.device
    n = cfg.width * cfg.height
    sub = torch.arange(0, n, 97, device=dev)
    frame = wf.wholeframe(split, tab, par, cfg)
    ok = torch.equal(frame.reshape(-1, 3)[sub], wf.wholeframe_plain(
        split, tab, par, cfg, pixels=sub))
    runs = {"wholeframe_raygen": dict(fn=lambda st=None: wf.wholeframe(
        split, tab, par, cfg, stats=st))}
    if which == 2:
        acc1, state = wf.wholeframe(split, tab, par, cfg, bounces=1,
                                    emit_state=True)
        pc, ps = wf.wholeframe_plain(split, tab, par, cfg, pixels=sub,
                                     bounces=1, emit_state=True)
        ok &= torch.equal(acc1.reshape(-1, 3)[sub], pc)
        ok &= torch.equal(state[:, sub], ps)
        rays, perm = wf._repack(state, 6)
        ret = perm.to(torch.int32)
        rel = wf.wholeframe(split, tab, par, cfg, bounces=cfg.max_bounces - 1,
                            rays=rays, ret=ret)
        ok &= torch.equal(rel[sub], wf.wholeframe_plain(
            split, tab, par, cfg, bounces=cfg.max_bounces - 1,
            rays=rays[:, sub].contiguous(), ret=ret[sub].contiguous()))
        runs["wholeframe_emit"] = dict(fn=lambda st=None: wf.wholeframe(
            split, tab, par, cfg, bounces=1, emit_state=True, stats=st))
        runs["wholeframe_consume"] = dict(fn=lambda st=None: wf.wholeframe(
            split, tab, par, cfg, bounces=cfg.max_bounces - 1, rays=rays,
            ret=ret, stats=st))
        r["wholeframe_consume_live_rays"] = int((state[0] < 1e30).sum())
    for name, v in runs.items():
        r[f"{name}_device_ms"] = [cs.device_ms(v["fn"], PACKET_CALLS)
                                  for _ in range(REPEATS)]
        r[f"{name}_call_ms"] = [cs.cuda_ms(v["fn"], PACKET_CALLS)
                                for _ in range(REPEATS)]
        r[f"{name}_tests"] = lane_and_warp_counts(v["fn"], dev)
    hyb = cfg.replace(sort_bounces=True)
    frames = {
        "one_launch": lambda: render(sc.flat, lin, sc.camera, sc.light, cfg,
                                     split=split),
        "hybrid": lambda: render(sc.flat, lin, sc.camera, sc.light, hyb,
                                 split=split),
        "packet_occlusion": lambda: packet.render(sc.flat, lin, sc.camera,
                                                  sc.light, cfg)}
    # render() under a switch: the per-bounce route (fused_kernel and
    # resolve_kernel a bounce) and its USE_KERNEL_ATTRS variant
    # (closest_attrs_kernel, closest_hit_kernel for the shadow rays)
    frames["per_bounce"] = frames["kernel_attrs"] = frames["one_launch"]
    packet.USE_OCCLUSION = True
    try:
        for name, fn in frames.items():
            wf.USE_WHOLEFRAME = name != "per_bounce"
            split_mod.USE_KERNEL_ATTRS = name == "kernel_attrs"
            fn()
            r[f"frame_{name}_call_ms"] = [cs.cuda_ms(fn, PACKET_CALLS)
                                          for _ in range(REPEATS)]
            r[f"frame_{name}_device_busy_ms"] = cs.device_busy_ms(fn)[0]
    finally:
        packet.USE_OCCLUSION = False
        wf.USE_WHOLEFRAME = True
        split_mod.USE_KERNEL_ATTRS = False
    return bool(ok)


def time_split(r, cs, split, primary, light, oq, dq, closest_hit,
               closest_hit_plain):
    """closest_hit_kernel: bit-exact on the seeded rays (3 triangle tests x
    closest and occlusion) and on samples; the device and call ms of the
    closest mode on the primary rays and of the occlusion mode on the
    light rays, with the warp steps where the copy counts them."""
    import torch
    ok = True
    for mode in (0, 1, 2):
        tk, gk = closest_hit(split, oq, dq, mode)
        tp, gp = closest_hit_plain(split, oq, dq, mode)
        ok &= torch.equal(tk, tp) and torch.equal(gk, gp)
        lim = torch.where(tp < 1e30, tp * 0.7, 50.0)
        ok &= all(torch.equal(a, b) for a, b in zip(
            closest_hit(split, oq, dq, mode, max_t=lim),
            closest_hit_plain(split, oq, dq, mode, max_t=lim)))
    for name, (o, d, lim) in (("closest_hit", (*primary, None)),
                              ("closest_hit_occlusion", light)):
        def run(st=None):
            return closest_hit(split, o, d, 1, max_t=lim, stats=st)
        sub = torch.arange(0, o.shape[0], 97, device=o.device)
        got = run()
        want = closest_hit_plain(split, o[sub], d[sub], 1,
                                 None if lim is None else lim[sub])
        ok &= all(torch.equal(a[sub], b) for a, b in zip(got, want))
        r[f"{name}_device_ms"] = [cs.device_ms(run, PACKET_CALLS)
                                  for _ in range(REPEATS)]
        r[f"{name}_call_ms"] = [cs.cuda_ms(run, PACKET_CALLS)
                                for _ in range(REPEATS)]
        r[f"{name}_tests"] = lane_and_warp_counts(run, o.device)
    return ok


def time_fused_attrs(r, cs, split, light, o, d, oq, dq):
    """fused_kernel and closest_attrs_kernel: bit-exact on the seeded rays
    (3 triangle tests) and on every 97th primary ray; the device and call
    ms on the primary rays (Gram), their counts where the copy gives them
    (the lanes' tests, and the warps' steps where the kernel walks in
    lockstep), and the bound of those counts (chip_smoke.py's bound_ms:
    fused_kernel's shadow leg counted as the copy walks it)."""
    import torch
    from raytracer_tpu_torch.config import RenderConfig
    from raytracer_tpu_torch.render.split import (closest_hit_attrs,
                                                  closest_hit_attrs_plain,
                                                  fused, fused_plain)
    eps = RenderConfig().shadow_eps
    ok = True
    for mode in (0, 1, 2):
        ok &= all(torch.equal(a, b) for a, b in zip(
            fused(split, oq, dq, light, mode, eps),
            fused_plain(split, oq, dq, light, mode, eps)))
        ok &= all(torch.equal(a, b) for a, b in zip(
            closest_hit_attrs(split, oq, dq, mode),
            closest_hit_attrs_plain(split, oq, dq, mode)))
    n = o.shape[0]
    sub = torch.arange(0, n, 97, device=o.device)
    tables = cs.table_bytes(split)
    runs = {
        "fused": (lambda st=None: fused(split, o, d, light, 1, eps, stats=st),
                  lambda: fused_plain(split, o[sub], d[sub], light, 1, eps),
                  n * 9, tables + n * 24 + 12, 0),
        "closest_attrs": (
            lambda st=None: closest_hit_attrs(split, o, d, 1, stats=st),
            lambda: closest_hit_attrs_plain(split, o[sub], d[sub], 1),
            n * 52, tables + n * 24, n * cs.OPS_RESOLVE)}
    for name, (run, plain, out_b, in_b, extra) in runs.items():
        got = run()
        ok &= all(torch.equal(a[..., sub], b) for a, b in zip(got, plain()))
        r[f"{name}_device_ms"] = [cs.device_ms(run, PACKET_CALLS)
                                  for _ in range(REPEATS)]
        r[f"{name}_call_ms"] = [cs.cuda_ms(run, PACKET_CALLS)
                                for _ in range(REPEATS)]
        counts = lane_and_warp_counts(run, o.device)
        counts["bound_ms"] = cs.bound_ms(
            torch.tensor(counts["tests"]), split, out_bytes=out_b,
            in_bytes=in_b, extra_ops=extra)[0]
        r[f"{name}_tests"] = counts
    return ok


def time_brute(r, cs, brute, sc, lin, shape_leaf_boxes, o, d, oq, dq, cfg):
    """brute_kernel: bit-exact on the seeded rays (gate on and off, MT on
    and off) and on a sample of the primary rays; the device and call ms
    with the gate on, as the brute renderer runs it, the gate and row tests
    where the copy counts them, and the brute renderer's frame (800x600, 3
    bounces; call ms)."""
    import torch
    flat = sc.flat
    perm, counts = brute.sort_scene_by_type(flat)
    boxes = shape_leaf_boxes(lin, flat.num_shapes)
    with_runs = hasattr(brute, "box_runs")
    ok = True
    for gate in (False, True):
        rows = brute.pack_rows_ext(flat, perm, boxes if gate else None)
        extra = (brute.box_runs(rows, counts, gate),) if with_runs else ()
        for use_mt in (False, True):
            tk, rk = brute.brute_hit(rows, counts, oq, dq, use_mt, gate,
                                     *extra)
            tp, rp = brute.brute_plain(rows, counts, oq, dq, use_mt, gate)
            ok &= torch.equal(tk, tp) and torch.equal(rk, rp)

    def run():
        return brute.brute_hit(rows, counts, o, d, False, True, *extra)
    sub = torch.arange(0, o.shape[0], 97, device=o.device)
    tk, rk = run()
    tp, rp = brute.brute_plain(rows, counts, o[sub], d[sub], False, True)
    ok &= torch.equal(tk[sub], tp) and torch.equal(rk[sub], rp)
    r["brute_device_ms"] = [cs.device_ms(run, PACKET_CALLS)
                            for _ in range(REPEATS)]
    r["brute_call_ms"] = [cs.cuda_ms(run, PACKET_CALLS)
                          for _ in range(REPEATS)]
    if with_runs:
        st = torch.zeros(3, dtype=torch.int64, device=o.device)
        brute.brute_hit(rows, counts, o, d, False, True, *extra, stats=st)
        gates, tests, steps = st.tolist()
        r["brute_runs"] = extra[0].shape[0]
        r["brute_gates_row_tests_per_ray"] = [gates / o.shape[0],
                                              tests / o.shape[0]]
        r["brute_simd_efficiency"] = tests / max(32 * steps, 1)

    def frame():
        return brute.render(flat, lin, sc.camera, sc.light, cfg)
    frame()
    r["brute_frame_ms"] = [cs.cuda_ms(frame, PACKET_CALLS)
                           for _ in range(REPEATS)]
    return ok


def time_fit(r, cs, sc, lin, split):
    """The grad leg and the fit step of scene 1 at 800x600 x 3 bounces, as
    chip_smoke.py phases 5f and 5g run them (``make_kernel_renderer``;
    sphere 0's centre and colour off by 0.3 and x 0.8): the call ms (CUDA
    events) of a forward, of a fwd+bwd and of one step of
    ``fit_scene_params`` (SGD, lr 4), each over FIT_CALLS calls; of one
    fwd+bwd (torch.profiler) the device ms of all its kernels and of its
    closest_hit_kernel launches, and the idle share; the host ms of issuing
    one fwd+bwd. False unless the loss and gradients are finite."""
    import torch
    from raytracer_tpu_torch import diff as rt_diff
    from raytracer_tpu_torch.config import RenderConfig
    cfg = RenderConfig(width=FIT_W, height=FIT_H, max_bounces=3)
    renderer = rt_diff.make_kernel_renderer(lin, split)
    flat = sc.flat
    with torch.no_grad():
        target = renderer(flat, sc.camera, sc.light, cfg)
    init = {"sphere_center": torch.cat([flat.sphere_center[:1] + 0.3,
                                        flat.sphere_center[1:]]),
            "mat_color": torch.cat([flat.mat_color[:1] * 0.8,
                                    flat.mat_color[1:]])}
    leaves = [init["sphere_center"].clone().requires_grad_(True),
              init["mat_color"].clone().requires_grad_(True)]

    def loss():
        s_ = flat.replace(sphere_center=leaves[0], mat_color=leaves[1])
        return rt_diff.image_loss(renderer(s_, sc.camera, sc.light, cfg),
                                  target)

    def fwd():
        with torch.no_grad():
            return loss()

    def fwd_bwd():
        val = loss()
        return (val,) + torch.autograd.grad(val, leaves)

    def step():
        return rt_diff.fit_scene_params(flat, sc.camera, sc.light, cfg,
                                        target, init, steps=1, lr=4.0,
                                        renderer=renderer)

    val, *grads = fwd_bwd()
    step()
    r["fit_fwd_ms"] = [cs.cuda_ms(fwd, FIT_CALLS) for _ in range(REPEATS)]
    r["fit_fwd_bwd_ms"] = [cs.cuda_ms(fwd_bwd, FIT_CALLS)
                           for _ in range(REPEATS)]
    r["fit_step_ms"] = [cs.cuda_ms(step, FIT_CALLS) for _ in range(REPEATS)]
    r["fit_fwd_bwd_host_ms"] = cs.host_ms(fwd_bwd, FIT_CALLS)
    times = cs.kernel_times(fwd_bwd)
    if times:
        busy = sum(t for _, t, _ in times)
        r["fit_fwd_bwd_device_busy_ms"] = busy
        r["fit_fwd_bwd_closest_hit_device_ms"] = sum(
            t for k, t, _ in times if "closest_hit_kernel" in k)
        r["fit_fwd_bwd_idle_share"] = 1 - busy / min(r["fit_fwd_bwd_ms"])
    return bool(torch.isfinite(val)) and all(
        bool(torch.isfinite(g).all()) for g in grads)


def time_row_gather(r, cs, which):
    """A fit's loss and gradients at GATHER_W x GATHER_H x 3 bounces on
    scene ``which`` (16:9 camera; every sphere's centre, sphere 0's moved
    by 0.3, and every shape's colour, shape 0's x 0.8; MSE against the
    unmoved image): call ms (CUDA events), device busy ms, idle share and
    the ten costliest kernels of one call (torch.profiler). Where the copy
    has the row gather (``render/row_gather.py``): the same through
    ``index_select`` (``engages`` off) in this process; then, on the ids
    and gradients of each of the step's ``row_grads`` calls, device and
    call ms of ``gather_rows`` beside ``index_select`` and of
    ``row_grads`` beside ``index_add_`` (the gradients concatenated
    beforehand), its counts (rays summed, row adds; ``stats``) and the
    bit-exactness of the gather; and on the largest call of each table,
    one bounce's gather and backward (``torch.autograd.grad``) beside the
    slices of an ``index_select`` row. False unless the gradients are
    finite and the gathers exact."""
    import torch
    from raytracer_tpu_torch.accel import build_bvh, linearize
    from raytracer_tpu_torch.config import RenderConfig
    from raytracer_tpu_torch.geom import rowwise
    from raytracer_tpu_torch.render import split as split_mod
    from raytracer_tpu_torch.render import split_scene, whitted
    from raytracer_tpu_torch.scenes import generate_scene
    try:
        from raytracer_tpu_torch.render import row_gather
    except ImportError:
        row_gather = None
    dev = torch.device("cuda")
    sc = generate_scene(which, aspect=GATHER_W / GATHER_H, device=dev)
    lin = linearize(build_bvh(sc.flat, sc.bvh_max_depth))
    split = split_scene.prepare(sc.flat, lin, device=dev)
    cfg = RenderConfig(width=GATHER_W, height=GATHER_H, max_bounces=3)
    flat = sc.flat
    with torch.no_grad():
        target = split_mod.render(flat, lin, sc.camera, sc.light, cfg,
                                  split=split, differentiable=True,
                                  device=dev)
    leaves = [torch.cat([flat.sphere_center[:1] + 0.3,
                         flat.sphere_center[1:]]).requires_grad_(True),
              torch.cat([flat.mat_color[:1] * 0.8,
                         flat.mat_color[1:]]).requires_grad_(True)]

    def fwd_bwd():
        s_ = flat.replace(sphere_center=leaves[0], mat_color=leaves[1])
        img = split_mod.render(s_, lin, sc.camera, sc.light, cfg,
                               split=split, differentiable=True, device=dev)
        return torch.autograd.grad(((img - target) ** 2).mean(), leaves)

    def step_times(key):
        grads = fwd_bwd()
        r[f"{key}_ms"] = [cs.cuda_ms(fwd_bwd, FIT_CALLS)
                          for _ in range(REPEATS)]
        times = cs.kernel_times(fwd_bwd)
        if times:
            busy = sum(t for _, t, _ in times)
            r[f"{key}_device_busy_ms"] = busy
            r[f"{key}_idle_share"] = 1 - busy / min(r[f"{key}_ms"])
            r[f"{key}_top_kernels"] = [
                (k[:60], round(t, 4), c) for k, t, c in
                sorted(times, key=lambda x: -x[1])[:10]]
        return all(bool(torch.isfinite(g).all()) for g in grads)

    ok = step_times("gather_fit_fwd_bwd")
    if row_gather is None:
        return ok
    real = row_gather.row_grads
    row_gather.engages, engages = (lambda table: False), row_gather.engages
    try:
        ok &= step_times("gather_fit_fwd_bwd_index_select")
    finally:
        row_gather.engages = engages
    calls = []

    def recording(grads, sid, n_tab, widths, stats=None):
        calls.append((grads, sid, n_tab, widths))
        return real(grads, sid, n_tab, widths, stats)

    # the wrapper counts its launches on the module's row_grads: this one
    recording.launches = 0
    row_gather.row_grads = recording
    try:
        fwd_bwd()
    finally:
        row_gather.row_grads = real
    tables = {row_gather.ATTR_GROUPS: whitted._attr_table(flat).detach(),
              row_gather.PACK_GROUPS: rowwise.pack_rows(flat).detach()}
    rows, largest = [], {}
    for grads, sid, n_tab, widths in calls:
        tab = tables[widths]
        n = sid.shape[0]
        stats = torch.zeros(2, dtype=torch.int64, device=dev)
        real(grads, sid, n_tab, widths, stats)
        cat = torch.cat([tab.new_zeros(n, w) if g is None else g.reshape(n, w)
                         for g, w in zip(grads, widths)], 1)
        idx = sid.long()
        got = torch.cat([g.reshape(n, -1) for g in
                         row_gather.gather_rows(tab, sid, widths)], 1)
        ok &= torch.equal(got, tab.index_select(0, idx))

        def timed(fn, csrc):
            return dict(device_ms=cs.device_ms(fn, GATHER_CALLS, csrc=csrc),
                        call_ms=cs.cuda_ms(fn, GATHER_CALLS))
        rays, adds = stats.tolist()
        rows.append(dict(
            columns=sum(widths), rays_summed=rays, row_adds=adds,
            rays_per_add=rays / max(adds, 1),
            gather_rows=timed(lambda: row_gather.gather_rows(tab, sid,
                                                              widths), True),
            index_select=timed(lambda: tab.index_select(0, idx), False),
            row_grads=timed(lambda: real(grads, sid, n_tab, widths), False),
            index_add=timed(lambda: torch.zeros_like(tab).index_add_(
                0, idx, cat), False)))
        if rays >= largest.get(widths, (-1,))[0]:
            largest[widths] = (rays, grads, sid)
    r["gather_calls"] = rows
    r["gather_rays_per_add"] = (sum(x["rays_summed"] for x in rows)
                                / max(sum(x["row_adds"] for x in rows), 1))
    for widths, (_, grads, sid) in largest.items():
        tab = tables[widths].clone().requires_grad_(True)
        keep = [k for k, g in enumerate(grads) if g is not None]
        gs = [grads[k] for k in keep]

        def sliced():
            row = tab.index_select(0, sid.long())
            cuts, c = [], 0
            for w in widths:
                cuts.append(row[:, c] if w == 1 else row[:, c:c + w])
                c += w
            return torch.autograd.grad([cuts[k] for k in keep], tab, gs)

        def op():
            groups = row_gather.gather(tab, sid, widths)
            return torch.autograd.grad([groups[k] for k in keep], tab, gs)
        r[f"bounce_chain_{sum(widths)}"] = {
            name: dict(device_ms=cs.device_ms(fn, GATHER_CALLS, csrc=False),
                       call_ms=cs.cuda_ms(fn, GATHER_CALLS))
            for name, fn in (("op", op), ("slices_index_select", sliced))}
    return ok


def main(argv):
    if argv[:1] == ["--one"]:
        return time_one(argv[1], os.path.abspath(argv[2]),
                        rows_only=argv[3:] == ["--rows"])
    rows_only = "--rows" in argv
    argv = [a for a in argv if a != "--rows"]
    order = None
    if "--order" in argv:
        i = argv.index("--order")
        order = argv[i + 1].split(",")
        argv = argv[:i] + argv[i + 2:]
    roots = dict(a.split("=", 1) for a in argv)
    order = order or list(roots)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
        .strip(), flush=True)
    builds = {k: subprocess.Popen([
        sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
        "from raytracer_tpu_torch.render import kernels; kernels.build()",
        os.path.abspath(v)]) for k, v in roots.items()}
    if any(p.wait() for p in builds.values()):
        print("a build failed", flush=True)
        return 1
    rc = 0
    for label in order:
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", label, os.path.abspath(roots[label])]
                             + ["--rows"] * rows_only).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
