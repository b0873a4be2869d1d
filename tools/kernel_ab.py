"""A/B timing of resolve_kernel, packet_kernel and occlusion_kernel across
copies of the port.

    python3 tools/kernel_ab.py LABEL=DIR [LABEL=DIR ...] [--order a,b,b,a]

Each DIR holds a copy of ``raytracer_tpu_torch/``: the repo itself (``.``),
another commit unpacked with ``git archive`` into a git-ignored directory,
or a copy with one change. Needs a CUDA card. The kernels of every copy
are built at once (one process each, each into its copy's ``_build/``);
then each label of ``--order`` (default: each label once) is timed in a
process of its own on the 800x600 primary rays of scenes 1 and 2, so that
two versions are compared within one run, e.g. in the order a, b, b, a.

A timed run checks resolve_kernel against ``resolve_plain``,
packet_kernel against ``packet_plain`` (all four variants on 4096 + 17
seeded rays, the primary rays on a sample) and occlusion_kernel against
``occlusion_plain`` (a sample of the light rays of the primary hits, made
as chip_smoke.py makes them), bit for bit, and prints one line
``RESULT <label> <json>``: the device ms (torch.profiler, chip_smoke.py's
``device_ms``; None when a window lost launches) and the call ms (CUDA
events, ``cuda_ms``) of resolve_kernel and of ``index_select`` of the
15-column attribute table, packet_kernel's device and call ms, its warp
steps and SIMD efficiency where the copy counts them, occlusion_kernel's
device and call ms, and the registers of the three kernels. The timers are those
of this checkout's chip_smoke.py, whatever the copy holds. The card's
name and power limit come first.
"""
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESOLVE_CALLS, PACKET_CALLS, REPEATS = 50, 10, 3


def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def time_one(label, root):
    """Time the copy at ``root`` (its kernels already built)."""
    sys.path.insert(0, root)
    import torch
    from raytracer_tpu_torch.accel import build_bvh, linearize
    from raytracer_tpu_torch.config import RenderConfig
    from raytracer_tpu_torch.core import camera as cam_ops
    from raytracer_tpu_torch.render import kernels, packet, split_scene
    from raytracer_tpu_torch.render import whitted
    from raytracer_tpu_torch.render.split import (closest_hit, resolve,
                                                  resolve_plain)
    from raytracer_tpu_torch.scenes import generate_scene
    cs = smoke()
    dev = torch.device("cuda")
    padded = hasattr(whitted, "ATTR_PAD_W")
    _, log, _ = kernels.build()
    kernels.library()
    out = dict(label=label, padded_table=padded, registers={
        name: regs for name, regs, _ in cs.ptxas_summary(log)
        if name.startswith(("resolve", "packet_kernel", "occlusion"))})
    ok = True
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
        try:
            st = torch.zeros(5, dtype=torch.int64, device=dev)
            packet.packet_hit(tree, o, d, False, True, stats=st)
            st = st.tolist()
            r["warp_node_row_steps"] = st[3:]
            r["simd_efficiency"] = (st[0] + st[2]) / (32 * st[4])
        except ValueError:   # a copy whose packet_kernel counts 3
            pass
        out[f"scene {which}"] = r
    out["bit_exact"] = bool(ok)
    print("RESULT", label, json.dumps(out), flush=True)
    return 0 if ok else 1


def main(argv):
    if argv[:1] == ["--one"]:
        return time_one(argv[1], os.path.abspath(argv[2]))
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
                              "--one", label,
                              os.path.abspath(roots[label])]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
