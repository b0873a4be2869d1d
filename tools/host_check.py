#!/usr/bin/env python3
"""Hold the CUDA device code of the packet-BVH (per thread and per warp),
brute-force and split closest-hit walks against their plain PyTorch
versions on the CPU, and count the packet walks' tests and steps.

The per-ray device code in raytracer_tpu_torch/csrc/raytrace.cuh is plain
C++ apart from four CUDA names, so g++ compiles it as host code once those
are defined. This script builds a small shared library of host loops over
``closest_walk`` (the walk of closest_hit_kernel, fused_kernel and
wholeframe_kernel; with the material pointer, of closest_attrs_kernel),
``warp_walk`` (the body of packet_kernel: 32 lanes a call, votes as
loops, the leaf rows staged as cp.async would stage them),
``packet_walk`` (per thread: the body of occlusion_kernel, and the walk
whose per-lane counts the warp walk must equal) and ``brute_ray`` (the
body of brute_kernel), runs it on seeded rays
of scenes 1-3 and of a scene with every shape type (random and camera
rays, a tenth parked, some NaN, some of zero direction) for every
template variant, and compares t, ids, rows
and occlusion with ``closest_hit_plain``, ``closest_hit_attrs_plain``,
``packet_plain``,
``occlusion_plain`` and ``brute_plain`` bit for bit. It then prints the
packet walk's node probes and row tests per primary ray of a 200x150
frame (and per light ray of its hits), t-culling on and off, and the warp
walk's steps and SIMD efficiency on those rays in image order.

    python3 tools/host_check.py

Needs g++ and the CPU build of PyTorch; no card, no nvcc. Exits non-zero
on any difference.
"""

import ctypes
import pathlib
import subprocess
import sys
import tempfile

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from raytracer_tpu_torch.accel import build_bvh, linearize  # noqa: E402
from raytracer_tpu_torch.accel.linearize import shape_leaf_boxes  # noqa
from raytracer_tpu_torch.core.camera import camera_rays, from_euler  # noqa
from chip_smoke import typed_scene  # noqa: E402
from raytracer_tpu_torch.render import brute, packet, split_scene  # noqa
from raytracer_tpu_torch.render.split import (  # noqa: E402
    closest_hit_attrs_plain, closest_hit_plain)
from raytracer_tpu_torch.scenes import generate_scene  # noqa: E402

SHIM = r"""
#include <math.h>
#include <string.h>
#include <vector>
#define __device__
#define __forceinline__ inline
template <class T> T __ldg(const T* p) { return *p; }
#include "raytrace.cuh"

// warp_walk's lane policy on the host: one thread runs the 32 lanes of a
// warp, a vote is a loop over them. The staging copies keep cp.async's
// group semantics: a copy poisons its destination when it is issued (a
// row of type -1, which no test accepts and which counts as a non-triangle
// test) and lands only when a wait covers its group, so reading a chunk
// before its wait, or refilling a buffer that is still being read, shows
// as a difference in t, the row or the counts.
struct HostWarp {
  static constexpr int N = 32;
  struct Copy { float* dst; const float* src; int n16; };
  static std::vector<std::vector<Copy>>& groups() {
    static std::vector<std::vector<Copy>> g(1);
    return g;
  }
  static bool any(const bool* v) {
    for (int l = 0; l < N; ++l)
      if (v[l]) return true;
    return false;
  }
  static void sync() {}
  static void stage(float* dst, const float* src, int n16) {
    for (int q = 0; q < 4 * n16; ++q) dst[q] = -1.0f;
    groups().back().push_back({dst, src, n16});
  }
  static void commit() { groups().emplace_back(); }
  static void land(size_t keep) {   // all committed groups but the last keep
    auto& g = groups();
    size_t done = g.size() - 1 > keep ? g.size() - 1 - keep : 0;
    for (size_t k = 0; k < done; ++k)
      for (const Copy& c : g[k]) memcpy(c.dst, c.src, 16 * (size_t)c.n16);
    g.erase(g.begin(), g.begin() + done);
  }
  static void wait_all() { land(0); }
  static void wait_but_one() { land(1); }
};

template <bool MT, bool CULL>
static void warp_all(const rt::Tree& s, const float* o, const float* d, int n,
                     float* t_out, int* row_out, unsigned long long* stats) {
  alignas(16) static float buf[2 * rt::CHUNK_FLOATS];
  for (int w = 0; w < n; w += 32) {
    rt::Lane ln[32];
    for (int l = 0; l < 32; ++l) {
      int i = w + l;
      rt::Ray r = rt::make_ray(0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f);
      if (i < n)
        r = rt::make_ray(o[3 * i], o[3 * i + 1], o[3 * i + 2], d[3 * i],
                         d[3 * i + 1], d[3 * i + 2]);
      rt::lane_init(ln[l], s, i < n, r);
    }
    rt::WarpCounts wc = {0u, 0u};
    rt::warp_walk<HostWarp, MT, CULL>(s, ln, buf, wc);
    for (int l = 0; l < 32 && w + l < n; ++l) {
      t_out[w + l] = ln[l].t;
      row_out[w + l] = ln[l].row;
      stats[0] += ln[l].c.pre; stats[1] += ln[l].c.node;
      stats[2] += ln[l].c.tri;
    }
    stats[3] += wc.node; stats[4] += wc.row;
  }
}

template <bool MT, bool CULL>
static void packet_all(const rt::Tree& s, const float* o, const float* d,
                       const float* max_t, int n, float* t_out, int* row_out,
                       unsigned char* occ, unsigned long long* stats) {
  for (int i = 0; i < n; ++i) {
    rt::Ray r = rt::make_ray(o[3 * i], o[3 * i + 1], o[3 * i + 2], d[3 * i],
                             d[3 * i + 1], d[3 * i + 2]);
    rt::Counts c = {0u, 0u, 0u};
    float t;
    int row;
    if (max_t) {
      occ[i] = rt::packet_walk<MT, CULL, true>(s, r, max_t[i], c, t, row);
    } else {
      rt::packet_walk<MT, CULL, false>(s, r, rt::INF, c, t, row);
      t_out[i] = t;
      row_out[i] = row;
    }
    stats[0] += c.pre; stats[1] += c.node; stats[2] += c.tri;
  }
}

template <bool MT, bool GATE>
static void brute_all(const float* rows, const int* cnt, const float* o,
                      const float* d, int n, float* t_out, int* row_out) {
  for (int i = 0; i < n; ++i) {
    rt::Ray r = rt::make_ray(o[3 * i], o[3 * i + 1], o[3 * i + 2], d[3 * i],
                             d[3 * i + 1], d[3 * i + 2]);
    rt::brute_ray<MT, GATE>(rows, cnt, r, t_out[i], row_out[i]);
  }
}

template <int TRI>
static void closest_all(const rt::Tables& s, const float* o, const float* d,
                        int n, float* t_out, float* id_out) {
  for (int i = 0; i < n; ++i) {
    rt::Ray r = rt::make_ray(o[3 * i], o[3 * i + 1], o[3 * i + 2], d[3 * i],
                             d[3 * i + 1], d[3 * i + 2]);
    rt::Counts c = {0u, 0u, 0u};
    rt::Hit h = rt::closest_walk<TRI, false>(s, rt::G_GID, rt::T_GID, r,
                                             rt::INF, c);
    t_out[i] = h.t;
    id_out[i] = h.id;
  }
}

template <int TRI>
static void attrs_all(const rt::Tables& s, const float* o, const float* d,
                      int n, float* t_out, float* id_out, float* attrs) {
  for (int i = 0; i < n; ++i) {
    rt::Ray r = rt::make_ray(o[3 * i], o[3 * i + 1], o[3 * i + 2], d[3 * i],
                             d[3 * i + 1], d[3 * i + 2]);
    rt::Counts c = {0u, 0u, 0u};
    rt::Hit h = rt::closest_walk<TRI, true, true>(s, rt::G_GID, rt::T_GID, r,
                                                  rt::INF, c);
    t_out[i] = h.t;
    id_out[i] = h.id;
    const float a[3] = {h.nx, h.ny, h.nz};
    for (int k = 0; k < 3; ++k) attrs[k * n + i] = a[k];
    for (int k = 0; k < rt::N_MAT; ++k)
      attrs[(3 + k) * n + i] = h.mat ? h.mat[k] : 0.0f;
  }
}

extern "C" {
void h_closest_attrs(const int* ls, const int* lc, const int* sk,
                     const float* nodes, const float* pre, const float* tri,
                     int m, int n_other, int n_sph, const float* o,
                     const float* d, int n, float* t_out, float* id_out,
                     float* attrs, int tri_mode) {
  rt::Tables s = {ls, lc, sk, nodes, pre, tri, m, n_other, n_sph};
  if (tri_mode == rt::TRI_RAW) attrs_all<rt::TRI_RAW>(s, o, d, n, t_out, id_out, attrs);
  if (tri_mode == rt::TRI_GRAM) attrs_all<rt::TRI_GRAM>(s, o, d, n, t_out, id_out, attrs);
  if (tri_mode == rt::TRI_MT) attrs_all<rt::TRI_MT>(s, o, d, n, t_out, id_out, attrs);
}
void h_closest(const int* ls, const int* lc, const int* sk, const float* nodes,
               const float* pre, const float* tri, int m, int n_other,
               int n_sph, const float* o, const float* d, int n, float* t_out,
               float* id_out, int tri_mode) {
  rt::Tables s = {ls, lc, sk, nodes, pre, tri, m, n_other, n_sph};
  if (tri_mode == rt::TRI_RAW) closest_all<rt::TRI_RAW>(s, o, d, n, t_out, id_out);
  if (tri_mode == rt::TRI_GRAM) closest_all<rt::TRI_GRAM>(s, o, d, n, t_out, id_out);
  if (tri_mode == rt::TRI_MT) closest_all<rt::TRI_MT>(s, o, d, n, t_out, id_out);
}
void h_packet(const int* ls, const int* lc, const int* sk, const float* nodes,
              const float* rows, int m, const float* o, const float* d,
              const float* max_t, int n, float* t_out, int* row_out,
              unsigned char* occ, int mt, int cull, unsigned long long* st) {
  rt::Tree s = {ls, lc, sk, nodes, rows, m};
  if (mt && cull) packet_all<true, true>(s, o, d, max_t, n, t_out, row_out, occ, st);
  if (mt && !cull) packet_all<true, false>(s, o, d, max_t, n, t_out, row_out, occ, st);
  if (!mt && cull) packet_all<false, true>(s, o, d, max_t, n, t_out, row_out, occ, st);
  if (!mt && !cull) packet_all<false, false>(s, o, d, max_t, n, t_out, row_out, occ, st);
}
void h_warp(const int* ls, const int* lc, const int* sk, const float* nodes,
            const float* rows, int m, const float* o, const float* d, int n,
            float* t_out, int* row_out, int mt, int cull,
            unsigned long long* st) {
  rt::Tree s = {ls, lc, sk, nodes, rows, m};
  if (mt && cull) warp_all<true, true>(s, o, d, n, t_out, row_out, st);
  if (mt && !cull) warp_all<true, false>(s, o, d, n, t_out, row_out, st);
  if (!mt && cull) warp_all<false, true>(s, o, d, n, t_out, row_out, st);
  if (!mt && !cull) warp_all<false, false>(s, o, d, n, t_out, row_out, st);
}
void h_brute(const float* rows, const int* cnt, const float* o, const float* d,
             int n, float* t_out, int* row_out, int mt, int gate) {
  if (mt && gate) brute_all<true, true>(rows, cnt, o, d, n, t_out, row_out);
  if (mt && !gate) brute_all<true, false>(rows, cnt, o, d, n, t_out, row_out);
  if (!mt && gate) brute_all<false, true>(rows, cnt, o, d, n, t_out, row_out);
  if (!mt && !gate) brute_all<false, false>(rows, cnt, o, d, n, t_out, row_out);
}
}
"""


def build(tmp: pathlib.Path) -> ctypes.CDLL:
    src, lib = tmp / "host_check.cpp", tmp / "host_check.so"
    src.write_text(SHIM)
    subprocess.run(["g++", "-O2", "-std=c++17", "-ffp-contract=off",
                    "-shared", "-fPIC",
                    f"-I{ROOT / 'raytracer_tpu_torch' / 'csrc'}",
                    "-o", str(lib), str(src)], check=True)
    return ctypes.CDLL(str(lib))


def ptr(x):
    return None if x is None else ctypes.c_void_p(x.data_ptr())


def host_packet(lib, tree, o, d, use_mt, t_cull, max_t=None):
    """(t, row) or the occlusion mask of the host-compiled walk, and its
    (non-triangle, node, triangle) test counts."""
    n = o.shape[0]
    t = torch.empty(n)
    row = torch.empty(n, dtype=torch.int32)
    occ = torch.empty(n, dtype=torch.bool)
    stats = torch.zeros(3, dtype=torch.int64)
    lib.h_packet(ptr(tree.leaf_start), ptr(tree.leaf_count), ptr(tree.skip),
                 ptr(tree.nodes), ptr(tree.rows), tree.m, ptr(o), ptr(d),
                 ptr(max_t), n, ptr(t), ptr(row), ptr(occ), int(use_mt),
                 int(t_cull), ptr(stats))
    return (t, row) if max_t is None else occ, stats.tolist()


def host_warp(lib, tree, o, d, use_mt, t_cull):
    """(t, row) of packet_kernel's warp walk, run on the host 32 lanes at a
    time, and its counts: the lanes' non-triangle, node and triangle tests,
    then the warps' node steps and row steps."""
    n = o.shape[0]
    t = torch.empty(n)
    row = torch.empty(n, dtype=torch.int32)
    stats = torch.zeros(5, dtype=torch.int64)
    lib.h_warp(ptr(tree.leaf_start), ptr(tree.leaf_count), ptr(tree.skip),
               ptr(tree.nodes), ptr(tree.rows), tree.m, ptr(o), ptr(d), n,
               ptr(t), ptr(row), int(use_mt), int(t_cull), ptr(stats))
    return (t, row), stats.tolist()


def simd_efficiency(stats):
    """Lane row tests over 32 x the warps' row steps (counts of
    ``host_warp`` or packet_kernel)."""
    return (stats[0] + stats[2]) / max(32 * stats[4], 1)


def seeded_rays(camera, n, gen):
    o = torch.rand(n, 3, generator=gen) * 80 - 40
    d = torch.randn(n, 3, generator=gen)
    d = d / d.norm(dim=1, keepdim=True)
    co, cd = camera_rays(camera, 64, 48)
    pix = torch.randint(0, 64 * 48, (n - n // 2,), generator=gen)
    o[n // 2:], d[n // 2:] = co.reshape(-1, 3)[pix], cd.reshape(-1, 3)[pix]
    parked = torch.randperm(n, generator=gen)[:n // 10]
    o[parked], d[parked] = 2e30, 0.5773502691896258
    o[parked[:8], 1] = float("nan")
    o[parked[8:16]], d[parked[8:16]] = 1e30, 0.0
    return o.contiguous(), d.contiguous()


def main() -> int:
    gen = torch.Generator().manual_seed(7)
    bad = 0
    with tempfile.TemporaryDirectory() as tmp:
        lib = build(pathlib.Path(tmp))
        for which in (1, 2, 3):
            sc = generate_scene(which, device="cpu")
            lin = linearize(build_bvh(sc.flat, sc.bvh_max_depth))
            o, d = seeded_rays(sc.camera, 2048, gen)
            perm, counts = brute.sort_scene_by_type(sc.flat)
            split = split_scene.prepare(sc.flat, lin)
            for tri_mode in (0, 1, 2):   # raw, Gram, MT: closest_walk
                tk, gk = torch.empty(o.shape[0]), torch.empty(o.shape[0])
                lib.h_closest(*(ptr(x) for x in split.device_args()),
                              split.m, split.n_other, split.n_sph, ptr(o),
                              ptr(d), o.shape[0], ptr(tk), ptr(gk), tri_mode)
                tp, gp = closest_hit_plain(split, o, d, tri_mode)
                diff = [int((tk != tp).sum()),
                        int((gk.to(torch.int32) != gp).sum())]
                bad += sum(diff)
                print(f"scene {which} closest_walk tri mode {tri_mode}: t, "
                      f"gid differ on {diff}")
                ak = torch.empty(11, o.shape[0])
                lib.h_closest_attrs(*(ptr(x) for x in split.device_args()),
                                    split.m, split.n_other, split.n_sph,
                                    ptr(o), ptr(d), o.shape[0], ptr(tk),
                                    ptr(gk), ptr(ak), tri_mode)
                tp, gp, ap = closest_hit_attrs_plain(split, o, d, tri_mode)
                diff = [int((tk != tp).sum()),
                        int((gk.to(torch.int32) != gp).sum()),
                        int((ak != ap).any(0).sum())]
                bad += sum(diff)
                print(f"scene {which} closest_walk with attributes tri mode "
                      f"{tri_mode}: t, gid, attributes differ on {diff}")
            for use_mt in (False, True):
                for t_cull in (False, True):
                    tree = packet.make_tree(lin, sc.flat, t_cull=t_cull)
                    (tk, rk), st = host_packet(lib, tree, o, d, use_mt,
                                               t_cull)
                    tp, rp = packet.packet_plain(tree, o, d, use_mt, t_cull)
                    (tw, rw), sw = host_warp(lib, tree, o, d, use_mt, t_cull)
                    diff = [int((tw != tp).sum()), int((rw != rp).sum()),
                            int(sw[:3] != st)]
                    bad += sum(diff)
                    print(f"scene {which} warp walk mt {int(use_mt)} t_cull "
                          f"{int(t_cull)}: t, row, lane counts differ on "
                          f"{diff}; SIMD efficiency "
                          f"{simd_efficiency(sw):.3f}")
                    limit = torch.where(tp < 1e30, tp * 0.7, 50.0)
                    limit[:8], limit[8:16] = float("inf"), float("nan")
                    ok, _ = host_packet(lib, tree, o, d, use_mt, t_cull,
                                        limit)
                    op = packet.occlusion_plain(tree, o, d, limit, use_mt,
                                                t_cull)
                    diff = [int((tk != tp).sum()), int((rk != rp).sum()),
                            int((ok != op).sum())]
                    bad += sum(diff)
                    print(f"scene {which} packet mt {int(use_mt)} t_cull "
                          f"{int(t_cull)}: t, row, occlusion differ on "
                          f"{diff} of {o.shape[0]} rays")
                for gate in (False, True):
                    rows = brute.pack_rows_ext(
                        sc.flat, perm,
                        shape_leaf_boxes(lin, sc.num_shapes) if gate
                        else None)
                    tk = torch.empty(o.shape[0])
                    rk = torch.empty(o.shape[0], dtype=torch.int32)
                    cnt = torch.tensor(counts, dtype=torch.int32)
                    lib.h_brute(ptr(rows), ptr(cnt), ptr(o), ptr(d),
                                o.shape[0], ptr(tk), ptr(rk), int(use_mt),
                                int(gate))
                    tp, rp = brute.brute_plain(rows, counts, o, d, use_mt,
                                               gate)
                    diff = [int((tk != tp).sum()), int((rk != rp).sum())]
                    bad += sum(diff)
                    print(f"scene {which} brute mt {int(use_mt)} gate "
                          f"{int(gate)}: t, row differ on {diff}")
            # tests per ray of the 200x150 primary rays and their light rays
            po, pd = (x.reshape(-1, 3).contiguous()
                      for x in camera_rays(sc.camera, 200, 150))
            for t_cull in (True, False):
                tree = packet.make_tree(lin, sc.flat, t_cull=t_cull)
                (t, _), st = host_packet(lib, tree, po, pd, False, t_cull)
                _, sw = host_warp(lib, tree, po, pd, False, t_cull)
                hit = t < 1e30
                per = [round(x / po.shape[0], 1) for x in st]
                line = (f"scene {which} t_cull {int(t_cull)} 200x150: "
                        f"{float(hit.float().mean()):.3f} of rays hit; "
                        f"non-triangle, node, triangle tests per ray {per}; "
                        f"warp walk in image order: node and row steps a "
                        f"warp {[round(32 * x / po.shape[0], 1) for x in sw[3:]]}"
                        f", SIMD efficiency {simd_efficiency(sw):.3f}")
                if t_cull and hit.any():
                    p = po[hit] + t[hit, None] * pd[hit]
                    to = sc.light.position - p
                    dist = to.norm(dim=1)
                    occ, st = host_packet(lib, tree, p.contiguous(),
                                          (to / dist[:, None]).contiguous(),
                                          False, True, dist.contiguous())
                    per = [round(x / p.shape[0], 1) for x in st]
                    line += (f"; light rays of the hits {per} "
                             f"({float(occ.float().mean()):.3f} occluded)")
                print(line)
        # brute_ray's plane loop (no reference scene has a plane)
        typed = typed_scene("cpu")
        o, d = seeded_rays(from_euler(fov_deg=60, aspect=4 / 3), 2048, gen)
        perm, counts = brute.sort_scene_by_type(typed)
        rows = brute.pack_rows_ext(typed, perm)
        cnt = torch.tensor(counts, dtype=torch.int32)
        for use_mt in (False, True):
            for gate in (False, True):
                tk = torch.empty(o.shape[0])
                rk = torch.empty(o.shape[0], dtype=torch.int32)
                lib.h_brute(ptr(rows), ptr(cnt), ptr(o), ptr(d), o.shape[0],
                            ptr(tk), ptr(rk), int(use_mt), int(gate))
                tp, rp = brute.brute_plain(rows, counts, o, d, use_mt, gate)
                diff = [int((tk != tp).sum()), int((rk != rp).sum())]
                bad += sum(diff)
                print(f"typed scene {counts} brute mt {int(use_mt)} gate "
                      f"{int(gate)}: t, row differ on {diff}")
    print("host check:", "OK" if bad == 0 else f"{bad} differences")
    return 0 if bad == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
