#!/usr/bin/env python3
"""Hold the CUDA device code of the packet-BVH (per thread and per warp),
brute-force and split closest-hit walks against their plain PyTorch
versions on the CPU, and count their tests and steps.

The per-ray device code in raytracer_tpu_torch/csrc/raytrace.cuh is plain
C++ apart from four CUDA names, so g++ compiles it as host code once those
are defined. This script builds a small shared library of host loops over
``closest_walk`` and ``occluded`` (per thread: the walk of fused_kernel and
wholeframe_kernel, with the material pointer of closest_attrs_kernel, and
the walks whose per-lane counts the split walk must equal),
``split_walk`` (the body of closest_hit_kernel), ``warp_walk`` (the body
of packet_kernel), ``packet_walk`` (per thread: the body of
occlusion_kernel, and the walk whose per-lane counts the warp walk must
equal) and ``brute_walk`` (the body of brute_kernel). The lockstep walks
run 32 lanes a call under a host lane policy: votes are loops, and staged
rows and run tables land as cp.async lands them (brute_walk's block-wide
staging is one warp's here; its run table is staged in the kernel's
chunks, and whole). It runs them on seeded rays of scenes 1-3 and of a scene with
every shape type (random and camera rays, a tenth parked, some NaN, some of
zero direction, a partial warp) for every template variant, and compares
t, ids, rows and occlusion with ``closest_hit_plain``,
``closest_hit_attrs_plain``, ``packet_plain``, ``occlusion_plain`` and
``brute_plain`` bit for bit. It then prints, per primary ray of a 200x150
frame, the packet walk's node probes and row tests (and per light ray of
its hits), t-culling on and off, the lockstep walks' steps and SIMD
efficiency on those rays in image order, and the brute walk's gates and
row tests.
"""

import ctypes
import pathlib
import re
import subprocess
import sys
import tempfile

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from raytracer_tpu_torch.accel import build_bvh, linearize  # noqa: E402
from raytracer_tpu_torch.accel.linearize import shape_leaf_boxes  # noqa
from raytracer_tpu_torch.config import RenderConfig  # noqa: E402
from raytracer_tpu_torch.core.camera import camera_rays, from_euler  # noqa
from chip_smoke import typed_scene  # noqa: E402
from raytracer_tpu_torch.render import brute, packet, split_scene  # noqa
from raytracer_tpu_torch.render.split import (  # noqa: E402
    closest_hit_attrs_plain, closest_hit_plain, fused_plain)
from raytracer_tpu_torch.scenes import generate_scene  # noqa: E402

# The default shadow offset, and the typed scene's light position.
SHADOW_EPS = RenderConfig().shadow_eps
TYPED_LIGHT = torch.tensor([2.0, -3.0, 1.0])
# brute_kernel's chunk of staged runs, as csrc/raytrace.cu sets it.
RUN_CHUNK = int(re.search(
    r"RUN_CHUNK = (\d+)", (ROOT / "raytracer_tpu_torch" / "csrc" /
                           "raytrace.cu").read_text()).group(1))

SHIM = r"""
#include <math.h>
#include <stdint.h>
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

static void put_counts(unsigned* counts, int i, const rt::Counts& c) {
  if (!counts) return;
  counts[3 * i] = c.pre; counts[3 * i + 1] = c.node; counts[3 * i + 2] = c.tri;
}

// packet_kernel's warp walk (max_t null) or occlusion_kernel's, 32 lanes a
// call; counts: each ray's (non-triangle, node, triangle) tests, or null.
template <bool MT, bool CULL, bool OCC>
static void warp_all(const rt::Tree& s, const float* o, const float* d,
                     const float* max_t, int n, float* t_out, int* row_out,
                     unsigned char* occ, unsigned* counts,
                     unsigned long long* stats) {
  alignas(16) static float buf[2 * rt::CHUNK_FLOATS];
  for (int w = 0; w < n; w += 32) {
    rt::Lane ln[32];
    for (int l = 0; l < 32; ++l) {
      int i = w + l;
      rt::Ray r = rt::make_ray(0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f);
      if (i < n)
        r = rt::make_ray(o[3 * i], o[3 * i + 1], o[3 * i + 2], d[3 * i],
                         d[3 * i + 1], d[3 * i + 2]);
      rt::lane_init(ln[l], s, i < n, r, OCC && i < n ? max_t[i] : rt::INF);
    }
    rt::WarpCounts wc = {0u, 0u};
    rt::warp_walk<HostWarp, MT, CULL, OCC>(s, ln, buf, wc);
    for (int l = 0; l < 32 && w + l < n; ++l) {
      if (OCC) {
        occ[w + l] = ln[l].occ;
      } else {
        t_out[w + l] = ln[l].t;
        row_out[w + l] = ln[l].row;
      }
      put_counts(counts, w + l, ln[l].c);
      stats[0] += ln[l].c.pre; stats[1] += ln[l].c.node;
      stats[2] += ln[l].c.tri;
    }
    stats[3] += wc.node; stats[4] += wc.row;
  }
}

template <bool MT, bool CULL>
static void packet_all(const rt::Tree& s, const float* o, const float* d,
                       const float* max_t, int n, float* t_out, int* row_out,
                       unsigned char* occ, unsigned* counts,
                       unsigned long long* stats) {
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
    put_counts(counts, i, c);
    stats[0] += c.pre; stats[1] += c.node; stats[2] += c.tri;
  }
}

// brute_kernel's walk: one 32-lane warp is the block.
template <bool MT, bool GATE>
static void brute_walk_all(const rt::Runs& s, const float* o, const float* d,
                           int n, float* t_out, int* row_out,
                           unsigned long long* stats) {
  std::vector<float> store(2 * (size_t)s.chunk * rt::RUN_W + 4);
  float* buf = store.data();
  while ((uintptr_t)buf % 16) ++buf;
  for (int w = 0; w < n; w += 32) {
    rt::BruteLane ln[32];
    for (int l = 0; l < 32; ++l) {
      int i = w + l;
      rt::Ray r = rt::make_ray(0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f);
      if (i < n)
        r = rt::make_ray(o[3 * i], o[3 * i + 1], o[3 * i + 2], d[3 * i],
                         d[3 * i + 1], d[3 * i + 2]);
      rt::brute_lane_init(ln[l], i < n, r);
    }
    rt::WarpCounts wc = {0u, 0u};
    rt::brute_walk<HostWarp, MT, GATE>(s, ln, buf, wc);
    for (int l = 0; l < 32; ++l) {
      if (w + l < n) {
        t_out[w + l] = ln[l].t;
        row_out[w + l] = ln[l].row;
      }
      stats[0] += ln[l].gates; stats[1] += ln[l].tests;
    }
    stats[2] += wc.row;
  }
}

// closest_walk (limit null) or occluded for each ray, with its counts.
template <int TRI>
static void closest_all(const rt::Tables& s, const float* o, const float* d,
                        const float* limit, int n, float* t_out,
                        float* id_out, unsigned char* occ, unsigned* counts) {
  for (int i = 0; i < n; ++i) {
    rt::Ray r = rt::make_ray(o[3 * i], o[3 * i + 1], o[3 * i + 2], d[3 * i],
                             d[3 * i + 1], d[3 * i + 2]);
    rt::Counts c = {0u, 0u, 0u};
    if (limit) {
      occ[i] = rt::occluded<TRI>(s, r, limit[i], c);
    } else {
      rt::Hit h = rt::closest_walk<TRI, false>(s, rt::G_GID, rt::T_GID, r,
                                               rt::INF, c);
      t_out[i] = h.t;
      id_out[i] = h.id;
    }
    counts[3 * i] = c.pre; counts[3 * i + 1] = c.node;
    counts[3 * i + 2] = c.tri;
  }
}

// closest_hit_kernel's split walk, 32 lanes a call (limit null: closest);
// attrs (closest mode): closest_attrs_kernel's 11 rows of n attributes.
template <int TRI, bool OCC>
static void split_all(const rt::Tables& s, const float* o, const float* d,
                      const float* limit, int n, float* t_out, float* id_out,
                      unsigned char* occ, float* attrs, unsigned* counts,
                      unsigned long long* steps) {
  alignas(16) static float buf[2 * rt::SPLIT_CHUNK_FLOATS];
  for (int w = 0; w < n; w += 32) {
    rt::SplitLane ln[32];
    for (int l = 0; l < 32; ++l) {
      int i = w + l;
      rt::Ray r = rt::make_ray(0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f);
      if (i < n)
        r = rt::make_ray(o[3 * i], o[3 * i + 1], o[3 * i + 2], d[3 * i],
                         d[3 * i + 1], d[3 * i + 2]);
      rt::split_lane_init(ln[l], s, i < n, r,
                          OCC && i < n ? limit[i] : rt::INF);
    }
    rt::WarpCounts wc = {0u, 0u};
    rt::split_walk<HostWarp, TRI, OCC>(s, ln, buf, wc);
    for (int l = 0; l < 32 && w + l < n; ++l) {
      int i = w + l;
      if (OCC) {
        occ[i] = ln[l].occ;
      } else {
        t_out[i] = ln[l].t;
        id_out[i] = rt::split_id(s, ln[l], rt::G_GID, rt::T_GID);
        if (attrs) {
          float v[3 + rt::N_MAT];
          rt::split_attrs(s, ln[l], v);
          for (int k = 0; k < 3 + rt::N_MAT; ++k) attrs[k * n + i] = v[k];
        }
      }
      put_counts(counts, i, ln[l].c);
    }
    steps[0] += wc.node; steps[1] += wc.row;
  }
}

// closest_walk with the material pointer, per thread, with its counts.
template <int TRI>
static void attrs_all(const rt::Tables& s, const float* o, const float* d,
                      int n, float* t_out, float* id_out, float* attrs,
                      unsigned* counts) {
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
    put_counts(counts, i, c);
  }
}

// fused_kernel's lockstep walk (how 0: warp_fused, 32 lanes a call) or,
// per lane, fused_ray with the any-hit (1) or closest-mode (2) shadow leg;
// counts: each ray's (pre, node, triangle) tests of its closest walk, then
// of its shadow leg; steps: the warps' node and row steps.
template <int TRI>
static void fused_all(const rt::Tables& s, const float* o, const float* d,
                      const float* light, int n, float shadow_eps, int how,
                      float* t_out, float* id_out, unsigned char* sh_out,
                      unsigned* counts, unsigned long long* steps) {
  alignas(16) static float buf[2 * rt::SPLIT_CHUNK_FLOATS];
  for (int w = 0; w < n; w += 32) {
    rt::SplitLane ln[32];
    rt::Counts cs[32] = {};
    bool sh[32];
    for (int l = 0; l < 32; ++l) {
      int i = w + l;
      rt::Ray r = rt::make_ray(0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f);
      if (i < n)
        r = rt::make_ray(o[3 * i], o[3 * i + 1], o[3 * i + 2], d[3 * i],
                         d[3 * i + 1], d[3 * i + 2]);
      rt::split_lane_init(ln[l], s, i < n, r, rt::INF);
    }
    if (how == 0) {
      rt::WarpCounts wc = {0u, 0u};
      rt::warp_fused<HostWarp, TRI>(s, ln, light[0], light[1], light[2],
                                    shadow_eps, sh, cs, buf, wc);
      steps[0] += wc.node; steps[1] += wc.row;
    }
    for (int l = 0; l < 32 && w + l < n; ++l) {
      int i = w + l;
      if (how == 0) {
        t_out[i] = ln[l].t;
        id_out[i] = rt::split_id(s, ln[l], rt::G_GID, rt::T_GID);
      } else if (how == 1) {
        rt::fused_ray<TRI, true>(s, ln[l].r, light[0], light[1], light[2],
                                 shadow_eps, ln[l].c, cs[l], t_out[i],
                                 id_out[i], sh[l]);
      } else {
        rt::fused_ray<TRI, false>(s, ln[l].r, light[0], light[1], light[2],
                                  shadow_eps, ln[l].c, cs[l], t_out[i],
                                  id_out[i], sh[l]);
      }
      sh_out[i] = sh[l];
      put_counts(counts, 2 * i, ln[l].c);
      put_counts(counts, 2 * i + 1, cs[l]);
    }
  }
}

// wholeframe_kernel's grid on the host: each warp of each block, its lanes
// from trace_entry as the kernel takes them, then the lockstep trace
// (how 0: warp_trace, 32 lanes a call) or, per lane, trace_ray with the
// any-hit shadow leg (1) or the closest-mode one (2). counts: each
// pixel's or ray's (pre, node, triangle) tests of its closest walks, then
// of its shadow legs; steps: the warps' node and row steps.
template <int TRI>
static void frame_all(const rt::Tables& s, const float* tab,
                      const float* par, const float* rays, int n_rows,
                      const int* ret, int n, float* out, float* state, int W,
                      int H, const rt::Shade& sh, int how, unsigned* counts,
                      unsigned long long* steps) {
  alignas(16) static float buf[2 * rt::SPLIT_CHUNK_FLOATS];
  rt::Params q = rt::load_params(par);
  bool consume = rays != nullptr;
  int gx = consume ? (n + rt::BLOCK - 1) / rt::BLOCK
                   : (W + rt::TILE_W - 1) / rt::TILE_W;
  int gy = consume ? 1 : (H + rt::TILE_H - 1) / rt::TILE_H;
  for (int by = 0; by < gy; ++by)
    for (int bx = 0; bx < gx; ++bx)
      for (int w = 0; w < rt::BLOCK / 32; ++w) {
        rt::TraceLane ln[32];
        rt::Counts cs[32] = {};
        int idx[32];
        for (int l = 0; l < 32; ++l)
          idx[l] = consume
              ? rt::trace_entry<true>(ln[l], q, rays, n_rows, ret, n, W, H,
                                      bx, by, 32 * w + l)
              : rt::trace_entry<false>(ln[l], q, rays, n_rows, ret, n, W, H,
                                       bx, by, 32 * w + l);
        if (how == 0) {
          rt::WarpCounts wc = {0u, 0u};
          rt::warp_trace<HostWarp, TRI>(s, tab, par, sh, ln, cs, buf, wc);
          steps[0] += wc.node; steps[1] += wc.row;
        } else {
          for (int l = 0; l < 32; ++l) {
            rt::TraceLane& a = ln[l];
            if (how == 1)
              rt::trace_ray<TRI, true>(s, tab, par, sh, a.f_bg, a.st, a.c,
                                       cs[l], a.rgb);
            else
              rt::trace_ray<TRI, false>(s, tab, par, sh, a.f_bg, a.st, a.c,
                                        cs[l], a.rgb);
          }
        }
        for (int l = 0; l < 32; ++l) {
          int i = idx[l];
          if (i < 0) continue;
          if (state) rt::trace_store<true>(ln[l], i, n, out, state);
          else rt::trace_store<false>(ln[l], i, n, out, state);
          put_counts(counts, 2 * i, ln[l].c);
          put_counts(counts, 2 * i + 1, cs[l]);
        }
      }
}

extern "C" {
void h_frame(const int* ls, const int* lc, const int* sk, const float* nodes,
             const float* pre, const float* tri, int m, int n_other,
             int n_sph, const float* tab, const float* par, const float* rays,
             int n_rows, const int* ret, int n, float* out, float* state,
             int W, int H, int bounces, float shadow_eps, float reflect_eps,
             int use_fresnel, int enable_shadows, int tri_mode, int how,
             unsigned* counts, unsigned long long* steps) {
  rt::Tables s = {ls, lc, sk, nodes, pre, tri, m, n_other, n_sph};
  rt::Shade sh = {bounces, shadow_eps, reflect_eps, use_fresnel != 0,
                  enable_shadows != 0};
#define H_FRAME(TRI)                                                        \
  frame_all<TRI>(s, tab, par, rays, n_rows, ret, n, out, state, W, H, sh,   \
                 how, counts, steps)
  if (tri_mode == rt::TRI_RAW) H_FRAME(rt::TRI_RAW);
  if (tri_mode == rt::TRI_GRAM) H_FRAME(rt::TRI_GRAM);
  if (tri_mode == rt::TRI_MT) H_FRAME(rt::TRI_MT);
#undef H_FRAME
}
void h_closest_attrs(const int* ls, const int* lc, const int* sk,
                     const float* nodes, const float* pre, const float* tri,
                     int m, int n_other, int n_sph, const float* o,
                     const float* d, int n, float* t_out, float* id_out,
                     float* attrs, unsigned* counts, int tri_mode) {
  rt::Tables s = {ls, lc, sk, nodes, pre, tri, m, n_other, n_sph};
  if (tri_mode == rt::TRI_RAW) attrs_all<rt::TRI_RAW>(s, o, d, n, t_out, id_out, attrs, counts);
  if (tri_mode == rt::TRI_GRAM) attrs_all<rt::TRI_GRAM>(s, o, d, n, t_out, id_out, attrs, counts);
  if (tri_mode == rt::TRI_MT) attrs_all<rt::TRI_MT>(s, o, d, n, t_out, id_out, attrs, counts);
}
void h_fused(const int* ls, const int* lc, const int* sk, const float* nodes,
             const float* pre, const float* tri, int m, int n_other,
             int n_sph, const float* o, const float* d, const float* light,
             int n, float shadow_eps, int how, float* t_out, float* id_out,
             unsigned char* sh_out, unsigned* counts,
             unsigned long long* steps, int tri_mode) {
  rt::Tables s = {ls, lc, sk, nodes, pre, tri, m, n_other, n_sph};
#define H_FUSED(TRI)                                                        \
  fused_all<TRI>(s, o, d, light, n, shadow_eps, how, t_out, id_out, sh_out, \
                 counts, steps)
  if (tri_mode == rt::TRI_RAW) H_FUSED(rt::TRI_RAW);
  if (tri_mode == rt::TRI_GRAM) H_FUSED(rt::TRI_GRAM);
  if (tri_mode == rt::TRI_MT) H_FUSED(rt::TRI_MT);
#undef H_FUSED
}
void h_closest(const int* ls, const int* lc, const int* sk, const float* nodes,
               const float* pre, const float* tri, int m, int n_other,
               int n_sph, const float* o, const float* d, const float* limit,
               int n, float* t_out, float* id_out, unsigned char* occ,
               unsigned* counts, int tri_mode) {
  rt::Tables s = {ls, lc, sk, nodes, pre, tri, m, n_other, n_sph};
  if (tri_mode == rt::TRI_RAW) closest_all<rt::TRI_RAW>(s, o, d, limit, n, t_out, id_out, occ, counts);
  if (tri_mode == rt::TRI_GRAM) closest_all<rt::TRI_GRAM>(s, o, d, limit, n, t_out, id_out, occ, counts);
  if (tri_mode == rt::TRI_MT) closest_all<rt::TRI_MT>(s, o, d, limit, n, t_out, id_out, occ, counts);
}
void h_split(const int* ls, const int* lc, const int* sk, const float* nodes,
             const float* pre, const float* tri, int m, int n_other,
             int n_sph, const float* o, const float* d, const float* limit,
             int n, float* t_out, float* id_out, unsigned char* occ,
             float* attrs, unsigned* counts, unsigned long long* steps,
             int tri_mode) {
  rt::Tables s = {ls, lc, sk, nodes, pre, tri, m, n_other, n_sph};
#define H_SPLIT(TRI)                                                        \
  if (limit) split_all<TRI, true>(s, o, d, limit, n, t_out, id_out, occ,    \
                                  attrs, counts, steps);                    \
  else split_all<TRI, false>(s, o, d, limit, n, t_out, id_out, occ, attrs,  \
                             counts, steps)
  if (tri_mode == rt::TRI_RAW) { H_SPLIT(rt::TRI_RAW); }
  if (tri_mode == rt::TRI_GRAM) { H_SPLIT(rt::TRI_GRAM); }
  if (tri_mode == rt::TRI_MT) { H_SPLIT(rt::TRI_MT); }
#undef H_SPLIT
}
void h_packet(const int* ls, const int* lc, const int* sk, const float* nodes,
              const float* rows, int m, const float* o, const float* d,
              const float* max_t, int n, float* t_out, int* row_out,
              unsigned char* occ, int mt, int cull, unsigned* counts,
              unsigned long long* st) {
  rt::Tree s = {ls, lc, sk, nodes, rows, m};
#define H_PACKET(MT, CULL) \
  packet_all<MT, CULL>(s, o, d, max_t, n, t_out, row_out, occ, counts, st)
  if (mt && cull) H_PACKET(true, true);
  if (mt && !cull) H_PACKET(true, false);
  if (!mt && cull) H_PACKET(false, true);
  if (!mt && !cull) H_PACKET(false, false);
#undef H_PACKET
}
void h_warp(const int* ls, const int* lc, const int* sk, const float* nodes,
            const float* rows, int m, const float* o, const float* d,
            const float* max_t, int n, float* t_out, int* row_out,
            unsigned char* occ, int mt, int cull, unsigned* counts,
            unsigned long long* st) {
  rt::Tree s = {ls, lc, sk, nodes, rows, m};
#define H_WARP(MT, CULL)                                                    \
  if (max_t) warp_all<MT, CULL, true>(s, o, d, max_t, n, t_out, row_out,    \
                                      occ, counts, st);                     \
  else warp_all<MT, CULL, false>(s, o, d, max_t, n, t_out, row_out, occ,    \
                                 counts, st)
  if (mt && cull) { H_WARP(true, true); }
  if (mt && !cull) { H_WARP(true, false); }
  if (!mt && cull) { H_WARP(false, true); }
  if (!mt && !cull) { H_WARP(false, false); }
#undef H_WARP
}
void h_brute(const float* rows, const float* runs, int n_runs, int chunk,
             const int* cnt, const float* o, const float* d, int n,
             float* t_out, int* row_out, int mt, int gate,
             unsigned long long* stats) {
  rt::Runs s = {rows, runs, n_runs, chunk,
                {cnt[0], cnt[0] + cnt[1], cnt[0] + cnt[1] + cnt[2]}};
  if (mt && gate) brute_walk_all<true, true>(s, o, d, n, t_out, row_out, stats);
  if (mt && !gate) brute_walk_all<true, false>(s, o, d, n, t_out, row_out, stats);
  if (!mt && gate) brute_walk_all<false, true>(s, o, d, n, t_out, row_out, stats);
  if (!mt && !gate) brute_walk_all<false, false>(s, o, d, n, t_out, row_out, stats);
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


def _tree_walk(fn, tree, o, d, use_mt, t_cull, max_t, n_stats):
    n = o.shape[0]
    t = torch.empty(n)
    row = torch.empty(n, dtype=torch.int32)
    occ = torch.empty(n, dtype=torch.bool)
    counts = torch.zeros(n, 3, dtype=torch.int32)
    stats = torch.zeros(n_stats, dtype=torch.int64)
    fn(ptr(tree.leaf_start), ptr(tree.leaf_count), ptr(tree.skip),
       ptr(tree.nodes), ptr(tree.rows), tree.m, ptr(o), ptr(d), ptr(max_t),
       n, ptr(t), ptr(row), ptr(occ), int(use_mt), int(t_cull), ptr(counts),
       ptr(stats))
    return (t, row) if max_t is None else occ, counts, stats.tolist()


def host_packet(lib, tree, o, d, use_mt, t_cull, max_t=None, lanes=False):
    """(t, row) or the occlusion mask of the host-compiled per-thread walk
    (packet_walk), and its (non-triangle, node, triangle) test counts;
    with ``lanes`` each ray's counts (n, 3) in their place."""
    out, counts, stats = _tree_walk(lib.h_packet, tree, o, d, use_mt, t_cull,
                                    max_t, 3)
    return out, counts if lanes else stats


def host_warp(lib, tree, o, d, use_mt, t_cull, max_t=None, lanes=False):
    """(t, row) of packet_kernel's warp walk or, where ``max_t`` is given,
    the occlusion mask of occlusion_kernel's, run on the host 32 lanes at a
    time, and its counts: the lanes' non-triangle, node and triangle tests,
    then the warps' node steps and row steps; with ``lanes`` also each
    ray's counts (n, 3)."""
    out, counts, stats = _tree_walk(lib.h_warp, tree, o, d, use_mt, t_cull,
                                    max_t, 5)
    return (out, stats, counts) if lanes else (out, stats)


def host_frame(lib, split, tab, par, cfg, how=0, bounces=None, emit=False,
               rays=None, ret=None):
    """wholeframe_kernel's grid run on the host: the lockstep trace (how
    0) or the per-thread trace_ray with the any-hit (1) or closest-mode (2)
    shadow leg, in raygen mode or, given ``rays`` (6 or 9, R) and ``ret``,
    in consume mode. Returns (colours (n, 3), the state (9, n) with
    ``emit`` else None, each ray's tests (n, 2, 3): (pre, node, triangle)
    of its closest walks, then of its shadow legs, and the warps' node and
    row steps)."""
    n = cfg.width * cfg.height if rays is None else rays.shape[1]
    out = torch.zeros(n, 3)
    state = torch.zeros(9, n) if emit else None
    counts = torch.zeros(n, 2, 3, dtype=torch.int32)
    steps = torch.zeros(2, dtype=torch.int64)
    lib.h_frame(*(ptr(x) for x in split.device_args()), split.m,
                split.n_other, split.n_sph, ptr(tab), ptr(par), ptr(rays),
                0 if rays is None else rays.shape[0], ptr(ret), n, ptr(out),
                ptr(state), cfg.width, cfg.height,
                cfg.max_bounces if bounces is None else bounces,
                ctypes.c_float(cfg.shadow_eps),
                ctypes.c_float(cfg.reflect_eps), int(cfg.use_fresnel),
                int(cfg.enable_shadows), cfg.tri_mode, how, ptr(counts),
                ptr(steps))
    return out, state, counts, steps.tolist()


def host_closest(lib, split, o, d, tri_mode, limit=None, warp=False):
    """The per-thread split walk (closest_walk, or occluded where ``limit``
    is given) or, with ``warp``, closest_hit_kernel's split walk (32 lanes a
    call): (t, id) or the occlusion mask, each ray's (pre-pass, node,
    triangle) counts (n, 3), and with ``warp`` the warps' node and row
    steps."""
    n = o.shape[0]
    t, ids = torch.empty(n), torch.empty(n)
    occ = torch.empty(n, dtype=torch.bool)
    counts = torch.zeros(n, 3, dtype=torch.int32)
    steps = torch.zeros(2, dtype=torch.int64)
    args = [*(ptr(x) for x in split.device_args()), split.m, split.n_other,
            split.n_sph, ptr(o), ptr(d), ptr(limit), n, ptr(t), ptr(ids),
            ptr(occ)]
    if warp:
        lib.h_split(*args, None, ptr(counts), ptr(steps), tri_mode)
    else:
        lib.h_closest(*args, ptr(counts), tri_mode)
    out = occ if limit is not None else (t, ids.to(torch.int32))
    return (out, counts, steps.tolist()) if warp else (out, counts)


def host_attrs(lib, split, o, d, tri_mode, warp=False):
    """(t, gid int32, the 11 attribute rows (11, n)) of
    closest_attrs_kernel's walk (``warp``: the split walk and
    ``split_attrs``, 32 lanes a call) or of the per-thread
    ``closest_walk<TRI, true, true>``, each ray's (pre-pass, node, triangle)
    counts (n, 3) and, with ``warp``, the warps' node and row steps."""
    n = o.shape[0]
    t, ids, attrs = torch.empty(n), torch.empty(n), torch.empty(11, n)
    counts = torch.zeros(n, 3, dtype=torch.int32)
    steps = torch.zeros(2, dtype=torch.int64)
    args = [*(ptr(x) for x in split.device_args()), split.m, split.n_other,
            split.n_sph, ptr(o), ptr(d)]
    if warp:
        lib.h_split(*args, None, n, ptr(t), ptr(ids), None, ptr(attrs),
                    ptr(counts), ptr(steps), tri_mode)
    else:
        lib.h_closest_attrs(*args, n, ptr(t), ptr(ids), ptr(attrs),
                            ptr(counts), tri_mode)
    return (t, ids.to(torch.int32), attrs), counts, steps.tolist()


def host_fused(lib, split, o, d, light, tri_mode, shadow_eps, how=0):
    """(t, gid int32, in_shadow bool) of fused_kernel's lockstep walk
    (``how`` 0: ``warp_fused``, 32 lanes a call) or of the per-thread
    ``fused_ray`` with the any-hit (1) or closest-mode (2) shadow leg; each
    ray's tests (n, 2, 3): (pre, node, triangle) of its closest walk, then
    of its shadow leg; and the warps' node and row steps (how 0)."""
    n = o.shape[0]
    t, ids = torch.empty(n), torch.empty(n)
    sh = torch.empty(n, dtype=torch.bool)
    counts = torch.zeros(n, 2, 3, dtype=torch.int32)
    steps = torch.zeros(2, dtype=torch.int64)
    lib.h_fused(*(ptr(x) for x in split.device_args()), split.m,
                split.n_other, split.n_sph, ptr(o), ptr(d),
                ptr(light.contiguous()), n, ctypes.c_float(shadow_eps), how,
                ptr(t), ptr(ids), ptr(sh), ptr(counts), ptr(steps), tri_mode)
    return (t, ids.to(torch.int32), sh), counts, steps.tolist()


def host_brute(lib, rows, runs, counts, o, d, use_mt, gate, chunk):
    """(t, row) of brute_kernel's walk over the run table ``runs``, staged
    ``chunk`` runs at a time, and its counts: the lanes' gate tests and row
    tests and the warps' row steps."""
    n = o.shape[0]
    t = torch.empty(n)
    row = torch.empty(n, dtype=torch.int32)
    stats = torch.zeros(3, dtype=torch.int64)
    cnt = torch.tensor(counts, dtype=torch.int32)
    lib.h_brute(ptr(rows), ptr(runs), runs.shape[0], chunk, ptr(cnt), ptr(o),
                ptr(d), n, ptr(t), ptr(row), int(use_mt), int(gate),
                ptr(stats))
    return (t, row), stats.tolist()


def occlusion_limits(t):
    """Per-ray limits for the occlusion queries: where the ray hits, before
    its closest hit on even rays and beyond it on odd ones; 50 elsewhere; 8
    infinite and 8 NaN."""
    odd = torch.arange(t.shape[0]) % 2 == 1
    limit = torch.where(t < 1e30, t * torch.where(odd, 1.3, 0.7), 50.0)
    limit[:8], limit[8:16] = float("inf"), float("nan")
    return limit.contiguous()


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


def check_split(lib, split, o, d, label):
    """closest_hit_kernel's split walk against closest_hit_plain and its
    per-lane counts against the per-thread walks', closest and occlusion
    modes, raw, Gram and MT. Returns the count of differences."""
    bad = 0
    for tri_mode in (0, 1, 2):
        (tw, gw), cw, _ = host_closest(lib, split, o, d, tri_mode, warp=True)
        (tk, gk), ck = host_closest(lib, split, o, d, tri_mode)
        tp, gp = closest_hit_plain(split, o, d, tri_mode)
        limit = occlusion_limits(tp)
        ow, cow, _ = host_closest(lib, split, o, d, tri_mode, limit, True)
        ok, cok = host_closest(lib, split, o, d, tri_mode, limit)
        op = closest_hit_plain(split, o, d, tri_mode, max_t=limit)[0] == 0
        diff = [int((tw != tp).sum()), int((gw != gp).sum()),
                int((tk != tp).sum()) + int((gk != gp).sum()),
                int((cw != ck).any(1).sum()), int((ow != op).sum()),
                int((ok != op).sum()), int((cow != cok).any(1).sum())]
        bad += sum(diff)
        print(f"{label} split walk tri mode {tri_mode}: t, gid, per-thread "
              f"t/gid, lane counts, occlusion, per-thread occlusion, "
              f"occlusion lane counts differ on {diff} of {o.shape[0]} rays")
    return bad


def check_fused(lib, split, o, d, light, shadow_eps, label):
    """fused_kernel's lockstep walk (warp_fused) against fused_plain, and
    each lane's closest-walk and shadow-leg tests against the per-thread
    fused_ray<TRI, true>'s, whose outputs, and fused_ray<TRI, false>'s, are
    held against fused_plain too; raw, Gram and MT. Returns the count of
    differences."""
    bad = 0
    for tri_mode in (0, 1, 2):
        plain = fused_plain(split, o, d, light, tri_mode, shadow_eps)
        runs = [host_fused(lib, split, o, d, light, tri_mode, shadow_eps,
                           how) for how in (0, 1, 2)]
        diff = [sum(int((a != b).sum()) for a, b in zip(out, plain))
                for out, _, _ in runs]
        diff.append(int((runs[0][1] != runs[1][1]).any(2).any(1).sum()))
        bad += sum(diff)
        print(f"{label} fused walk tri mode {tri_mode}: t/gid/in_shadow of "
              f"the warp walk, fused_ray any-hit and closest-mode, lane "
              f"counts differ on {diff} of {o.shape[0]} rays "
              f"({int(plain[2].sum())} in shadow)")
    return bad


def check_attrs(lib, split, o, d, label):
    """closest_attrs_kernel's walk (the split walk and split_attrs) against
    closest_hit_attrs_plain, and each lane's counts against the per-thread
    closest_walk<TRI, true, true>'s, whose outputs are held against
    closest_hit_attrs_plain too; raw, Gram and MT. Returns the count of
    differences."""
    bad = 0
    for tri_mode in (0, 1, 2):
        tp, gp, ap = closest_hit_attrs_plain(split, o, d, tri_mode)
        outs, counts = zip(*(host_attrs(lib, split, o, d, tri_mode,
                                        warp)[:2] for warp in (True, False)))
        diff = [int(((t != tp) | (g != gp) | (a != ap).any(0)).sum())
                for t, g, a in outs]
        diff.append(int((counts[0] != counts[1]).any(1).sum()))
        bad += sum(diff)
        print(f"{label} attrs walk tri mode {tri_mode}: the warp walk, "
              f"closest_walk with attributes, lane counts differ on {diff} "
              f"of {o.shape[0]} rays")
    return bad


FRAME_W, FRAME_H = 37, 23   # partial tiles and warps; 851 = 26 x 32 + 19
FRAME_VARIANTS = (("default", {}), ("raw", dict(use_gram_tri=False)),
                  ("mt+fresnel", dict(use_mt=True, use_fresnel=True)),
                  ("no shadows, 5 bounces", dict(enable_shadows=False,
                                                 max_bounces=5)))


def frame_inputs(which):
    """(split tables, attribute table, parameter row) of scene 1, 2 or
    "typed" (the typed scene with a default camera and a light) on the
    CPU."""
    from raytracer_tpu_torch.core.types import Light
    from raytracer_tpu_torch.render import whitted
    from raytracer_tpu_torch.render import wholeframe as wf
    if which == "typed":
        flat = typed_scene("cpu")
        lin = linearize(build_bvh(flat, 3))
        camera = from_euler(fov_deg=60, aspect=4 / 3)
        light = Light(tuple(TYPED_LIGHT.tolist()), (1.0, 1.0, 1.0), 20.0)
    else:
        sc = generate_scene(which, device="cpu")
        flat, camera, light = sc.flat, sc.camera, sc.light
        lin = linearize(build_bvh(flat, sc.bvh_max_depth))
    return (split_scene.prepare(flat, lin),
            whitted._attr_table(flat).contiguous(),
            wf.make_params(camera, light).contiguous())


def check_frame(lib, split, tab, par, cfg):
    """wholeframe_kernel's lockstep trace against the per-thread trace_ray
    on the host, at cfg's size: raygen over cfg.max_bounces bounces;
    raygen + emit of bounce 1; consume + emit of the rest on the emitted
    state, re-packed and sorted as the hybrid does it (6 and 9 rows; parked
    rays last, a partial last warp). Returns, by comparison, the number of
    pixels or rays that differ: colours and state against trace_ray with
    the any-hit shadow leg, each lane's closest-walk tests and shadow-leg
    tests against its closest_walk's and occluded's, and the colours and
    state against trace_ray with the closest-mode shadow leg."""
    from raytracer_tpu_torch.render import wholeframe as wf

    def rows(x):
        return int(x.reshape(x.shape[0], -1).ne(0).any(1).sum())
    diffs = {}

    def compare(mode, **kw):
        (cw, sw, nw, _), (ck, sk, nk, _), (cc, sc_, _, _) = (
            host_frame(lib, split, tab, par, cfg, how, **kw)
            for how in (0, 1, 2))
        st = [] if sw is None else [(sw - sk).t(), (sw - sc_).t()]
        diffs[f"{mode} colour"] = rows(cw - ck)
        diffs[f"{mode} closest tests"] = rows(nw[:, 0] - nk[:, 0])
        diffs[f"{mode} shadow tests"] = rows(nw[:, 1] - nk[:, 1])
        diffs[f"{mode} closest-mode shadow colour"] = rows(cw - cc)
        if st:
            diffs[f"{mode} state"] = rows(st[0])
            diffs[f"{mode} closest-mode shadow state"] = rows(st[1])
        return sw

    compare("raygen")
    state = compare("raygen+emit", bounces=1, emit=True)
    parked = int((state[0] >= 1e30).sum())
    for n_rows in (6, 9):
        rays, perm = wf._repack(state, n_rows)
        compare(f"consume {n_rows} rows", bounces=cfg.max_bounces - 1,
                emit=True, rays=rays.contiguous(),
                ret=perm.to(torch.int32).contiguous())
    return diffs, parked


def check_frames(lib, which):
    """check_frame in every variant of FRAME_VARIANTS on scene ``which``.
    Returns the count of differences."""
    split, tab, par = frame_inputs(which)
    bad = 0
    for name, kw in FRAME_VARIANTS:
        cfg = RenderConfig(width=FRAME_W, height=FRAME_H,
                           **{"max_bounces": 3, **kw})
        diffs, parked = check_frame(lib, split, tab, par, cfg)
        bad += sum(diffs.values())
        print(f"scene {which} frame trace {name} {FRAME_W}x{FRAME_H}: "
              f"{sum(diffs.values())} differences over "
              f"{len(diffs)} comparisons ({parked} rays parked after "
              "bounce 1)" + "".join(f"; {k} {v}" for k, v in diffs.items()
                                    if v))
    return bad


def check_occlusion(lib, tree, o, d, limit, use_mt, t_cull, label):
    """occlusion_kernel's warp walk against occlusion_plain and the
    per-thread packet_walk<MT, CULL, true> (the result and each lane's
    counts). Returns the count of differences."""
    ow, sw, cw = host_warp(lib, tree, o, d, use_mt, t_cull, limit, True)
    ok, ck = host_packet(lib, tree, o, d, use_mt, t_cull, limit, True)
    op = packet.occlusion_plain(tree, o, d, limit, use_mt, t_cull)
    diff = [int((ow != op).sum()), int((ok != op).sum()),
            int((cw != ck).any(1).sum())]
    print(f"{label} occlusion mt {int(use_mt)} t_cull {int(t_cull)}: warp "
          f"walk, per-thread walk, lane counts differ on {diff} of "
          f"{o.shape[0]} rays ({int(op.sum())} occluded); SIMD efficiency "
          f"{simd_efficiency(sw):.3f}")
    return sum(diff)


def check_brute(lib, rows, counts, o, d, gate, label):
    """brute_kernel's walk against brute_plain, both triangle tests, with
    the run table staged in the kernel's chunks and in chunks of 3000 runs
    (whole). Returns the count of differences."""
    bad = 0
    for use_mt in (False, True):
        tp, rp = brute.brute_plain(rows, counts, o, d, use_mt, gate)
        runs = brute.box_runs(rows, counts, gate)
        for chunk in (RUN_CHUNK, 3000):
            (tk, rk), st = host_brute(lib, rows, runs, counts, o, d, use_mt,
                                      gate, chunk)
            diff = [int((tk != tp).sum()), int((rk != rp).sum())]
            bad += sum(diff)
            print(f"{label} brute walk mt {int(use_mt)} gate {int(gate)} "
                  f"chunk {chunk} ({runs.shape[0]} runs): t, row differ on "
                  f"{diff}; gates, row tests per ray "
                  f"{[round(x / o.shape[0], 1) for x in st[:2]]}, SIMD "
                  f"efficiency {st[1] / max(32 * st[2], 1):.3f}")
    return bad


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
            bad += check_split(lib, split, o, d, f"scene {which}")
            bad += check_frames(lib, which)
            bad += check_fused(lib, split, o, d, sc.light.position,
                               SHADOW_EPS, f"scene {which}")
            bad += check_attrs(lib, split, o, d, f"scene {which}")
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
                    limit = occlusion_limits(tp)
                    bad += check_occlusion(lib, tree, o, d, limit, use_mt,
                                           t_cull, f"scene {which}")
                    diff = [int((tk != tp).sum()), int((rk != rp).sum())]
                    bad += sum(diff)
                    print(f"scene {which} packet mt {int(use_mt)} t_cull "
                          f"{int(t_cull)}: t, row differ on {diff} of "
                          f"{o.shape[0]} rays")
            for gate in (False, True):
                rows = brute.pack_rows_ext(
                    sc.flat, perm,
                    shape_leaf_boxes(lin, sc.num_shapes) if gate else None)
                bad += check_brute(lib, rows, counts, o, d, gate,
                                   f"scene {which}")
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
                    _, sw = host_warp(lib, tree, p.contiguous(),
                                      (to / dist[:, None]).contiguous(),
                                      False, True, dist.contiguous())
                    steps = [round(32 * x / p.shape[0], 1) for x in sw[3:]]
                    line += (f"; light rays of the hits {per} "
                             f"({float(occ.float().mean()):.3f} occluded), "
                             f"their warp walk: node and row steps a warp "
                             f"{steps}, SIMD efficiency "
                             f"{simd_efficiency(sw):.3f}")
                print(line)
            # the split walk's and the brute walk's work on those rays
            (t, _), cw, sw = host_closest(lib, split, po, pd, 1, warp=True)
            lanes = int(cw[:, 2].sum())
            print(f"scene {which} 200x150 split walk (Gram): pre-pass, node, "
                  f"triangle tests per ray "
                  f"{[round(float(x), 1) for x in cw.float().mean(0)]}; "
                  f"node and row steps a warp "
                  f"{[round(32 * x / po.shape[0], 1) for x in sw]}, SIMD "
                  f"efficiency {lanes / max(32 * sw[1], 1):.3f}")
            # fused_kernel's walk on those rays, any-hit and closest-mode
            # shadow legs
            for how, name in ((0, "lockstep, any-hit shadow leg"),
                              (2, "per thread, closest-mode shadow leg")):
                _, nc, fs = host_fused(lib, split, po, pd, sc.light.position,
                                       1, SHADOW_EPS, how)
                per = nc.double().mean(0)
                line = (f"scene {which} 200x150 fused walk (Gram, {name}): "
                        f"closest-walk tests per ray "
                        f"{[round(float(x), 1) for x in per[0]]}, shadow-leg "
                        f"tests {[round(float(x), 1) for x in per[1]]} "
                        "(pre, node, triangle)")
                if how == 0:
                    steps = [round(32 * x / po.shape[0], 1) for x in fs]
                    simd = int(nc[:, :, 2].sum()) / max(32 * fs[1], 1)
                    line += (f"; node and row steps a warp {steps}, SIMD "
                             f"efficiency {simd:.3f}")
                print(line)
            # the frame trace's work at 200x150, 3 bounces (default config)
            _, tab, par = frame_inputs(which)
            cfg = RenderConfig(width=200, height=150)
            for how, name in ((0, "lockstep, any-hit shadow leg"),
                              (2, "per thread, closest-mode shadow leg")):
                _, _, nc, fs = host_frame(lib, split, tab, par, cfg, how)
                per = nc.double().mean(0)
                line = (f"scene {which} 200x150x3 frame trace ({name}): "
                        f"closest-walk tests per pixel "
                        f"{[round(float(x), 1) for x in per[0]]}, shadow-leg "
                        f"tests {[round(float(x), 1) for x in per[1]]} "
                        "(pre, node, triangle)")
                if how == 0:
                    steps = [round(32 * x / nc.shape[0], 1) for x in fs]
                    simd = int(nc[:, :, 2].sum()) / max(32 * fs[1], 1)
                    line += (f"; node and row steps a warp {steps}, SIMD "
                             f"efficiency {simd:.3f}")
                print(line)
            rows = brute.pack_rows_ext(sc.flat, perm,
                                       shape_leaf_boxes(lin, sc.num_shapes))
            runs = brute.box_runs(rows, counts)
            _, st = host_brute(lib, rows, runs, counts, po, pd, False, True,
                               RUN_CHUNK)
            print(f"scene {which} 200x150 brute walk (gate on, "
                  f"{runs.shape[0]} runs of {rows.shape[0]} rows): gates, "
                  f"row tests per ray "
                  f"{[round(x / po.shape[0], 1) for x in st[:2]]}; rows a "
                  f"warp steps through {32 * st[2] / po.shape[0]:.1f} "
                  f"({32 * st[2] / po.shape[0] / rows.shape[0]:.4f} of the "
                  f"rows), SIMD efficiency {st[1] / max(32 * st[2], 1):.3f}")
        # every shape type, planes included (no reference scene has one)
        typed = typed_scene("cpu")
        o, d = seeded_rays(from_euler(fov_deg=60, aspect=4 / 3), 2048, gen)
        perm, counts = brute.sort_scene_by_type(typed)
        typed_lin = linearize(build_bvh(typed, 3))
        for gate in (False, True):
            rows = brute.pack_rows_ext(
                typed, perm,
                shape_leaf_boxes(typed_lin, typed.num_shapes) if gate
                else None)
            bad += check_brute(lib, rows, counts, o, d, gate,
                               f"typed scene {counts}")
        typed_split = split_scene.prepare(typed, typed_lin)
        bad += check_split(lib, typed_split, o, d, "typed scene")
        bad += check_fused(lib, typed_split, o, d, TYPED_LIGHT, SHADOW_EPS,
                           "typed scene")
        bad += check_attrs(lib, typed_split, o, d, "typed scene")
        bad += check_frames(lib, "typed")
        for use_mt in (False, True):
            for t_cull in (False, True):
                tree = packet.make_tree(typed_lin, typed, t_cull=t_cull)
                tp, _ = packet.packet_plain(tree, o, d, use_mt, t_cull)
                bad += check_occlusion(lib, tree, o, d, occlusion_limits(tp),
                                       use_mt, t_cull, "typed scene")
    print("host check:", "OK" if bad == 0 else f"{bad} differences")
    return 0 if bad == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
