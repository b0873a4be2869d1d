// The port's CUDA kernels for Hopper (sm_90a), with a plain C interface
// bound from Python with ctypes (render/kernels.py).
//
// wholeframe_kernel replaces raytracer_tpu/render/wholeframe.py::
//   _wholeframe_kernel (75-385) in its three modes: raygen (one thread per
//   pixel runs the whole Whitted loop, so a frame is one launch), raygen +
//   emit_state (bounce 1, plus the continuation state o, d, atten of every
//   pixel) and consume_state (one thread per given ray: o, d, [atten] and
//   the image-order pixel index, from which the background is re-derived;
//   it may emit again). The hybrid launches it on a re-sorted ray stream.
//   Raygen may trace a window of image rows (a strip of a strip-sharded
//   frame, parallel/sharding.py), whose offset rides the parameter row.
//   A warp traces its 32 pixels (an 8x4 patch) or rays in lockstep
//   (raytrace.cuh::warp_trace): one vote a bounce while some ray lives;
//   per bounce the closest hit by closest_hit_kernel's split walk, the id
//   and normal read once from the winning row, and the shadow leg as the
//   split walk's any-hit mode below the light distance; shading per lane;
//   bit for bit the per-thread trace (trace_ray).
// closest_hit_kernel replaces raytracer_tpu/render/pallas_split.py::
//   _split_kernel / _split_body (961-964, 343-651): closest hit (t, gid) or
//   occlusion against a per-ray limit. A warp walks its 32 rays in
//   lockstep (raytrace.cuh::split_walk): each lane runs the pre-pass over
//   the spheres, planes and walls alone, PRE_ILP rows before its in-order
//   updates, then the warp walks the triangle tree under one pointer with
//   per-lane culling, a leaf's rows staged in shared memory by cp.async
//   (32 rows a chunk, double buffered), ROW_ILP rows a lane before its
//   updates; bit for bit the per-thread walk (closest_walk, occluded).
// fused_kernel replaces pallas_split.py::_fused_kernel (905-958): the
//   closest hit with normals and then the shadow walk toward the light, so
//   a bounce of the per-bounce route is one launch. A warp walks its 32
//   rays in lockstep (raytrace.cuh::warp_fused): the closest hit by the
//   split walk, the normal read once from the winning row, then the
//   shadow ray of each lane with a hit (fused_shadow_ray, the per-thread
//   fused_ray's code) by the split walk's any-hit mode below the light
//   distance; bit for bit fused_ray and fused_plain.
// closest_attrs_kernel replaces pallas_split.py::_split_kernel_attrs
//   (967-975): the closest hit (t, gid) with the 11 shading attributes of
//   the winning shape (normal, colour, ka, kd, ks, kf, shininess). A warp
//   walks its 32 rays in lockstep by closest_hit_kernel's split walk; the
//   normal and the material columns are read once from the winning row
//   after it (split_attrs; the TPU kernel carries 11 values through its
//   loop); misses and parked rays give zero attributes.
// resolve_kernel replaces pallas_split.py::_resolve_kernel (978-1033):
//   the TPU's loop over a tile's distinct ids becomes a per-ray gather from
//   a copy of the attribute table padded to 16 floats, so that a row is
//   four aligned 16-byte loads; one thread a ray, the 11 outputs stored as
//   rows of n floats, coalesced.
// packet_kernel replaces raytracer_tpu/render/pallas_bvh.py::_packet_kernel
//   (169-265, with _row_intersect 85-166). As the TPU kernel walks a
//   packet, a warp walks its 32 rays through the reference median tree in
//   lockstep under one pointer (raytrace.cuh::warp_walk): each lane enters
//   only the nodes its own ray probes (so the leaf-box gate and t-culling
//   are per lane) and waits at a skip pointer otherwise, which gives each
//   lane its per-thread walk's result bit for bit. A leaf's rows are
//   staged in shared memory with cp.async, 32 rows a chunk, double
//   buffered, and every lane reads the same row at once (a broadcast, one
//   type branch for the warp); each lane tests ROW_ILP rows before it
//   updates, so that their arithmetic overlaps.
// occlusion_kernel replaces pallas_bvh.py::_occlusion_kernel (268-355):
//   packet_kernel's warp walk in any-hit mode (warp_walk<..., true>): each
//   lane leaves the walk at its first inner hit below its max_t, the warp
//   stops reading a leaf once no lane probes it and leaves the tree once
//   no lane is left.
// brute_kernel replaces raytracer_tpu/render/pallas_kernel.py::
//   _closest_hit_kernel (95-243): every row in type-sorted order, optionally
//   gated by each row's leaf box. The gate comes first, once per run of
//   rows with one box (raytrace.cuh::brute_walk): the block stages the run
//   table in shared memory by cp.async, each lane gates its ray against
//   each run's box and the warp tests only the runs some lane passes,
//   ROW_ILP rows a lane before its updates.
// gather_rows_kernel and row_grads_kernel replace no TPU kernel: they are
//   the inverse step's per-ray row gather (the attribute row that shades a
//   hit, render/whitted.py, and the packed row that re-derives t,
//   diff/kernel_vjp.py) and its backward, where the JAX package leaves
//   both to XLA's gather and scatter-add (render/row_gather.py). The
//   gather writes the rows column by column into one (W, n) array, whose
//   rows the autograd function hands out as the column groups; its
//   backward takes each group's gradient as it comes, so no slice of a
//   gathered row needs a zero-filled backward. The backward
//   sums a warp's gradients by shape id (__match_any_sync) before one lane
//   a distinct id adds them to the table with atomics, and skips a ray
//   whose gradients are all zero (missed and parked rays): index_add_
//   issues an atomic for every ray and column, and most of them contend on
//   a few rows (row 0 takes every missed and parked ray).
//
// What bounds them on this card: the walks are bound by operations, not
// bytes. The tables (0.25 MB for scene 1, 0.85 MB for scene 2) stay in L2
// and L1; a pixel's walks do tens to a hundred pre-pass, node and triangle
// tests of 27-71 f32 operations each (chip_smoke.py counts them). A
// per-thread stackless walk lets the lanes of a warp diverge; every walk
// on the card now keeps a warp's lanes in step instead: on scene 2's
// 800x600 primary rays 83% of the lanes of packet_kernel's row steps test
// the row, and it takes 0.63 ms against an operations bound of 0.047 ms
// (scene 1: 0.10 ms against 0.0046 ms of bytes; NVIDIA H100 80GB HBM3 at
// 700 W, device time from chip_smoke.py), held back by the latency of
// each lane's chain of row tests more than by issue slots;
// closest_hit_kernel's split walk, wholeframe_kernel's trace,
// occlusion_kernel, fused_kernel and closest_attrs_kernel keep their lanes
// in step the same way. resolve_kernel does no walk: it moves 16 bytes in
// and 44 out per ray and is bound by bytes (0.0087 ms on 480,000 rays); it
// takes 0.0100-0.0103 ms on the device, 0.85-0.87 of that bound
// (index_select of the rows alone: 0.021-0.022 ms). brute_kernel is bound by operations: its gates (one a
// run, 985-1,059 a ray on scenes 1 and 2) and the row tests of the runs
// whose box some lane of the warp hits (0.9% of the rows on scene 1, 5.9%
// on scene 2, tools/host_check.py).
//
// Each launcher returns cudaGetLastError() after the launch; the Python
// wrapper raises if it is not 0. Launches go on the caller's stream and
// never synchronise.
#include <cuda_runtime.h>

#include "raytrace.cuh"

namespace rt {

__device__ __forceinline__ void add_stats(unsigned long long* stats,
                                          const Counts& c) {
  if (stats != nullptr) {
    atomicAdd(stats + 0, (unsigned long long)c.pre);
    atomicAdd(stats + 1, (unsigned long long)c.node);
    atomicAdd(stats + 2, (unsigned long long)c.tri);
  }
}

// A lockstep walk's node and row steps (stats 3 and 4), once a warp.
__device__ __forceinline__ void add_warp_stats(unsigned long long* stats,
                                               const WarpCounts& wc) {
  if (stats != nullptr && (threadIdx.x & 31) == 0) {
    atomicAdd(stats + 3, (unsigned long long)wc.node);
    atomicAdd(stats + 4, (unsigned long long)wc.row);
  }
}

// The card's lane policy of warp_walk (raytrace.cuh): a thread is one lane
// and votes with its warp; a leaf's rows go to shared memory with cp.async
// (16 bytes a lane in turn; .ca keeps them in L1 too, for the next warps
// that enter the leaf), awaited with cp.async.wait_group and made visible
// to the warp by __syncwarp.
struct CardWarp {
  static constexpr int N = 1;
  __device__ static __forceinline__ bool any(const bool* v) {
    return __any_sync(0xffffffffu, v[0]);
  }
  __device__ static __forceinline__ void sync() { __syncwarp(); }
  __device__ static __forceinline__ void stage(float* dst, const float* src,
                                               int n16) {
    for (int q = (int)(threadIdx.x & 31); q < n16; q += 32) {
      unsigned s = (unsigned)__cvta_generic_to_shared(dst + 4 * q);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(s),
                   "l"(src + 4 * q)
                   : "memory");
    }
  }
  __device__ static __forceinline__ void commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  __device__ static __forceinline__ void wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
  __device__ static __forceinline__ void wait_but_one() {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  }
};

// wholeframe_kernel: the lockstep frame trace (raytrace.cuh::warp_trace),
// one warp of 32 pixels or rays (trace_entry). Every thread of a warp
// stays to the end: a thread past the frame or the rays is a lane that
// never walks, and only its stores are skipped. In raygen mode the grid
// covers a window of `rows` image rows from row y_off (par[20]) of the
// H-row image: a strip of a strip-sharded frame (rows = H and y_off = 0
// for a whole frame). out: (n, 3) colours, in window order in raygen mode
// (n = W * rows). state (emit): 9 rows of n
// floats, o, d, atten. stats: the lanes' pre-pass, node and triangle tests
// (0-2; closest walks and shadow legs) and the warps' node and row steps
// (3, 4). At least 4 blocks an SM lets ptxas use up to 128 registers: it
// takes 80-94 and spills none, where with BLOCK alone it took 80 and
// spilled up to 112 bytes (MT variants), at equal or lower times (NVIDIA
// H100 80GB HBM3 at 700 W, tools/kernel_ab.py; the staging buffers allow
// 6 blocks an SM, the registers 5-6).
template <int TRI, bool CONSUME, bool EMIT>
__global__ void __launch_bounds__(BLOCK, 4)
wholeframe_kernel(Tables s, const float* __restrict__ tab,
                  const float* __restrict__ par,
                  const float* __restrict__ rays, int n_rows,
                  const int* __restrict__ ret, int n,
                  float* __restrict__ out, float* __restrict__ state,
                  int W, int H, int rows, Shade sh,
                  unsigned long long* stats) {
  __shared__ __align__(16) float rows_buf[BLOCK / 32][2 * SPLIT_CHUNK_FLOATS];
  TraceLane a;
  int i = trace_entry<CONSUME>(a, load_params(par), rays, n_rows, ret, n, W,
                               H, rows, (int)blockIdx.x, (int)blockIdx.y,
                               (int)threadIdx.x);
  WarpCounts wc = {0u, 0u};
  warp_trace<CardWarp, TRI>(s, tab, par, sh, &a, nullptr,
                            rows_buf[threadIdx.x >> 5], wc);
  if (i >= 0) {
    trace_store<EMIT>(a, i, n, out, state);
    add_stats(stats, a.c);
  }
  add_warp_stats(stats, wc);
}

// resolve_kernel: one ray a thread, in blocks of RES_BLOCK threads. On the
// card this was faster than two or four rays a thread with all their
// loads issued before any arithmetic (tools/kernel_ab.py, PERF.md).
constexpr int RES_BLOCK = 256;

// tab: (n_tab, ATTR_PAD_W) padded attribute rows, 16-byte aligned, read as
// four 16-byte loads. out: 11 rows of n floats (n(3), color(3), ka, kd,
// ks, kf, shininess). The row is max(gid, 0), clamped to the table as the
// plain version clamps it.
__global__ void __launch_bounds__(RES_BLOCK)
resolve_kernel(const float4* __restrict__ tab, int n_tab,
               const float* __restrict__ gid, const float* __restrict__ p,
               int n, float* __restrict__ out) {
  int i = blockIdx.x * RES_BLOCK + (int)threadIdx.x;
  if (i >= n) return;
  int si = (int)jmax(gid[i], 0.0f);
  si = si < n_tab ? si : n_tab - 1;
  float v[ATTR_PAD_W];
  for (int q = 0; q < 4; ++q) {
    float4 x = __ldg(tab + 4LL * si + q);
    v[4 * q] = x.x;
    v[4 * q + 1] = x.y;
    v[4 * q + 2] = x.z;
    v[4 * q + 3] = x.w;
  }
  float a[11];
  resolve_row(v, p[3 * i], p[3 * i + 1], p[3 * i + 2], a);
  for (int k = 0; k < 11; ++k) out[k * (long long)n + i] = a[k];
}

constexpr int PK_BLOCK = 128, PK_WARPS = PK_BLOCK / 32;

// o, d: (n, 3). packet_kernel: t and the local row of the closest hit, by
// the warp walk (raytrace.cuh::warp_walk). Every thread of a warp stays to
// the end: a thread past n is a lane that never walks. stats: the lanes'
// counts summed (0-2) and the warps' node and row steps (3, 4).
template <bool MT, bool CULL>
__global__ void __launch_bounds__(PK_BLOCK)
packet_kernel(Tree s, const float* __restrict__ o,
              const float* __restrict__ d, int n, float* __restrict__ t_out,
              int* __restrict__ row_out, unsigned long long* stats) {
  __shared__ __align__(16) float rows_buf[PK_WARPS][2 * CHUNK_FLOATS];
  int i = blockIdx.x * PK_BLOCK + (int)threadIdx.x;
  bool live = i < n;
  Ray r = make_ray(0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f);
  if (live)
    r = make_ray(o[3 * i], o[3 * i + 1], o[3 * i + 2], d[3 * i],
                 d[3 * i + 1], d[3 * i + 2]);
  Lane a;
  lane_init(a, s, live, r);
  WarpCounts wc = {0u, 0u};
  warp_walk<CardWarp, MT, CULL>(s, &a, rows_buf[threadIdx.x >> 5], wc);
  if (live) {
    t_out[i] = a.t;
    row_out[i] = a.row;
    add_stats(stats, a.c);
  }
  add_warp_stats(stats, wc);
}

// occlusion_kernel: 1 where some inner hit has t < max_t[i], by the warp
// walk in occlusion mode (raytrace.cuh::warp_walk<..., true>); threads and
// stats as in packet_kernel.
template <bool MT, bool CULL>
__global__ void __launch_bounds__(PK_BLOCK)
occlusion_kernel(Tree s, const float* __restrict__ o,
                 const float* __restrict__ d,
                 const float* __restrict__ max_t, int n,
                 unsigned char* __restrict__ occ_out,
                 unsigned long long* stats) {
  __shared__ __align__(16) float rows_buf[PK_WARPS][2 * CHUNK_FLOATS];
  int i = blockIdx.x * PK_BLOCK + (int)threadIdx.x;
  bool live = i < n;
  Ray r = make_ray(0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f);
  float limit = INF;
  if (live) {
    r = make_ray(o[3 * i], o[3 * i + 1], o[3 * i + 2], d[3 * i],
                 d[3 * i + 1], d[3 * i + 2]);
    limit = max_t[i];
  }
  Lane a;
  lane_init(a, s, live, r, limit);
  WarpCounts wc = {0u, 0u};
  warp_walk<CardWarp, MT, CULL, true>(s, &a, rows_buf[threadIdx.x >> 5], wc);
  if (live) {
    occ_out[i] = a.occ ? 1 : 0;
    add_stats(stats, a.c);
  }
  add_warp_stats(stats, wc);
}

constexpr int SPLIT_BLOCK = 128, SPLIT_WARPS = SPLIT_BLOCK / 32;

// The split walk's entry for the kernels below: thread i of the grid is
// lane a, on ray i below limit[i] (INF without a limit) if i < n, else a
// lane that never walks. Returns whether the thread holds a ray.
__device__ __forceinline__ bool split_entry(SplitLane& a, const Tables& s,
                                            const float* __restrict__ o,
                                            const float* __restrict__ d,
                                            const float* __restrict__ limit,
                                            int n, int i) {
  bool live = i < n;
  Ray r = make_ray(0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f);
  float lim = INF;
  if (live) {
    r = make_ray(o[3 * i], o[3 * i + 1], o[3 * i + 2], d[3 * i],
                 d[3 * i + 1], d[3 * i + 2]);
    if (limit != nullptr) lim = limit[i];
  }
  split_lane_init(a, s, live, r, lim);
  return live;
}

// closest_hit_kernel: the split walk (raytrace.cuh::split_walk), one warp
// of 32 rays in lockstep. Every thread of a warp stays to the end: a thread
// past n is a lane that never walks. stats: the lanes' pre-pass, node and
// triangle tests (0-2) and the warps' node and row steps (3, 4).
template <int TRI, bool OCCLUSION>
__global__ void __launch_bounds__(SPLIT_BLOCK)
closest_hit_kernel(Tables s, const float* __restrict__ o,
                   const float* __restrict__ d,
                   const float* __restrict__ limit, int n,
                   float* __restrict__ t_out, int* __restrict__ gid_out,
                   unsigned long long* stats) {
  __shared__ __align__(16) float rows_buf[SPLIT_WARPS][2 * SPLIT_CHUNK_FLOATS];
  int i = blockIdx.x * SPLIT_BLOCK + (int)threadIdx.x;
  SplitLane a;
  bool live = split_entry(a, s, o, d, OCCLUSION ? limit : nullptr, n, i);
  WarpCounts wc = {0u, 0u};
  split_walk<CardWarp, TRI, OCCLUSION>(s, &a, rows_buf[threadIdx.x >> 5], wc);
  if (live) {
    if (OCCLUSION) {
      t_out[i] = a.occ ? 0.0f : INF;
      gid_out[i] = -1;
    } else {
      t_out[i] = a.t;
      gid_out[i] = (int)split_id(s, a, G_GID, T_GID);
    }
    add_stats(stats, a.c);
  }
  add_warp_stats(stats, wc);
}

// fused_kernel: the lockstep closest hit and shadow leg (raytrace.cuh::
// warp_fused), one warp of 32 rays, blocks and staging buffers as in
// closest_hit_kernel. Every thread of a warp stays to the end: a thread
// past n is a lane that never walks. stats: the lanes' pre-pass, node and
// triangle tests of both legs (0-2) and the warps' node and row steps of
// both walks (3, 4).
template <int TRI>
__global__ void __launch_bounds__(SPLIT_BLOCK)
fused_kernel(Tables s, const float* __restrict__ o,
             const float* __restrict__ d, const float* __restrict__ light,
             int n, float shadow_eps, float* __restrict__ t_out,
             int* __restrict__ gid_out, unsigned char* __restrict__ sh_out,
             unsigned long long* stats) {
  __shared__ __align__(16) float rows_buf[SPLIT_WARPS][2 * SPLIT_CHUNK_FLOATS];
  int i = blockIdx.x * SPLIT_BLOCK + (int)threadIdx.x;
  SplitLane a;
  bool live = split_entry(a, s, o, d, nullptr, n, i);
  bool in_shadow;
  WarpCounts wc = {0u, 0u};
  warp_fused<CardWarp, TRI>(s, &a, ld(light), ld(light + 1), ld(light + 2),
                            shadow_eps, &in_shadow, nullptr,
                            rows_buf[threadIdx.x >> 5], wc);
  if (live) {
    t_out[i] = a.t;
    gid_out[i] = (int)split_id(s, a, G_GID, T_GID);
    sh_out[i] = in_shadow ? 1 : 0;
    add_stats(stats, a.c);
  }
  add_warp_stats(stats, wc);
}

// closest_attrs_kernel: the closest-mode split walk of closest_hit_kernel,
// then t, the gid and the 11 attributes of the winning row (raytrace.cuh::
// split_attrs). attrs: 11 rows of n floats (n(3), color(3), ka, kd, ks,
// kf, shininess). Threads and stats as in closest_hit_kernel.
template <int TRI>
__global__ void __launch_bounds__(SPLIT_BLOCK)
closest_attrs_kernel(Tables s, const float* __restrict__ o,
                     const float* __restrict__ d, int n,
                     float* __restrict__ t_out, int* __restrict__ gid_out,
                     float* __restrict__ attrs,
                     unsigned long long* stats) {
  __shared__ __align__(16) float rows_buf[SPLIT_WARPS][2 * SPLIT_CHUNK_FLOATS];
  int i = blockIdx.x * SPLIT_BLOCK + (int)threadIdx.x;
  SplitLane a;
  bool live = split_entry(a, s, o, d, nullptr, n, i);
  WarpCounts wc = {0u, 0u};
  split_walk<CardWarp, TRI, false>(s, &a, rows_buf[threadIdx.x >> 5], wc);
  if (live) {
    t_out[i] = a.t;
    gid_out[i] = (int)split_id(s, a, G_GID, T_GID);
    float v[3 + N_MAT];
    split_attrs(s, a, v);
    for (int k = 0; k < 3 + N_MAT; ++k) attrs[k * (long long)n + i] = v[k];
    add_stats(stats, a.c);
  }
  add_warp_stats(stats, wc);
}

// brute_kernel's lane policy: CardWarp's votes, with the run table staged
// by the whole block (16 bytes a thread in turn) behind block barriers.
struct CardBlock : CardWarp {
  __device__ static __forceinline__ void sync() { __syncthreads(); }
  __device__ static __forceinline__ void stage(float* dst, const float* src,
                                               int n16) {
    for (int q = (int)threadIdx.x; q < n16; q += (int)blockDim.x) {
      unsigned s = (unsigned)__cvta_generic_to_shared(dst + 4 * q);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(s),
                   "l"(src + 4 * q)
                   : "memory");
    }
  }
};

// brute_kernel: one ray a thread, BR_BLOCK threads a block; each block
// stages the run table, RUN_CHUNK runs (2 KB) a chunk, double buffered.
// On an H100, blocks of 32-256 threads and chunks of 64-768 runs were
// within a few percent of each other, and persistent blocks over several
// ray tiles were slower (tools/kernel_ab.py; PERF.md).
constexpr int BR_BLOCK = 128, RUN_CHUNK = 64;

// stats: the lanes' gate tests and row tests (0, 1) and the warps' row
// steps (2).
template <bool MT, bool GATE>
__global__ void __launch_bounds__(BR_BLOCK)
brute_kernel(Runs s, const float* __restrict__ o,
             const float* __restrict__ d, int n, float* __restrict__ t_out,
             int* __restrict__ row_out, unsigned long long* stats) {
  __shared__ __align__(16) float runs_buf[2 * RUN_CHUNK * RUN_W];
  int i = blockIdx.x * BR_BLOCK + (int)threadIdx.x;
  bool live = i < n;
  Ray r = make_ray(0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f);
  if (live)
    r = make_ray(o[3 * i], o[3 * i + 1], o[3 * i + 2], d[3 * i],
                 d[3 * i + 1], d[3 * i + 2]);
  BruteLane a;
  brute_lane_init(a, live, r);
  WarpCounts wc = {0u, 0u};
  brute_walk<CardBlock, MT, GATE>(s, &a, runs_buf, wc);
  if (live) {
    t_out[i] = a.t;
    row_out[i] = a.row;
  }
  if (stats != nullptr) {
    atomicAdd(stats + 0, (unsigned long long)a.gates);
    atomicAdd(stats + 1, (unsigned long long)a.tests);
    if ((threadIdx.x & 31) == 0)
      atomicAdd(stats + 2, (unsigned long long)wc.row);
  }
}

// gather_rows_kernel and row_grads_kernel: one ray a thread, in blocks of
// GR_BLOCK threads, over a table of W columns (the attribute table's 15,
// the packed rows' 24). The gather writes column c of ray i at
// out[c * n + i], a (W, n) array whose rows its caller hands out as the
// column groups. The backward reads column c of ray i at
// g.ptr[c][i * g.stride[c]], each column where its gradient tensor keeps
// it. Both are bound by bytes (a row of W floats from L2 in, W floats
// out; W gradients in, a few atomics out).
constexpr int GR_BLOCK = 256, GR_MAX_W = 24;

struct ColumnsIn {
  const float* ptr[GR_MAX_W];  // null: the column has no gradient
  long long stride[GR_MAX_W];
};

// The row of shape id s, clamped to the table (ids come from the closest-
// hit kernels, 0 on a miss, so a clamp changes none of them).
__device__ __forceinline__ int table_row(int s, int n_tab) {
  return s < 0 ? 0 : (s < n_tab ? s : n_tab - 1);
}

// tab: (n_tab, W) rows, 16-byte aligned; out: (W, n). A copy, bit for
// bit index_select, each column's writes coalesced.
template <int W>
__global__ void __launch_bounds__(GR_BLOCK)
gather_rows_kernel(const float* __restrict__ tab, int n_tab,
                   const int* __restrict__ sid, int n,
                   float* __restrict__ out) {
  int i = blockIdx.x * GR_BLOCK + (int)threadIdx.x;
  if (i >= n) return;
  const float* row = tab + (long long)table_row(sid[i], n_tab) * W;
  float v[W];
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int q = 0; q < W / 4; ++q) {
      float4 x = __ldg(reinterpret_cast<const float4*>(row) + q);
      v[4 * q] = x.x;
      v[4 * q + 1] = x.y;
      v[4 * q + 2] = x.z;
      v[4 * q + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int c = 0; c < W; ++c) v[c] = __ldg(row + c);
  }
#pragma unroll
  for (int c = 0; c < W; ++c) out[(long long)c * n + i] = v[c];
}

// The table's gradient: out (n_tab, W), zero on entry, += each ray's
// column gradients at its row. A ray whose gradients are all zero adds
// nothing (x + 0 = x) and is left out. The lanes of a warp with one id
// (peers, by __match_any_sync) sum their gradients by a tree over the
// peers, shuffling every column at each level; the lowest lane of each id
// adds the sums that are not zero with one atomicAdd a column. Every
// thread of a warp stays to the end (the shuffles need all 32): a thread
// past n is a lane with no gradient. stats: the rays summed (0) and the
// row adds issued, one a distinct id in a warp (1).
template <int W>
__global__ void __launch_bounds__(GR_BLOCK)
row_grads_kernel(ColumnsIn g, const int* __restrict__ sid, int n, int n_tab,
                 float* __restrict__ out, unsigned long long* stats) {
  constexpr unsigned FULL = 0xffffffffu;
  int i = blockIdx.x * GR_BLOCK + (int)threadIdx.x;
  int lane = (int)(threadIdx.x & 31);
  float v[W];
  bool nz = false;
  int s = 0;
#pragma unroll
  for (int c = 0; c < W; ++c) v[c] = 0.0f;
  if (i < n) {
    s = table_row(sid[i], n_tab);
#pragma unroll
    for (int c = 0; c < W; ++c) {
      if (g.ptr[c] != nullptr) v[c] = g.ptr[c][(long long)i * g.stride[c]];
      nz |= v[c] != 0.0f;  // a NaN is not zero, and is added
    }
  }
  unsigned live = __ballot_sync(FULL, nz);
  if (live == 0) return;  // the whole warp: nothing to add
  // a lane with nothing to add is a group of its own (ids are >= 0)
  unsigned peers = __match_any_sync(FULL, nz ? s : -1 - lane);
  int rank = __popc(peers & ((1u << lane) - 1));
  unsigned above = peers & (0xfffffffeu << lane);
  // each level: a lane adds the partial sum of the next peer above it that
  // is still in; the lanes of odd rank then drop out, and the ranks halve.
  // The lowest lane of each group ends with the group's sum.
  while (__any_sync(FULL, above != 0u)) {
    int next = above != 0u ? __ffs(above) - 1 : lane;
#pragma unroll
    for (int c = 0; c < W; ++c) {
      if (g.ptr[c] == nullptr) continue;  // the same for the whole warp
      float t = __shfl_sync(FULL, v[c], next);
      if (above != 0u) v[c] += t;
    }
    above &= ~__ballot_sync(FULL, (rank & 1) != 0);
    rank >>= 1;
  }
  bool lead = nz && (__ffs(peers) - 1 == lane);
  unsigned leads = __ballot_sync(FULL, lead);
  if (lead) {
    float* dst = out + (long long)s * W;
#pragma unroll
    for (int c = 0; c < W; ++c)
      if (g.ptr[c] != nullptr && v[c] != 0.0f) atomicAdd(dst + c, v[c]);
  }
  if (stats != nullptr && lane == 0) {
    atomicAdd(stats + 0, (unsigned long long)__popc(live));
    atomicAdd(stats + 1, (unsigned long long)__popc(leads));
  }
}

}  // namespace rt

extern "C" {

int rt_wholeframe(const int* leaf_start, const int* leaf_count,
                  const int* skip, const float* nodes, const float* pre,
                  const float* tri, int m, int n_other, int n_sph,
                  const float* tab, const float* par, const float* rays,
                  int n_rows, const int* ret, int n, float* out,
                  float* state, int W, int H, int rows, int bounces,
                  float shadow_eps, float reflect_eps, int use_fresnel,
                  int enable_shadows, int tri_mode,
                  unsigned long long* stats, void* stream) {
  rt::Tables s = {leaf_start, leaf_count, skip, nodes, pre, tri,
                  m, n_other, n_sph};
  rt::Shade sh = {bounces, shadow_eps, reflect_eps, use_fresnel != 0,
                  enable_shadows != 0};
  bool consume = rays != nullptr, emit = state != nullptr;
  if (consume && (n_rows != 6 && n_rows != 9)) return (int)cudaErrorInvalidValue;
  dim3 grid = consume ? dim3((n + rt::BLOCK - 1) / rt::BLOCK)
                      : dim3((W + rt::TILE_W - 1) / rt::TILE_W,
                             (rows + rt::TILE_H - 1) / rt::TILE_H);
  cudaStream_t st = (cudaStream_t)stream;
#define RT_LAUNCH(TRI, C, E)                                               \
  rt::wholeframe_kernel<TRI, C, E><<<grid, rt::BLOCK, 0, st>>>(             \
      s, tab, par, rays, n_rows, ret, n, out, state, W, H, rows, sh, stats)
#define RT_MODES(TRI)                                                      \
  if (consume) {                                                           \
    if (emit) RT_LAUNCH(TRI, true, true); else RT_LAUNCH(TRI, true, false); \
  } else {                                                                 \
    if (emit) RT_LAUNCH(TRI, false, true); else RT_LAUNCH(TRI, false, false); \
  }
  switch (tri_mode) {
    case rt::TRI_RAW: RT_MODES(rt::TRI_RAW); break;
    case rt::TRI_GRAM: RT_MODES(rt::TRI_GRAM); break;
    case rt::TRI_MT: RT_MODES(rt::TRI_MT); break;
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef RT_MODES
#undef RT_LAUNCH
  return (int)cudaGetLastError();
}

int rt_closest_hit(const int* leaf_start, const int* leaf_count,
                   const int* skip, const float* nodes, const float* pre,
                   const float* tri, int m, int n_other, int n_sph,
                   const float* o, const float* d, const float* limit, int n,
                   float* t_out, int* gid_out, int occlusion, int tri_mode,
                   unsigned long long* stats, void* stream) {
  rt::Tables s = {leaf_start, leaf_count, skip, nodes, pre, tri,
                  m, n_other, n_sph};
  int grid = (n + rt::SPLIT_BLOCK - 1) / rt::SPLIT_BLOCK;
  cudaStream_t st = (cudaStream_t)stream;
#define RT_LAUNCH(TRI, OCC)                                               \
  rt::closest_hit_kernel<TRI, OCC><<<grid, rt::SPLIT_BLOCK, 0, st>>>(      \
      s, o, d, limit, n, t_out, gid_out, stats)
  if (tri_mode == rt::TRI_RAW) {
    if (occlusion) RT_LAUNCH(rt::TRI_RAW, true); else RT_LAUNCH(rt::TRI_RAW, false);
  } else if (tri_mode == rt::TRI_GRAM) {
    if (occlusion) RT_LAUNCH(rt::TRI_GRAM, true); else RT_LAUNCH(rt::TRI_GRAM, false);
  } else if (tri_mode == rt::TRI_MT) {
    if (occlusion) RT_LAUNCH(rt::TRI_MT, true); else RT_LAUNCH(rt::TRI_MT, false);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef RT_LAUNCH
  return (int)cudaGetLastError();
}

int rt_fused(const int* leaf_start, const int* leaf_count, const int* skip,
             const float* nodes, const float* pre, const float* tri, int m,
             int n_other, int n_sph, const float* o, const float* d,
             const float* light, int n, float shadow_eps, float* t_out,
             int* gid_out, unsigned char* sh_out, int tri_mode,
             unsigned long long* stats, void* stream) {
  rt::Tables s = {leaf_start, leaf_count, skip, nodes, pre, tri,
                  m, n_other, n_sph};
  int grid = (n + rt::SPLIT_BLOCK - 1) / rt::SPLIT_BLOCK;
  cudaStream_t st = (cudaStream_t)stream;
#define RT_LAUNCH(TRI)                                                    \
  rt::fused_kernel<TRI><<<grid, rt::SPLIT_BLOCK, 0, st>>>(                 \
      s, o, d, light, n, shadow_eps, t_out, gid_out, sh_out, stats)
  switch (tri_mode) {
    case rt::TRI_RAW: RT_LAUNCH(rt::TRI_RAW); break;
    case rt::TRI_GRAM: RT_LAUNCH(rt::TRI_GRAM); break;
    case rt::TRI_MT: RT_LAUNCH(rt::TRI_MT); break;
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef RT_LAUNCH
  return (int)cudaGetLastError();
}

int rt_closest_attrs(const int* leaf_start, const int* leaf_count,
                     const int* skip, const float* nodes, const float* pre,
                     const float* tri, int m, int n_other, int n_sph,
                     const float* o, const float* d, int n, float* t_out,
                     int* gid_out, float* attrs, int tri_mode,
                     unsigned long long* stats, void* stream) {
  rt::Tables s = {leaf_start, leaf_count, skip, nodes, pre, tri,
                  m, n_other, n_sph};
  int grid = (n + rt::SPLIT_BLOCK - 1) / rt::SPLIT_BLOCK;
  cudaStream_t st = (cudaStream_t)stream;
#define RT_LAUNCH(TRI)                                                    \
  rt::closest_attrs_kernel<TRI><<<grid, rt::SPLIT_BLOCK, 0, st>>>(         \
      s, o, d, n, t_out, gid_out, attrs, stats)
  switch (tri_mode) {
    case rt::TRI_RAW: RT_LAUNCH(rt::TRI_RAW); break;
    case rt::TRI_GRAM: RT_LAUNCH(rt::TRI_GRAM); break;
    case rt::TRI_MT: RT_LAUNCH(rt::TRI_MT); break;
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef RT_LAUNCH
  return (int)cudaGetLastError();
}

int rt_resolve(const float* tab, int n_tab, const float* gid, const float* p,
               int n, float* out, void* stream) {
  int grid = (n + rt::RES_BLOCK - 1) / rt::RES_BLOCK;
  rt::resolve_kernel<<<grid, rt::RES_BLOCK, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(tab), n_tab, gid, p, n, out);
  return (int)cudaGetLastError();
}

// max_t null: packet_kernel (t_out, row_out); else occlusion_kernel
// (occ_out). stats: 5 counts.
int rt_packet(const int* leaf_start, const int* leaf_count, const int* skip,
              const float* nodes, const float* rows, int m, const float* o,
              const float* d, const float* max_t, int n, float* t_out,
              int* row_out, unsigned char* occ_out, int use_mt, int t_cull,
              unsigned long long* stats, void* stream) {
  rt::Tree s = {leaf_start, leaf_count, skip, nodes, rows, m};
  int grid = (n + rt::PK_BLOCK - 1) / rt::PK_BLOCK;
  cudaStream_t st = (cudaStream_t)stream;
#define RT_LAUNCH(MT, CULL)                                               \
  do {                                                                    \
    if (max_t == nullptr)                                                 \
      rt::packet_kernel<MT, CULL><<<grid, rt::PK_BLOCK, 0, st>>>(         \
          s, o, d, n, t_out, row_out, stats);                             \
    else                                                                  \
      rt::occlusion_kernel<MT, CULL><<<grid, rt::PK_BLOCK, 0, st>>>(      \
          s, o, d, max_t, n, occ_out, stats);                             \
  } while (0)
  if (use_mt) {
    if (t_cull) RT_LAUNCH(true, true); else RT_LAUNCH(true, false);
  } else {
    if (t_cull) RT_LAUNCH(false, true); else RT_LAUNCH(false, false);
  }
#undef RT_LAUNCH
  return (int)cudaGetLastError();
}

// runs: the run table of rows (render/brute.py::box_runs), n_runs < 2^24.
int rt_brute(const float* rows, const float* runs, int n_runs, int n_sph,
             int n_pl, int n_wall, const float* o, const float* d, int n,
             float* t_out, int* row_out, int use_mt, int gate,
             unsigned long long* stats, void* stream) {
  rt::Runs s = {rows, runs, n_runs, rt::RUN_CHUNK,
                {n_sph, n_sph + n_pl, n_sph + n_pl + n_wall}};
  int grid = (n + rt::BR_BLOCK - 1) / rt::BR_BLOCK;
  cudaStream_t st = (cudaStream_t)stream;
#define RT_LAUNCH(MT, GATE)                                               \
  rt::brute_kernel<MT, GATE><<<grid, rt::BR_BLOCK, 0, st>>>(              \
      s, o, d, n, t_out, row_out, stats)
  if (use_mt) {
    if (gate) RT_LAUNCH(true, true); else RT_LAUNCH(true, false);
  } else {
    if (gate) RT_LAUNCH(false, true); else RT_LAUNCH(false, false);
  }
#undef RT_LAUNCH
  return (int)cudaGetLastError();
}

// out: (w, n) f32. grads: w column pointers (null: no gradient) and their
// strides in elements, host arrays read before the launch. w: 15 or 24
// (ATTR_W, PACK_WIDTH).
int rt_gather_rows(const float* tab, int n_tab, int w, const int* sid, int n,
                   float* out, void* stream) {
  int grid = (n + rt::GR_BLOCK - 1) / rt::GR_BLOCK;
  cudaStream_t st = (cudaStream_t)stream;
  if (w == 15)
    rt::gather_rows_kernel<15><<<grid, rt::GR_BLOCK, 0, st>>>(tab, n_tab, sid,
                                                              n, out);
  else if (w == 24)
    rt::gather_rows_kernel<24><<<grid, rt::GR_BLOCK, 0, st>>>(tab, n_tab, sid,
                                                              n, out);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

int rt_row_grads(const float* const* grads, const long long* strides, int w,
                 const int* sid, int n, int n_tab, float* out,
                 unsigned long long* stats, void* stream) {
  rt::ColumnsIn c = {};
  if (w > rt::GR_MAX_W) return (int)cudaErrorInvalidValue;
  for (int k = 0; k < w; ++k) {
    c.ptr[k] = grads[k];
    c.stride[k] = strides[k];
  }
  int grid = (n + rt::GR_BLOCK - 1) / rt::GR_BLOCK;
  cudaStream_t st = (cudaStream_t)stream;
  if (w == 15)
    rt::row_grads_kernel<15><<<grid, rt::GR_BLOCK, 0, st>>>(c, sid, n, n_tab,
                                                            out, stats);
  else if (w == 24)
    rt::row_grads_kernel<24><<<grid, rt::GR_BLOCK, 0, st>>>(c, sid, n, n_tab,
                                                            out, stats);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
