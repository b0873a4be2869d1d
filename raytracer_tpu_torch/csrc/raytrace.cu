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
// closest_hit_kernel replaces raytracer_tpu/render/pallas_split.py::
//   _split_kernel / _split_body (961-964, 343-651): one thread per ray,
//   closest hit (t, gid) or occlusion against a per-ray limit.
// fused_kernel replaces pallas_split.py::_fused_kernel (905-958): one
//   thread per ray, the closest hit with normals and then the shadow walk
//   toward the light, so a bounce of the per-bounce route is one launch.
// closest_attrs_kernel replaces pallas_split.py::_split_kernel_attrs
//   (967-975): one thread per ray, the closest hit (t, gid) with the 11
//   shading attributes of the winning shape (normal, colour, ka, kd, ks,
//   kf, shininess). The walk keeps the winner's row, whose material
//   columns are read once after it (the TPU kernel carries 11 values
//   through its loop); misses and parked rays give zero attributes.
// resolve_kernel replaces pallas_split.py::_resolve_kernel (978-1033): one
//   thread per ray gathers its row of the attribute table (the TPU's loop
//   over a tile's distinct ids is a per-lane gather here).
// packet_kernel and occlusion_kernel replace raytracer_tpu/render/
//   pallas_bvh.py::_packet_kernel (169-265, with _row_intersect 85-166)
//   and _occlusion_kernel (268-355): one thread per ray walks the
//   reference median tree alone (the TPU walks a packet and descends
//   where any lane probes), with the leaf-box gate implied by entering
//   only the leaves its own ray hits and t-culling on the nodes flagged
//   cullable; occlusion_kernel returns at the first inner hit below max_t.
// brute_kernel replaces raytracer_tpu/render/pallas_kernel.py::
//   _closest_hit_kernel (95-243): one thread per ray runs four typed loops
//   over every row in type-sorted order, optionally gated by each row's
//   leaf box. Every thread of a warp reads the same row, so the read-only
//   cache broadcasts it; staging the rows in shared memory is left for
//   later.
//
// What bounds them on this card: the walks are bound by operations, not
// bytes. The tables (0.25 MB for scene 1, 0.85 MB for scene 2) stay in L2
// and L1; a pixel's walks do tens to a hundred pre-pass, node and triangle
// tests of 27-71 f32 operations each (chip_smoke.py counts them). The
// design is the simple one: a per-thread stackless walk, scalar loads
// through the read-only cache, threads of a warp on an 8x4 pixel patch (or
// on neighbours of the sorted stream) so that they walk similar nodes.
// Divergence between the lanes of a warp is what this design leaves on
// the table. resolve_kernel does no walk: it moves 16 bytes in and 44
// bytes out per ray and is bound by bytes. brute_kernel is bound by
// operations too (every ray tests every shape) and has no divergence but
// the typed loops' early outs; packet_kernel's threads diverge most in
// scene 2's leaf of 707 shapes.
//
// Each launcher returns cudaGetLastError() after the launch; the Python
// wrapper raises if it is not 0. Launches go on the caller's stream and
// never synchronise.
#include <cuda_runtime.h>

#include "raytrace.cuh"

namespace rt {

constexpr int TILE_W = 8, TILE_H = 16, BLOCK = TILE_W * TILE_H;

__device__ __forceinline__ void add_stats(unsigned long long* stats,
                                          const Counts& c) {
  if (stats != nullptr) {
    atomicAdd(stats + 0, (unsigned long long)c.pre);
    atomicAdd(stats + 1, (unsigned long long)c.node);
    atomicAdd(stats + 2, (unsigned long long)c.tri);
  }
}

// rays (consume mode): n_rows (6 or 9) rows of n floats, o, d and, with 9
// rows, the entry attenuation (else 1); ret: the rays' image-order pixel
// indices y * W + x. out: (n, 3) colours, in image order in raygen mode
// (n = W * H). state (emit): 9 rows of n floats, o, d, atten.
template <int TRI, bool CONSUME, bool EMIT>
__global__ void __launch_bounds__(BLOCK)
wholeframe_kernel(Tables s, const float* __restrict__ tab,
                  const float* __restrict__ par,
                  const float* __restrict__ rays, int n_rows,
                  const int* __restrict__ ret, int n,
                  float* __restrict__ out, float* __restrict__ state,
                  int W, int H, Shade sh, unsigned long long* stats) {
  Params q = load_params(par);
  State st;
  float bg[3];
  long long i;
  if (CONSUME) {
    i = (long long)blockIdx.x * BLOCK + threadIdx.x;
    if (i >= n) return;
    st.ox = rays[i];
    st.oy = rays[n + i];
    st.oz = rays[2LL * n + i];
    st.dx = rays[3LL * n + i];
    st.dy = rays[4LL * n + i];
    st.dz = rays[5LL * n + i];
    if (n_rows == 9) {
      st.atr = rays[6LL * n + i];
      st.atg = rays[7LL * n + i];
      st.atb = rays[8LL * n + i];
    } else {
      st.atr = 1.0f; st.atg = 1.0f; st.atb = 1.0f;
    }
    background((float)(ret[i] / W) + q.y_off, H, bg);
  } else {
    int x = blockIdx.x * TILE_W + (int)(threadIdx.x % TILE_W);
    int y = blockIdx.y * TILE_H + (int)(threadIdx.x / TILE_W);
    if (x >= W || y >= H) return;
    i = (long long)y * W + x;
    primary_ray(q, x, y, W, H, st, bg);
  }
  Counts c = {0u, 0u, 0u};
  float rgb[3];
  trace_ray<TRI>(s, tab, q, sh, bg, st, c, rgb);
  out[3 * i] = rgb[0];
  out[3 * i + 1] = rgb[1];
  out[3 * i + 2] = rgb[2];
  if (EMIT) {
    const float v[9] = {st.ox, st.oy, st.oz, st.dx, st.dy, st.dz,
                        st.atr, st.atg, st.atb};
    for (int k = 0; k < 9; ++k) state[k * (long long)n + i] = v[k];
  }
  add_stats(stats, c);
}

template <int TRI, bool OCCLUSION>
__global__ void __launch_bounds__(BLOCK)
closest_hit_kernel(Tables s, const float* __restrict__ o,
                   const float* __restrict__ d,
                   const float* __restrict__ limit, int n,
                   float* __restrict__ t_out, int* __restrict__ gid_out,
                   unsigned long long* stats) {
  int i = blockIdx.x * BLOCK + (int)threadIdx.x;
  if (i >= n) return;
  Ray r = make_ray(o[3 * i], o[3 * i + 1], o[3 * i + 2], d[3 * i],
                   d[3 * i + 1], d[3 * i + 2]);
  Counts c = {0u, 0u, 0u};
  if (OCCLUSION) {
    t_out[i] = occluded<TRI>(s, r, limit[i], c) ? 0.0f : INF;
    gid_out[i] = -1;
  } else {
    Hit h = closest_walk<TRI, false>(s, G_GID, T_GID, r, INF, c);
    t_out[i] = h.t;
    gid_out[i] = (int)h.id;
  }
  add_stats(stats, c);
}

template <int TRI>
__global__ void __launch_bounds__(BLOCK)
fused_kernel(Tables s, const float* __restrict__ o,
             const float* __restrict__ d, const float* __restrict__ light,
             int n, float shadow_eps, float* __restrict__ t_out,
             int* __restrict__ gid_out, unsigned char* __restrict__ sh_out,
             unsigned long long* stats) {
  int i = blockIdx.x * BLOCK + (int)threadIdx.x;
  if (i >= n) return;
  Ray r = make_ray(o[3 * i], o[3 * i + 1], o[3 * i + 2], d[3 * i],
                   d[3 * i + 1], d[3 * i + 2]);
  Counts c = {0u, 0u, 0u};
  float t, gid;
  bool in_shadow;
  fused_ray<TRI>(s, r, ld(light), ld(light + 1), ld(light + 2), shadow_eps,
                 c, t, gid, in_shadow);
  t_out[i] = t;
  gid_out[i] = (int)gid;
  sh_out[i] = in_shadow ? 1 : 0;
  add_stats(stats, c);
}

// attrs: 11 rows of n floats (n(3), color(3), ka, kd, ks, kf,
// shininess).
template <int TRI>
__global__ void __launch_bounds__(BLOCK)
closest_attrs_kernel(Tables s, const float* __restrict__ o,
                     const float* __restrict__ d, int n,
                     float* __restrict__ t_out, int* __restrict__ gid_out,
                     float* __restrict__ attrs,
                     unsigned long long* stats) {
  int i = blockIdx.x * BLOCK + (int)threadIdx.x;
  if (i >= n) return;
  Ray r = make_ray(o[3 * i], o[3 * i + 1], o[3 * i + 2], d[3 * i],
                   d[3 * i + 1], d[3 * i + 2]);
  Counts c = {0u, 0u, 0u};
  Hit h = closest_walk<TRI, true, true>(s, G_GID, T_GID, r, INF, c);
  t_out[i] = h.t;
  gid_out[i] = (int)h.id;
  attrs[i] = h.nx;
  attrs[(long long)n + i] = h.ny;
  attrs[2LL * n + i] = h.nz;
  for (int k = 0; k < N_MAT; ++k)
    attrs[(3LL + k) * n + i] = h.mat != nullptr ? ld(h.mat + k) : 0.0f;
  add_stats(stats, c);
}

// out: 11 rows of n floats (n(3), color(3), ka, kd, ks, kf, shininess).
__global__ void __launch_bounds__(BLOCK)
resolve_kernel(const float* __restrict__ tab, int n_tab,
               const float* __restrict__ gid, const float* __restrict__ p,
               int n, float* __restrict__ out) {
  int i = blockIdx.x * BLOCK + (int)threadIdx.x;
  if (i >= n) return;
  float a[11];
  resolve_ray(tab, n_tab, gid[i], p[3 * i], p[3 * i + 1], p[3 * i + 2], a);
  for (int k = 0; k < 11; ++k) out[k * (long long)n + i] = a[k];
}

// o, d: (n, 3). packet_kernel: t and the local row of the closest hit.
template <bool MT, bool CULL>
__global__ void __launch_bounds__(BLOCK)
packet_kernel(Tree s, const float* __restrict__ o,
              const float* __restrict__ d, int n, float* __restrict__ t_out,
              int* __restrict__ row_out, unsigned long long* stats) {
  int i = blockIdx.x * BLOCK + (int)threadIdx.x;
  if (i >= n) return;
  Ray r = make_ray(o[3 * i], o[3 * i + 1], o[3 * i + 2], d[3 * i],
                   d[3 * i + 1], d[3 * i + 2]);
  Counts c = {0u, 0u, 0u};
  float t;
  int row;
  packet_walk<MT, CULL, false>(s, r, INF, c, t, row);
  t_out[i] = t;
  row_out[i] = row;
  add_stats(stats, c);
}

// occlusion_kernel: 1 where some inner hit has t < max_t[i].
template <bool MT, bool CULL>
__global__ void __launch_bounds__(BLOCK)
occlusion_kernel(Tree s, const float* __restrict__ o,
                 const float* __restrict__ d,
                 const float* __restrict__ max_t, int n,
                 unsigned char* __restrict__ occ_out,
                 unsigned long long* stats) {
  int i = blockIdx.x * BLOCK + (int)threadIdx.x;
  if (i >= n) return;
  Ray r = make_ray(o[3 * i], o[3 * i + 1], o[3 * i + 2], d[3 * i],
                   d[3 * i + 1], d[3 * i + 2]);
  Counts c = {0u, 0u, 0u};
  float t;
  int row;
  occ_out[i] = packet_walk<MT, CULL, true>(s, r, max_t[i], c, t, row) ? 1
                                                                      : 0;
  add_stats(stats, c);
}

// rows: (n_sph + n_pl + n_wall + n_tri, ROW_EXT_W) in type-sorted order.
struct TypeCounts {
  int n[4];
};

template <bool MT, bool GATE>
__global__ void __launch_bounds__(BLOCK)
brute_kernel(const float* __restrict__ rows, TypeCounts counts,
             const float* __restrict__ o, const float* __restrict__ d, int n,
             float* __restrict__ t_out, int* __restrict__ row_out) {
  int i = blockIdx.x * BLOCK + (int)threadIdx.x;
  if (i >= n) return;
  Ray r = make_ray(o[3 * i], o[3 * i + 1], o[3 * i + 2], d[3 * i],
                   d[3 * i + 1], d[3 * i + 2]);
  float t;
  int row;
  brute_ray<MT, GATE>(rows, counts.n, r, t, row);
  t_out[i] = t;
  row_out[i] = row;
}

}  // namespace rt

extern "C" {

int rt_wholeframe(const int* leaf_start, const int* leaf_count,
                  const int* skip, const float* nodes, const float* pre,
                  const float* tri, int m, int n_other, int n_sph,
                  const float* tab, const float* par, const float* rays,
                  int n_rows, const int* ret, int n, float* out,
                  float* state, int W, int H, int bounces, float shadow_eps,
                  float reflect_eps, int use_fresnel, int enable_shadows,
                  int tri_mode, unsigned long long* stats, void* stream) {
  rt::Tables s = {leaf_start, leaf_count, skip, nodes, pre, tri,
                  m, n_other, n_sph};
  rt::Shade sh = {bounces, shadow_eps, reflect_eps, use_fresnel != 0,
                  enable_shadows != 0};
  bool consume = rays != nullptr, emit = state != nullptr;
  if (consume && (n_rows != 6 && n_rows != 9)) return (int)cudaErrorInvalidValue;
  dim3 grid = consume ? dim3((n + rt::BLOCK - 1) / rt::BLOCK)
                      : dim3((W + rt::TILE_W - 1) / rt::TILE_W,
                             (H + rt::TILE_H - 1) / rt::TILE_H);
  cudaStream_t st = (cudaStream_t)stream;
#define RT_LAUNCH(TRI, C, E)                                               \
  rt::wholeframe_kernel<TRI, C, E><<<grid, rt::BLOCK, 0, st>>>(             \
      s, tab, par, rays, n_rows, ret, n, out, state, W, H, sh, stats)
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
  int grid = (n + rt::BLOCK - 1) / rt::BLOCK;
  cudaStream_t st = (cudaStream_t)stream;
#define RT_LAUNCH(TRI, OCC)                                               \
  rt::closest_hit_kernel<TRI, OCC><<<grid, rt::BLOCK, 0, st>>>(            \
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
  int grid = (n + rt::BLOCK - 1) / rt::BLOCK;
  cudaStream_t st = (cudaStream_t)stream;
#define RT_LAUNCH(TRI)                                                    \
  rt::fused_kernel<TRI><<<grid, rt::BLOCK, 0, st>>>(                       \
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
  int grid = (n + rt::BLOCK - 1) / rt::BLOCK;
  cudaStream_t st = (cudaStream_t)stream;
#define RT_LAUNCH(TRI)                                                    \
  rt::closest_attrs_kernel<TRI><<<grid, rt::BLOCK, 0, st>>>(               \
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
  int grid = (n + rt::BLOCK - 1) / rt::BLOCK;
  rt::resolve_kernel<<<grid, rt::BLOCK, 0, (cudaStream_t)stream>>>(
      tab, n_tab, gid, p, n, out);
  return (int)cudaGetLastError();
}

// max_t null: packet_kernel (t_out, row_out); else occlusion_kernel
// (occ_out).
int rt_packet(const int* leaf_start, const int* leaf_count, const int* skip,
              const float* nodes, const float* rows, int m, const float* o,
              const float* d, const float* max_t, int n, float* t_out,
              int* row_out, unsigned char* occ_out, int use_mt, int t_cull,
              unsigned long long* stats, void* stream) {
  rt::Tree s = {leaf_start, leaf_count, skip, nodes, rows, m};
  int grid = (n + rt::BLOCK - 1) / rt::BLOCK;
  cudaStream_t st = (cudaStream_t)stream;
#define RT_LAUNCH(MT, CULL)                                               \
  do {                                                                    \
    if (max_t == nullptr)                                                 \
      rt::packet_kernel<MT, CULL><<<grid, rt::BLOCK, 0, st>>>(            \
          s, o, d, n, t_out, row_out, stats);                             \
    else                                                                  \
      rt::occlusion_kernel<MT, CULL><<<grid, rt::BLOCK, 0, st>>>(         \
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

int rt_brute(const float* rows, int n_sph, int n_pl, int n_wall, int n_tri,
             const float* o, const float* d, int n, float* t_out,
             int* row_out, int use_mt, int gate, void* stream) {
  rt::TypeCounts counts = {{n_sph, n_pl, n_wall, n_tri}};
  int grid = (n + rt::BLOCK - 1) / rt::BLOCK;
  cudaStream_t st = (cudaStream_t)stream;
#define RT_LAUNCH(MT, GATE)                                               \
  rt::brute_kernel<MT, GATE><<<grid, rt::BLOCK, 0, st>>>(                 \
      rows, counts, o, d, n, t_out, row_out)
  if (use_mt) {
    if (gate) RT_LAUNCH(true, true); else RT_LAUNCH(true, false);
  } else {
    if (gate) RT_LAUNCH(false, true); else RT_LAUNCH(false, false);
  }
#undef RT_LAUNCH
  return (int)cudaGetLastError();
}

}  // extern "C"
