// The port's two CUDA kernels for Hopper (sm_90a), with a plain C
// interface bound from Python with ctypes (render/kernels.py).
//
// wholeframe_kernel replaces raytracer_tpu/render/wholeframe.py::
//   _wholeframe_kernel (75-385) in raygen mode: one thread per pixel runs
//   the whole Whitted loop, so a frame is one launch.
// closest_hit_kernel replaces raytracer_tpu/render/pallas_split.py::
//   _split_kernel / _split_body (961-964, 343-651): one thread per ray,
//   closest hit (t, gid) or occlusion against a per-ray limit.
//
// What bounds them on this card: operations, not bytes. The tables
// (0.25 MB for scene 1, 0.85 MB for scene 2) stay in L2 and L1; a pixel's
// walks do tens to a hundred pre-pass, node and triangle tests of 27-71
// f32 operations each (chip_smoke.py counts them). The design is the
// simple one: a per-thread stackless walk, scalar loads through the
// read-only cache, threads of a warp on an 8x4 pixel patch so that they
// walk similar nodes. Divergence between the lanes of a warp is what this
// design leaves on the table.
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

template <int TRI>
__global__ void __launch_bounds__(BLOCK)
wholeframe_kernel(Tables s, const float* __restrict__ tab,
                  const float* __restrict__ par, float* __restrict__ out,
                  int W, int H, Shade sh, unsigned long long* stats) {
  int x = blockIdx.x * TILE_W + (int)(threadIdx.x % TILE_W);
  int y = blockIdx.y * TILE_H + (int)(threadIdx.x / TILE_W);
  if (x >= W || y >= H) return;
  Params q = load_params(par);
  Counts c = {0u, 0u, 0u};
  float rgb[3];
  trace_pixel<TRI>(s, tab, q, sh, x, y, W, H, c, rgb);
  float* o = out + ((long long)y * W + x) * 3;
  o[0] = rgb[0];
  o[1] = rgb[1];
  o[2] = rgb[2];
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

}  // namespace rt

extern "C" {

int rt_wholeframe(const int* leaf_start, const int* leaf_count,
                  const int* skip, const float* nodes, const float* pre,
                  const float* tri, int m, int n_other, int n_sph,
                  const float* tab, const float* par, float* out, int W,
                  int H, int bounces, float shadow_eps, float reflect_eps,
                  int use_fresnel, int enable_shadows, int tri_mode,
                  unsigned long long* stats, void* stream) {
  rt::Tables s = {leaf_start, leaf_count, skip, nodes, pre, tri,
                  m, n_other, n_sph};
  rt::Shade sh = {bounces, shadow_eps, reflect_eps, use_fresnel != 0,
                  enable_shadows != 0};
  dim3 grid((W + rt::TILE_W - 1) / rt::TILE_W,
            (H + rt::TILE_H - 1) / rt::TILE_H);
  cudaStream_t st = (cudaStream_t)stream;
  switch (tri_mode) {
    case rt::TRI_RAW:
      rt::wholeframe_kernel<rt::TRI_RAW><<<grid, rt::BLOCK, 0, st>>>(
          s, tab, par, out, W, H, sh, stats);
      break;
    case rt::TRI_GRAM:
      rt::wholeframe_kernel<rt::TRI_GRAM><<<grid, rt::BLOCK, 0, st>>>(
          s, tab, par, out, W, H, sh, stats);
      break;
    case rt::TRI_MT:
      rt::wholeframe_kernel<rt::TRI_MT><<<grid, rt::BLOCK, 0, st>>>(
          s, tab, par, out, W, H, sh, stats);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
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

}  // extern "C"
