// Per-ray device code shared by the kernels in raytrace.cu.
//
// Replaces the traversal that the JAX package's TPU kernels inline:
// raytracer_tpu/render/pallas_split.py::_closest_pass (654-902) and its
// helpers _pre_sphere (170), _pre_planewall (196), _leafbox_gate (152),
// _tri_test (224) and _reduce_candidates (326); the bounce loop of
// raytracer_tpu/render/wholeframe.py::_wholeframe_kernel (75-385) in its
// raygen, emit_state and consume_state modes; the per-lane bodies of
// pallas_split.py::_fused_kernel (905-958), _split_kernel_attrs (967-975)
// and _resolve_kernel (978-1033);
// raytracer_tpu/render/pallas_bvh.py::_packet_kernel (169) with
// _row_intersect (85) and _occlusion_kernel (268); and
// raytracer_tpu/render/pallas_kernel.py::_closest_hit_kernel (95).
//
// The spec is the per-ray result, not the TPU's packet mechanics: a lane's
// hit never depends on which other rays share its packet, so each thread
// walks the skip-pointer tree alone (closest_walk, occluded, packet_walk,
// trace_ray, fused_ray: the per-lane references of tools/host_check.py),
// or a warp walks it in lockstep (warp_walk, split_walk, warp_trace,
// warp_fused, brute_walk: the kernels' walks) while each lane still
// evaluates exactly its own walk's nodes and rows. Every arithmetic
// expression keeps the JAX kernel's order of operations; build with
// -fmad=false so that no multiply-add is contracted and edge accepts stay
// in step with the plain PyTorch versions. min/max propagate NaN like jnp.minimum/jnp.maximum
// (the slab test relies on IEEE 1/0 = inf and on NaN failing compares).
#pragma once

namespace rt {

constexpr float INF = 1e30f;
constexpr float PARK_ORIGIN = 2e30f;
constexpr float PARK_DIR = 0.5773502691896258f;
constexpr float SHADOW_FACTOR = 0.3f;
// background mix(dark, sky, y/H) as the JAX kernel folds it: dark + (sky - dark) * f
constexpr float BG_DARK_R = 0.05f, BG_DARK_G = 0.07f, BG_DARK_B = 0.1f;
constexpr float BG_SPAN_R = (float)(0.5 - 0.05);
constexpr float BG_SPAN_G = (float)(0.7 - 0.07);
constexpr float BG_SPAN_B = (float)(1.0 - 0.1);

// Row layouts (render/split_scene.py).
constexpr int PRE_W = 40, TRI_W = 36, NODE_W = 8, ATTR_W = 15;
// resolve_kernel's copy of the attribute table: a zero column makes a
// row 64 bytes, four aligned 16-byte loads (render/split.py).
constexpr int ATTR_PAD_W = 16;
constexpr int G_GID = 24, G_B0X = 25, G_MCR = 31, G_RID = 39;
constexpr int T_NX = 0, T_PD = 3, T_E1X = 4, T_E2X = 7, T_P1X = 10;
constexpr int T_S0 = 13, T_S1 = 14, T_R11 = 15, T_R01 = 16, T_R00 = 17;
constexpr int T_GID = 18, T_MCR = 19, T_RID = 27, T_EVX = 28, T_CV = 31,
              T_EWX = 32, T_CW = 35;
// Both row layouts carry a shape's material as 8 consecutive columns
// from *_MCR: colour rgb, ka, kd, ks, kf, shininess.
constexpr int N_MAT = 8;
// Triangle tests (config.py TRI_*).
constexpr int TRI_RAW = 0, TRI_GRAM = 1, TRI_MT = 2;
// Packed shape rows (geom/rowwise.py): 24 columns; the brute-force
// renderer's rows add the shape's leaf box in columns 24-29
// (render/brute.py). Shape types (core/scene.py).
constexpr int ROW_W = 24, ROW_EXT_W = 30, R_B0X = 24;
constexpr int SPHERE = 0, PLANE = 1, WALL = 2, TRIANGLE = 3;

struct Tables {
  const int* leaf_start;   // (m,)
  const int* leaf_count;   // (m,) 0 for internal nodes
  const int* skip;         // (m,)
  const float* nodes;      // (m, NODE_W): box min xyz, max xyz
  const float* pre;        // (n_other, PRE_W): spheres first
  const float* tri;        // (n_tri, TRI_W) in DFS-leaf order
  int m, n_other, n_sph;
};

// Tests run by one thread, summed into the kernel's optional stats buffer.
struct Counts {
  unsigned pre, node, tri;
};

// mat: the winning row's material columns (MAT walks only; null on a
// miss).
struct Hit {
  float t, id, nx, ny, nz;
  const float* mat;
};

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ int ldi(const int* p) { return __ldg(p); }

// Where the row tests read their operands from: Ldg (global memory through
// the read-only cache, the default) or Plain (shared memory or registers:
// packet_kernel's staged leaf rows and node boxes).
struct Ldg {
  __device__ static __forceinline__ float f(const float* p) { return __ldg(p); }
};
struct Plain {
  __device__ static __forceinline__ float f(const float* p) { return *p; }
};

// jnp.minimum / jnp.maximum: NaN in either operand gives NaN.
__device__ __forceinline__ float jmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float jmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

struct Ray {
  float ox, oy, oz, dx, dy, dz;
  float ix, iy, iz, aa;   // 1/d per axis and d.d
};

__device__ __forceinline__ Ray make_ray(float ox, float oy, float oz,
                                        float dx, float dy, float dz) {
  Ray r;
  r.ox = ox; r.oy = oy; r.oz = oz; r.dx = dx; r.dy = dy; r.dz = dz;
  r.aa = dx * dx + dy * dy + dz * dz;
  r.ix = 1.0f / dx;
  r.iy = 1.0f / dy;
  r.iz = 1.0f / dz;
  return r;
}

// Slab test of the box b[0..5] = (min xyz, max xyz).
template <class L = Ldg>
__device__ __forceinline__ void slab(const float* b, const Ray& r,
                                     float& tmin, float& tmax) {
  float tx0 = (L::f(b + 0) - r.ox) * r.ix;
  float tx1 = (L::f(b + 3) - r.ox) * r.ix;
  float ty0 = (L::f(b + 1) - r.oy) * r.iy;
  float ty1 = (L::f(b + 4) - r.oy) * r.iy;
  float tz0 = (L::f(b + 2) - r.oz) * r.iz;
  float tz1 = (L::f(b + 5) - r.oz) * r.iz;
  tmin = jmax(jmax(jmin(tx0, tx1), jmin(ty0, ty1)), jmin(tz0, tz1));
  tmax = jmin(jmin(jmax(tx0, tx1), jmax(ty0, ty1)), jmax(tz0, tz1));
}

// _pre_sphere: strict D > 0, inner hits only; no box gate (a sphere lies
// inside every box its row carries).
template <class L = Ldg>
__device__ __forceinline__ bool pre_sphere(const float* p, const Ray& r,
                                           float& t) {
  float ocx = r.ox - L::f(p + 1);
  float ocy = r.oy - L::f(p + 2);
  float ocz = r.oz - L::f(p + 3);
  float rad = L::f(p + 4);
  float bb = 2.0f * (r.dx * ocx + r.dy * ocy + r.dz * ocz);
  float cc = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad;
  float disc = bb * bb - 4.0f * r.aa * cc;
  float sq = sqrtf(disc > 0.0f ? disc : 1.0f);
  t = (-bb - sq) / (2.0f * r.aa);
  return (disc > 0.0f) && (t > 0.0f);
}

// The tests below read rows whose columns keep one relative layout: a
// plane normal n at n[0..2] with its offset at n[3]; and e1 = e[0..2], e2 =
// e[3..5], p1 = e[6..8], s0 = e[9], s1 = e[10], then a wall's width and
// height or a triangle's r11, r01, r00 at e[11..13]. In the packed rows
// (geom/rowwise.py) and the pre-pass rows n = p + 5, e = p + 9; in the
// triangle rows n = p + T_NX, e = p + T_E1X.

// The plane family: t and the inner test (back-face n.d > 0, t > 0), and
// the hit point o + tw * d with tw = t where inner, else 0.
template <class L = Ldg>
__device__ __forceinline__ bool plane_hit(const float* n, const Ray& r,
                                          float& t, float& hx, float& hy,
                                          float& hz) {
  float nx = L::f(n), ny = L::f(n + 1), nz = L::f(n + 2);
  float d_n = r.dx * nx + r.dy * ny + r.dz * nz;
  float o_n = r.ox * nx + r.oy * ny + r.oz * nz;
  t = -(L::f(n + 3) + o_n) / (d_n == 0.0f ? 1.0f : d_n);
  bool inner = (d_n > 0.0f) && (t > 0.0f);
  float tw = inner ? t : 0.0f;
  hx = r.ox + tw * r.dx;
  hy = r.oy + tw * r.dy;
  hz = r.oz + tw * r.dz;
  return inner;
}

// (h.e1 - s0, h.e2 - s1): a wall's (u, v), a barycentric triangle's
// (d20, d21).
template <class L = Ldg>
__device__ __forceinline__ void project(const float* e, float hx, float hy,
                                        float hz, float& a, float& b) {
  a = hx * L::f(e) + hy * L::f(e + 1) + hz * L::f(e + 2) - L::f(e + 9);
  b = hx * L::f(e + 3) + hy * L::f(e + 4) + hz * L::f(e + 5) - L::f(e + 10);
}

// A wall keeps a plane hit inside its width x height rectangle; a
// degenerate basis (flag at e[14]) makes it an infinite plane.
template <class L = Ldg>
__device__ __forceinline__ bool wall_inside(const float* e, float hx,
                                            float hy, float hz) {
  float u, v;
  project<L>(e, hx, hy, hz, u, v);
  bool outside = (u < 0.0f) || (u > L::f(e + 11)) || (v < 0.0f) ||
                 (v > L::f(e + 12));
  return (L::f(e + 14) > 0.0f) || !outside;
}

// The barycentric test of a plane hit with the premultiplied ratios; a
// degenerate triangle packs zeros and is always inside.
template <class L = Ldg>
__device__ __forceinline__ bool bary_inside(const float* e, float hx,
                                            float hy, float hz) {
  float d20, d21;
  project<L>(e, hx, hy, hz, d20, d21);
  float v = L::f(e + 11) * d20 - L::f(e + 12) * d21;
  float w = L::f(e + 13) * d21 - L::f(e + 12) * d20;
  float u = 1.0f - v - w;
  return !((u < 0.0f) || (v < 0.0f) || (w < 0.0f));
}

// Moller-Trumbore (double-sided), with its own t.
template <class L = Ldg>
__device__ __forceinline__ bool mt_test(const float* e, const Ray& r,
                                        float& t) {
  float e1x = L::f(e), e1y = L::f(e + 1), e1z = L::f(e + 2);
  float e2x = L::f(e + 3), e2y = L::f(e + 4), e2z = L::f(e + 5);
  float hcx = r.dy * e2z - r.dz * e2y;
  float hcy = r.dz * e2x - r.dx * e2z;
  float hcz = r.dx * e2y - r.dy * e2x;
  float a = e1x * hcx + e1y * hcy + e1z * hcz;
  bool ok = fabsf(a) >= 1e-5f;
  float f = 1.0f / (ok ? a : 1.0f);
  float smx = r.ox - L::f(e + 6);
  float smy = r.oy - L::f(e + 7);
  float smz = r.oz - L::f(e + 8);
  float u = f * (smx * hcx + smy * hcy + smz * hcz);
  ok = ok && (u >= 0.0f) && (u <= 1.0f);
  float qx = smy * e1z - smz * e1y;
  float qy = smz * e1x - smx * e1z;
  float qz = smx * e1y - smy * e1x;
  float v = f * (r.dx * qx + r.dy * qy + r.dz * qz);
  ok = ok && (v >= 0.0f) && (u + v <= 1.0f);
  t = f * (e2x * qx + e2y * qy + e2z * qz);
  return ok && (t > 0.0f);
}

// A box gate (gpu_shader.comp:364-377): the ray hits the box b[0..5].
__device__ __forceinline__ bool box_gate(const float* b, const Ray& r) {
  float tmin, tmax;
  slab(b, r, tmin, tmax);
  return (tmax >= tmin) && (tmax > 0.0f);
}

// _pre_planewall + _leafbox_gate: a plane or wall, gated by its reference
// leaf box.
__device__ __forceinline__ bool pre_planewall(const float* p, const Ray& r,
                                              float& t) {
  float hx, hy, hz;
  return plane_hit(p + 5, r, t, hx, hy, hz) &&
         wall_inside(p + 9, hx, hy, hz) && box_gate(p + G_B0X, r);
}

// _tri_test: raw barycentric, Gram-fused barycentric or Moller-Trumbore.
template <int TRI>
__device__ __forceinline__ bool tri_test(const float* p, const Ray& r,
                                         float& t) {
  if (TRI == TRI_MT) return mt_test(p + T_E1X, r, t);
  float hx, hy, hz;
  bool inner = plane_hit(p + T_NX, r, t, hx, hy, hz);
  if (TRI == TRI_GRAM) {
    float evx = ld(p + T_EVX), evy = ld(p + T_EVX + 1), evz = ld(p + T_EVX + 2);
    float ewx = ld(p + T_EWX), ewy = ld(p + T_EWX + 1), ewz = ld(p + T_EWX + 2);
    float d_ev = r.dx * evx + r.dy * evy + r.dz * evz;
    float o_ev = r.ox * evx + r.oy * evy + r.oz * evz - ld(p + T_CV);
    float v = o_ev + t * d_ev;
    float d_ew = r.dx * ewx + r.dy * ewy + r.dz * ewz;
    float o_ew = r.ox * ewx + r.oy * ewy + r.oz * ewz - ld(p + T_CW);
    float w = o_ew + t * d_ew;
    return inner && (v >= 0.0f) && (w >= 0.0f) && ((v + w) <= 1.0f);
  }
  return inner && bary_inside(p + T_E1X, hx, hy, hz);
}

// _closest_pass for one ray: the pre-pass over the n_other rows (the
// earliest row wins exact ties), then the skip-pointer walk over the
// triangle tree (probe tmin <= t_best, update on strict t < t_best).
// t_init = limit makes it the shadow walk: in_shadow = t < limit.
// pre_col / tri_col pick the id column (G_GID/T_GID, or the canonical
// resolve id G_RID/T_RID). MAT also keeps a pointer to the winner's
// material columns (_split_kernel_attrs): the earliest row wins exact
// ties, as for the id, so one pointer replaces the JAX kernel's 8 carried
// values.
template <int TRI, bool NORMALS, bool MAT = false>
__device__ Hit closest_walk(const Tables& s, int pre_col, int tri_col,
                            const Ray& r, float t_init, Counts& c) {
  Hit h;
  h.t = t_init; h.id = -1.0f; h.nx = 0.0f; h.ny = 0.0f; h.nz = 0.0f;
  h.mat = nullptr;
  if (!(r.ox < 1e30f)) return h;   // parked lane: the miss result

  float best = INF;
  int bi = -1;
  for (int i = 0; i < s.n_other; ++i) {
    const float* p = s.pre + i * PRE_W;
    float t;
    bool inner = i < s.n_sph ? pre_sphere(p, r, t) : pre_planewall(p, r, t);
    float cand = inner ? t : INF;
    if (cand < best) { best = cand; bi = i; }
  }
  c.pre += s.n_other;
  if (best < h.t) {
    const float* p = s.pre + bi * PRE_W;
    h.t = best;
    h.id = ld(p + pre_col);
    if (MAT) h.mat = p + G_MCR;
    if (NORMALS) {
      if (bi < s.n_sph) {
        float px = r.ox + best * r.dx - ld(p + 1);
        float py = r.oy + best * r.dy - ld(p + 2);
        float pz = r.oz + best * r.dz - ld(p + 3);
        float inv = 1.0f / sqrtf(px * px + py * py + pz * pz + 1e-30f);
        h.nx = px * inv; h.ny = py * inv; h.nz = pz * inv;
      } else {
        h.nx = ld(p + 5); h.ny = ld(p + 6); h.nz = ld(p + 7);
      }
    }
  }

  int ptr = 0;
  while (ptr < s.m) {
    float tmin, tmax;
    slab(s.nodes + ptr * NODE_W, r, tmin, tmax);
    c.node += 1;
    bool probe = (tmax >= tmin) && (tmax > 0.0f) && (tmin <= h.t);
    int cnt = ldi(s.leaf_count + ptr);
    if (probe && cnt > 0) {
      const float* p = s.tri + ldi(s.leaf_start + ptr) * TRI_W;
      for (int j = 0; j < cnt; ++j, p += TRI_W) {
        float t;
        bool inner = tri_test<TRI>(p, r, t);
        if (inner && t < h.t) {
          h.t = t;
          h.id = ld(p + tri_col);
          if (MAT) h.mat = p + T_MCR;
          if (NORMALS) {
            h.nx = ld(p + T_NX); h.ny = ld(p + T_NX + 1); h.nz = ld(p + T_NX + 2);
          }
        }
      }
      c.tri += cnt;
      ptr = ldi(s.skip + ptr);
    } else if (probe) {
      ptr += 1;
    } else {
      ptr = ldi(s.skip + ptr);
    }
  }
  return h;
}

// _split_body's occlusion mode for one ray: occluded iff some inner hit
// has t < limit. Subtrees whose entry lies beyond the limit are skipped.
template <int TRI>
__device__ bool occluded(const Tables& s, const Ray& r, float limit,
                         Counts& c) {
  if (!(r.ox < 1e30f)) return false;
  for (int i = 0; i < s.n_other; ++i) {
    const float* p = s.pre + i * PRE_W;
    float t;
    bool inner = i < s.n_sph ? pre_sphere(p, r, t) : pre_planewall(p, r, t);
    c.pre += 1;
    if (inner && t < limit) return true;
  }
  int ptr = 0;
  while (ptr < s.m) {
    float tmin, tmax;
    slab(s.nodes + ptr * NODE_W, r, tmin, tmax);
    c.node += 1;
    bool probe = (tmax >= tmin) && (tmax > 0.0f) && (tmin <= limit);
    int cnt = ldi(s.leaf_count + ptr);
    if (probe && cnt > 0) {
      const float* p = s.tri + ldi(s.leaf_start + ptr) * TRI_W;
      for (int j = 0; j < cnt; ++j, p += TRI_W) {
        float t;
        bool inner = tri_test<TRI>(p, r, t);
        c.tri += 1;
        if (inner && t < limit) return true;
      }
      ptr = ldi(s.skip + ptr);
    } else if (probe) {
      ptr += 1;
    } else {
      ptr = ldi(s.skip + ptr);
    }
  }
  return false;
}


// The frame's scalars are the JAX kernel's par row: light pos(3) +
// color(3), camera pos/front/right/up (12), half_w, half_h, pixel-row
// offset of the window. Params holds the camera's, for the primary rays;
// the light's are read from the row where they are used (load_light), so
// that no register holds them across the walks.
struct Params {
  float cpx, cpy, cpz, fx, fy, fz, rx, ry, rz, ux, uy, uz;
  float half_w, half_h, y_off;
};

__device__ __forceinline__ Params load_params(const float* par) {
  Params q;
  q.cpx = ld(par + 6); q.cpy = ld(par + 7); q.cpz = ld(par + 8);
  q.fx = ld(par + 9); q.fy = ld(par + 10); q.fz = ld(par + 11);
  q.rx = ld(par + 12); q.ry = ld(par + 13); q.rz = ld(par + 14);
  q.ux = ld(par + 15); q.uy = ld(par + 16); q.uz = ld(par + 17);
  q.half_w = ld(par + 18); q.half_h = ld(par + 19); q.y_off = ld(par + 20);
  return q;
}

struct Light {
  float x, y, z, r, g, b;
};

__device__ __forceinline__ Light load_light(const float* par) {
  Light lt;
  lt.x = ld(par + 0); lt.y = ld(par + 1); lt.z = ld(par + 2);
  lt.r = ld(par + 3); lt.g = ld(par + 4); lt.b = ld(par + 5);
  return lt;
}

struct Shade {
  int bounces;
  float shadow_eps, reflect_eps;
  bool use_fresnel, enable_shadows;
};

// A ray's continuation state: origin, direction, attenuation.
struct State {
  float ox, oy, oz, dx, dy, dz, atr, atg, atb;
};

// Background mix(dark, sky, y/H) of image row yi (the raygen branch's
// arithmetic; the consume branch derives yi from the pixel index): f_bg =
// yi / H, then bg = dark + (sky - dark) * f_bg where a ray misses.
__device__ __forceinline__ void background(float f_bg, float* bg) {
  bg[0] = BG_DARK_R + BG_SPAN_R * f_bg;
  bg[1] = BG_DARK_G + BG_SPAN_G * f_bg;
  bg[2] = BG_DARK_B + BG_SPAN_B * f_bg;
}

// Raygen: the primary ray and background fraction f_bg of pixel (x, y)
// from the camera scalars (core/camera.get_rays + pixel_ndc, term by
// term).
__device__ __forceinline__ void primary_ray(const Params& q, int x, int y,
                                            int W, int H, State& st,
                                            float& f_bg) {
  float xi = (float)x;
  float yi = (float)y + q.y_off;
  float ndc_x = 2.0f * xi / (float)W - 1.0f;
  float ndc_y = 1.0f - 2.0f * yi / (float)H;
  float vx = (q.cpx + q.fx + ndc_x * q.half_w * q.rx + ndc_y * q.half_h * q.ux) - q.cpx;
  float vy = (q.cpy + q.fy + ndc_x * q.half_w * q.ry + ndc_y * q.half_h * q.uy) - q.cpy;
  float vz = (q.cpz + q.fz + ndc_x * q.half_w * q.rz + ndc_y * q.half_h * q.uz) - q.cpz;
  float nrm = sqrtf(vx * vx + vy * vy + vz * vz);
  st.ox = q.cpx; st.oy = q.cpy; st.oz = q.cpz;
  st.dx = vx / nrm; st.dy = vy / nrm; st.dz = vz / nrm;
  st.atr = 1.0f; st.atg = 1.0f; st.atb = 1.0f;
  f_bg = yi / (float)H;
}

// The shadow ray of a hit at t along st's ray with normal n: from p + n *
// shadow_eps toward the light, normalised with eps 1e-30; dist receives
// the light's distance from p = o + t * d.
__device__ __forceinline__ Ray shadow_ray(const float* par, const Shade& sh,
                                          const State& st, float t, float nx,
                                          float ny, float nz, float& dist) {
  Light lt = load_light(par);
  float px = st.ox + t * st.dx;
  float py = st.oy + t * st.dy;
  float pz = st.oz + t * st.dz;
  float ldx = lt.x - px;
  float ldy = lt.y - py;
  float ldz = lt.z - pz;
  dist = sqrtf(ldx * ldx + ldy * ldy + ldz * ldz);
  float inv = 1.0f / jmax(dist, 1e-30f);
  return make_ray(px + nx * sh.shadow_eps, py + ny * sh.shadow_eps,
                  pz + nz * sh.shadow_eps, ldx * inv, ldy * inv, ldz * inv);
}

// One hit's shading (the bounce loop of _wholeframe_kernel after its
// walks): the material gather attr_tab[id], Phong with 1/d attenuation and
// x0.3 shadows added to rgb from the attenuation st.at*, then the
// reflection from p + n * reflect_eps into st (with Fresnel, the new
// attenuation and the reference's unattenuated extra term). Returns false
// where the ray ends (ks <= 0); st then keeps its ray.
__device__ __forceinline__ bool shade_hit(const float* tab, const float* par,
                                          const Shade& sh, float id, float t,
                                          float nx, float ny, float nz,
                                          bool in_shadow, State& st,
                                          float* rgb) {
  Light lt = load_light(par);
  float px = st.ox + t * st.dx;
  float py = st.oy + t * st.dy;
  float pz = st.oz + t * st.dz;
  float ldx = lt.x - px;
  float ldy = lt.y - py;
  float ldz = lt.z - pz;
  const float* mat = tab + (int)id * ATTR_W;
  float mcr = ld(mat + 3), mcg = ld(mat + 4), mcb = ld(mat + 5);
  float ka = ld(mat + 6), kd = ld(mat + 7), ks = ld(mat + 8);
  float kf = ld(mat + 9), shin = ld(mat + 10);

  float dist_p = sqrtf(jmax(ldx * ldx + ldy * ldy + ldz * ldz, 1e-30f));
  float lc_r = lt.r / dist_p;
  float lc_g = lt.g / dist_p;
  float lc_b = lt.b / dist_p;
  float ldnx = ldx / dist_p;
  float ldny = ldy / dist_p;
  float ldnz = ldz / dist_p;
  float diff = jmax(nx * ldnx + ny * ldny + nz * ldnz, 0.0f);
  float dotln = nx * ldnx + ny * ldny + nz * ldnz;
  float rdx = -ldnx + 2.0f * dotln * nx;
  float rdy = -ldny + 2.0f * dotln * ny;
  float rdz = -ldnz + 2.0f * dotln * nz;
  float spec_cos = jmax(st.dx * rdx + st.dy * rdy + st.dz * rdz, 0.0f);
  float spec = powf(spec_cos, shin);
  float specc = diff > 0.0f ? ks * spec : 0.0f;
  float col_r = (ka * lc_r + (kd * diff) * lc_r + specc * lc_r) * mcr;
  float col_g = (ka * lc_g + (kd * diff) * lc_g + specc * lc_g) * mcg;
  float col_b = (ka * lc_b + (kd * diff) * lc_b + specc * lc_b) * mcb;
  if (in_shadow) {
    col_r = col_r * SHADOW_FACTOR;
    col_g = col_g * SHADOW_FACTOR;
    col_b = col_b * SHADOW_FACTOR;
  }
  rgb[0] = rgb[0] + st.atr * col_r;
  rgb[1] = rgb[1] + st.atg * col_g;
  rgb[2] = rgb[2] + st.atb * col_b;

  if (!(ks > 0.0f)) return false;   // no reflection: the ray ends
  float dotdn = nx * st.dx + ny * st.dy + nz * st.dz;
  float ndx = st.dx - 2.0f * dotdn * nx;
  float ndy = st.dy - 2.0f * dotdn * ny;
  float ndz = st.dz - 2.0f * dotdn * nz;
  if (sh.use_fresnel) {
    float cosr = jmax(-(ndx * nx + ndy * ny + ndz * nz), 0.0f);
    float x1 = 1.0f - cosr;
    float x2 = x1 * x1;
    float x5 = x1 * (x2 * x2);   // lax.integer_pow(x, 5)
    float f = jmin(jmax(x5, 0.0f), 0.8f);
    float w = kf * f;
    float natr = st.atr * (mcr + (1.0f - mcr) * w);
    float natg = st.atg * (mcg + (1.0f - mcg) * w);
    float natb = st.atb * (mcb + (1.0f - mcb) * w);
    // the extra term is NOT attenuated (reference double-count)
    rgb[0] = rgb[0] + (1.0f - w) * mcr * col_r;
    rgb[1] = rgb[1] + (1.0f - w) * mcg * col_g;
    rgb[2] = rgb[2] + (1.0f - w) * mcb * col_b;
    st.atr = natr; st.atg = natg; st.atb = natb;
  } else {
    st.atr = st.atr * ks; st.atg = st.atg * ks; st.atb = st.atb * ks;
  }
  st.ox = px + nx * sh.reflect_eps;
  st.oy = py + ny * sh.reflect_eps;
  st.oz = pz + nz * sh.reflect_eps;
  st.dx = ndx; st.dy = ndy; st.dz = ndz;
  return true;
}

__device__ __forceinline__ void park(State& st) {
  st.ox = PARK_ORIGIN; st.oy = PARK_ORIGIN; st.oz = PARK_ORIGIN;
  st.dx = PARK_DIR; st.dy = PARK_DIR; st.dz = PARK_DIR;
}

// One ray's Whitted trace over sh.bounces bounces (the bounce loop of
// _wholeframe_kernel), per thread: per bounce a closest walk with normals
// (tests in c), a shadow walk toward the light (tests in cs), then
// shade_hit. rgb receives the colour added from the entry attenuation
// st.at*; a miss adds the background (of fraction f_bg) and ends the ray.
// A ray parked on
// entry (ox >= 1e30) is dead and adds nothing. On return st is the
// continuation state: the reflected ray while the ray lives; once it ends
// the parked ray, with the attenuation frozen at its last value. The
// shadow walk is occluded (ANY_HIT) or closest_walk with t_init = dist,
// in_shadow = t < dist: the same answer, since both walks agree up to the
// first inner hit below dist, which both find. wholeframe_kernel runs
// warp_trace; this is its per-lane reference in tools/host_check.py.
template <int TRI, bool ANY_HIT = true>
__device__ void trace_ray(const Tables& s, const float* tab, const float* par,
                          const Shade& sh, float f_bg, State& st, Counts& c,
                          Counts& cs, float* rgb) {
  rgb[0] = 0.0f; rgb[1] = 0.0f; rgb[2] = 0.0f;
  bool alive = st.ox < 1e30f;
  for (int b = 0; b < sh.bounces && alive; ++b) {
    Ray ray = make_ray(st.ox, st.oy, st.oz, st.dx, st.dy, st.dz);
    Hit h = closest_walk<TRI, true>(s, G_RID, T_RID, ray, INF, c);
    if (!(h.t < INF)) {   // miss: background, and the ray ends
      float bg[3];
      background(f_bg, bg);
      rgb[0] = rgb[0] + st.atr * bg[0];
      rgb[1] = rgb[1] + st.atg * bg[1];
      rgb[2] = rgb[2] + st.atb * bg[2];
      alive = false;
      break;
    }
    bool in_shadow = false;
    if (sh.enable_shadows) {
      float dist;
      Ray sray = shadow_ray(par, sh, st, h.t, h.nx, h.ny, h.nz, dist);
      in_shadow = ANY_HIT ? occluded<TRI>(s, sray, dist, cs)
                          : closest_walk<TRI, false>(s, G_RID, T_RID, sray,
                                                     dist, cs).t < dist;
    }
    alive = shade_hit(tab, par, sh, h.id, h.t, h.nx, h.ny, h.nz, in_shadow,
                      st, rgb);
  }
  if (!alive && sh.bounces > 0) park(st);   // an ended ray: the parked ray
}

// _fused_kernel's shadow ray of a ray r with its closest hit (hit) at t
// and normal n: from p + n * shadow_eps, p = o + t * d, toward the light
// (lx, ly, lz), normalised with eps 1e-30 (normalize(.., eps=1e-30)), its
// limit the light's distance from p. A miss parks the ray with limit 0:
// unshadowed. fused_ray and warp_fused share this code.
__device__ __forceinline__ Ray fused_shadow_ray(const Ray& r, bool hit,
                                                float t, float nx, float ny,
                                                float nz, float lx, float ly,
                                                float lz, float shadow_eps,
                                                float& limit) {
  float ts = hit ? t : 0.0f;
  float px = r.ox + ts * r.dx;
  float py = r.oy + ts * r.dy;
  float pz = r.oz + ts * r.dz;
  float ldx = lx - px;
  float ldy = ly - py;
  float ldz = lz - pz;
  float dist = sqrtf(ldx * ldx + ldy * ldy + ldz * ldz);
  float inv = 1.0f / jmax(dist, 1e-30f);
  limit = hit ? dist : 0.0f;
  return hit ? make_ray(px + nx * shadow_eps, py + ny * shadow_eps,
                        pz + nz * shadow_eps, ldx * inv, ldy * inv,
                        ldz * inv)
             : make_ray(PARK_ORIGIN, PARK_ORIGIN, PARK_ORIGIN, PARK_DIR,
                        PARK_DIR, PARK_DIR);
}

// _fused_kernel for one ray, per thread (the per-lane reference of
// warp_fused in tools/host_check.py): the closest hit with normals (tests
// in c), then the shadow ray of fused_shadow_ray (tests in cs), walked by
// occluded below its limit (ANY_HIT) or by closest_walk with t_init =
// limit, in_shadow = t < limit: the same answer (trace_ray's argument). A
// parked input ray misses.
template <int TRI, bool ANY_HIT = true>
__device__ void fused_ray(const Tables& s, const Ray& r, float lx, float ly,
                          float lz, float shadow_eps, Counts& c, Counts& cs,
                          float& t, float& gid, bool& in_shadow) {
  Hit h = closest_walk<TRI, true>(s, G_GID, T_GID, r, INF, c);
  float limit;
  Ray sray = fused_shadow_ray(r, h.t < INF, h.t, h.nx, h.ny, h.nz, lx, ly,
                              lz, shadow_eps, limit);
  t = h.t;
  gid = h.id;
  in_shadow = ANY_HIT ? occluded<TRI>(s, sray, limit, cs)
                      : closest_walk<TRI, false>(s, G_GID, T_GID, sray,
                                                 limit, cs).t < limit;
}

// _resolve_kernel for one ray from its row v[0..15] of the padded
// attribute table (ATTR_PAD_W columns: n(3), color(3), ka, kd, ks, kf,
// shininess, center(3), is_sphere, 0), already gathered: the 11 shading
// attributes, where a sphere's normal comes from the hit point p, blended
// by is_sphere as the JAX kernel does. 1/sqrt is IEEE division of a
// correctly rounded root (not rsqrtf, which is not correctly rounded).
__device__ __forceinline__ void resolve_row(const float* v, float px,
                                            float py, float pz, float* a) {
  float is_s = v[14];
  float rx = px - v[11];
  float ry = py - v[12];
  float rz = pz - v[13];
  float inv = 1.0f / sqrtf(rx * rx + ry * ry + rz * rz + 1e-30f);
  a[0] = is_s * (rx * inv) + (1.0f - is_s) * v[0];
  a[1] = is_s * (ry * inv) + (1.0f - is_s) * v[1];
  a[2] = is_s * (rz * inv) + (1.0f - is_s) * v[2];
  for (int k = 3; k < 11; ++k) a[k] = v[k];
}

// ---- The packet-BVH and brute-force kernels' per-ray code -------------
// Both test the 24-column packed rows (geom/rowwise.py::intersect_rows).

// _row_intersect for one ray and one row, by the row's type: t and inner
// as the JAX union test gives them (sphere (-b - sq) / 2a; plane, wall and
// barycentric triangle t_pl; Moller-Trumbore its own t). Counts the test
// in c.tri (triangles) or c.pre (other rows).
template <bool MT, class L = Ldg>
__device__ __forceinline__ bool row_intersect(const float* p, const Ray& r,
                                              float& t, Counts& c) {
  int typ = (int)L::f(p);
  if (typ != TRIANGLE) c.pre += 1;
  if (typ == SPHERE) return pre_sphere<L>(p, r, t);
  if (typ == TRIANGLE) {
    c.tri += 1;
    if (MT) return mt_test<L>(p + 9, r, t);
  }
  float hx, hy, hz;
  bool v_pl = plane_hit<L>(p + 5, r, t, hx, hy, hz);
  if (typ == PLANE) return v_pl;
  if (typ == WALL) return v_pl && wall_inside<L>(p + 9, hx, hy, hz);
  return typ == TRIANGLE && v_pl && bary_inside<L>(p + 9, hx, hy, hz);
}

// The reference median tree: leaf_start/leaf_count/skip (m,), nodes (m,
// NODE_W) with the cull flag in column 6, rows (K, ROW_W) in DFS-leaf
// order.
struct Tree {
  const int* leaf_start;
  const int* leaf_count;
  const int* skip;
  const float* nodes;
  const float* rows;
  int m;
};

// _packet_kernel / _occlusion_kernel for one ray, per thread (the per-lane
// reference of warp_walk in tools/host_check.py): the skip-pointer walk,
// entering a node when its box is hit and, with CULL, when the node is
// not cullable or its entry tmin <= the best t (OCC: <= limit). A leaf's
// rows are tested in order with the strict t < t_best update, so the
// first row (DFS-leaf order) of the least t wins. Closest mode leaves
// t_best (INF on a miss) and its local row (0 on a miss); OCC returns
// true at the first inner hit with t < limit. A NaN ray fails every slab
// compare and ends at the root. A ray whose direction is exactly zero
// hits no shape (n.d, d x e2 and the sphere's b^2 - 4ac are 0 or NaN) but
// every box (its slabs are +-inf), so it misses at once instead of
// walking the whole tree: the Whitted loop's shadow rays of ended lanes
// are such rays.
template <bool MT, bool CULL, bool OCC>
__device__ bool packet_walk(const Tree& s, const Ray& r, float limit,
                            Counts& c, float& t_best, int& best) {
  t_best = INF;
  best = 0;
  if (r.dx == 0.0f && r.dy == 0.0f && r.dz == 0.0f) return false;
  int ptr = 0;
  while (ptr < s.m) {
    const float* b = s.nodes + ptr * NODE_W;
    float tmin, tmax;
    slab(b, r, tmin, tmax);
    c.node += 1;
    bool probe = (tmax >= tmin) && (tmax > 0.0f);
    if (CULL) probe = probe && (ld(b + 6) == 0.0f ||
                                tmin <= (OCC ? limit : t_best));
    int cnt = ldi(s.leaf_count + ptr);
    if (probe && cnt > 0) {
      int st = ldi(s.leaf_start + ptr);
      const float* p = s.rows + (long long)st * ROW_W;
      for (int j = 0; j < cnt; ++j, p += ROW_W) {
        float t;
        bool inner = row_intersect<MT>(p, r, t, c);
        if (OCC) {
          if (inner && t < limit) return true;
        } else if (inner && t < t_best) {
          t_best = t;
          best = st + j;
        }
      }
      ptr = ldi(s.skip + ptr);
    } else if (probe) {
      ptr += 1;
    } else {
      ptr = ldi(s.skip + ptr);
    }
  }
  return false;
}

// ---- packet_kernel's warp-synchronous walk -----------------------------
//
// The 32 lanes of a warp walk the tree together under one pointer ptr.
// Each lane keeps a resume index and is active at node k iff resume <= k
// (a lane that is out of range or has a zero direction starts with resume
// = m: it never walks). At node k every active lane runs its own slab
// probe (with CULL, against its own t_best); an active lane that does not
// probe sets resume = skip[k]. Then:
// - an inner node: if some active lane probes, ptr = k + 1 (the probing
//   lanes stay active); else ptr = skip[k];
// - a leaf: if some lane probes, the probing lanes test its rows in
//   order with the strict t < t_best update; ptr = skip[k].
// Why it is exact. ptr is always the least of the lanes' per-thread
// pointers: a lane inactive at k has resume = skip[j] for a node j < k
// whose subtree [j, skip[j]) holds k, so skip[k] <= resume, and no jump
// of ptr passes a lane's next node. So each lane evaluates exactly the
// nodes and rows of its per-thread walk (packet_walk<MT, CULL, false>), in
// the same order and with the same t_best at each cull test: t and the
// row, ties included, are bit for bit those of packet_walk and of the
// plain version, and so are its per-lane counts. A NaN or parked ray
// probes the root and fails, as packet_walk does.
//
// The warp reads each node's box once per step (one address for all
// lanes) and stages a leaf's rows in shared memory, CHUNK_ROWS rows (3 KB)
// at a time into one of two buffers while the lanes test the other chunk;
// the lanes then read every row at one address (a broadcast), so the type
// branch is uniform. W is the lane policy: on the card a thread is one
// lane (N = 1) and votes with __any_sync, and the rows go to shared memory
// with cp.async (raytrace.cu::CardWarp); the host check
// (tools/host_check.py) runs N = 32 lanes in one thread, votes with a loop
// and lands each copy at the wait that covers it, as cp.async does. Every
// vote is reached by all 32 threads: the
// loop's control flow depends only on ptr, the tables and the votes.
constexpr int CHUNK_ROWS = 32;
constexpr int CHUNK_FLOATS = CHUNK_ROWS * ROW_W;
// Rows a lane tests at once (warp_rows).
constexpr int ROW_ILP = 4;

// One lane of the warp walk: its ray, counts, best t and its row, its
// resume index and its probe at the current node. In occlusion mode t is
// the lane's limit, and occ is set once an inner hit lies below it.
struct Lane {
  Ray r;
  Counts c;
  float t;
  int row;
  int resume;
  bool probe, occ;
};

// Node steps and row steps of one warp (each counted once per warp).
struct WarpCounts {
  unsigned node, row;
};

__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }

// The staging loop of the lockstep walks: the n rows of width floats at
// src go into buf (two buffers of chunk rows, 16-byte aligned) chunk by
// chunk, the next chunk's copy in flight while the current one is read,
// and body(cur, k0, nr) runs on each chunk once it is in place for every
// lane (rows k0 .. k0 + nr - 1 at cur). W::sync before and after body,
// so that no lane reads a buffer before it lands or while it is refilled.
// A body that returns false ends the loop: the copy in flight is waited
// for and the rest is not read.
template <class W, class Body>
__device__ __forceinline__ void staged_chunks(const float* src, int n,
                                              int chunk, int width,
                                              float* buf, Body body) {
  int nch = (n + chunk - 1) / chunk;
  if (nch == 0) return;
  int cf = chunk * width;
  W::stage(buf, src, imin(n, chunk) * width / 4);
  W::commit();
  for (int ci = 0; ci < nch; ++ci) {
    int k0 = ci * chunk;
    if (ci + 1 < nch) {
      int k1 = k0 + chunk;
      W::stage(buf + ((ci + 1) & 1) * cf, src + (long long)k1 * width,
               imin(n - k1, chunk) * width / 4);
      W::commit();
      W::wait_but_one();
    } else {
      W::wait_all();
    }
    W::sync();   // the chunk is in place for every lane
    bool more = body(buf + (ci & 1) * cf, k0, imin(n - k0, chunk));
    W::sync();   // every lane is done with the chunk before it is refilled
    if (!more) {
      if (ci + 1 < nch) W::wait_all();
      return;
    }
  }
}

// The skip-pointer walk of one warp in lockstep: one pointer ptr for the
// warp, a resume index per lane (a lane probes node ptr once ptr has
// reached it, and resumes at the node's skip pointer where its probe
// fails), one vote a node. A lane probes where the node's slab is hit and
// cull(a, box, tmin) holds (box: the node's first NB floats); a leaf that
// some lane probes goes to leaf(st, cnt) for its rows st .., which returns
// the rows the warp stepped through. A lane of resume index m walks not;
// ANY (any hit): a lane that is done sets resume = m, and the walk ends
// after a leaf that leaves no lane. LaneT has r, c, resume and probe; T
// has nodes, leaf_start, leaf_count, skip and m. The loop's control flow
// depends only on ptr, the tables and the votes, so every vote is reached
// by all 32 threads.
template <class W, int NB, bool ANY, class T, class LaneT, class Cull,
          class Leaf>
__device__ __forceinline__ void lockstep_walk(const T& s, LaneT* ln,
                                              WarpCounts& wc, Cull cull,
                                              Leaf leaf) {
  bool vote[W::N];
  for (int l = 0; l < W::N; ++l) vote[l] = ln[l].resume == 0;
  if (!W::any(vote)) return;
  int ptr = 0;
  while (ptr < s.m) {
    const float* b = s.nodes + ptr * NODE_W;
    float box[NB];
    for (int q = 0; q < NB; ++q) box[q] = ld(b + q);
    int cnt = ldi(s.leaf_count + ptr);
    int nxt = ldi(s.skip + ptr);
    for (int l = 0; l < W::N; ++l) {
      LaneT& a = ln[l];
      a.probe = false;
      if (a.resume <= ptr) {
        float tmin, tmax;
        slab<Plain>(box, a.r, tmin, tmax);
        a.c.node += 1;
        a.probe = (tmax >= tmin) && (tmax > 0.0f) && cull(a, box, tmin);
        if (!a.probe) a.resume = nxt;
      }
      vote[l] = a.probe;
    }
    wc.node += 1;
    if (!W::any(vote)) {
      ptr = nxt;
    } else if (cnt == 0) {
      ptr += 1;
    } else {
      wc.row += leaf(ldi(s.leaf_start + ptr), cnt);
      ptr = nxt;
      if (ANY) {   // false once every lane is done
        for (int l = 0; l < W::N; ++l) vote[l] = ln[l].resume < s.m;
        if (!W::any(vote)) return;
      }
    }
  }
}

// U consecutive rows, the group a lane tests before its updates.
template <int U>
struct RowGroup {
  static constexpr int n = U;
};

// The probing lanes of one warp test a leaf's cnt rows of width floats at
// src, staged chunk by chunk (staged_chunks: chunk rows a chunk into buf,
// 2 * chunk * width floats, 16-byte aligned): rows(RowGroup<U>(), p, j)
// tests the U rows at p, rows j .. of the leaf, ROW_ILP at a time, then
// one by one. ANY (any hit): the warp stops reading the leaf once no lane
// probes. Returns the rows the warp stepped through.
template <class W, bool ANY, class LaneT, class Rows>
__device__ __forceinline__ unsigned lockstep_leaf(const float* src, int cnt,
                                                  int chunk, int width,
                                                  LaneT* ln, float* buf,
                                                  Rows rows) {
  unsigned stepped = 0u;
  staged_chunks<W>(src, cnt, chunk, width, buf,
                   [&](const float* cur, int j0, int nr) {
    int j = 0;
    for (; j + ROW_ILP <= nr; j += ROW_ILP)
      rows(RowGroup<ROW_ILP>(), cur + j * width, j0 + j);
    for (; j < nr; ++j) rows(RowGroup<1>(), cur + j * width, j0 + j);
    stepped += (unsigned)nr;
    if (!ANY || j0 + nr == cnt) return true;
    bool vote[W::N];   // no lane left: the next chunk is not read
    for (int l = 0; l < W::N; ++l) vote[l] = ln[l].probe;
    return W::any(vote);
  });
  return stepped;
}

__device__ __forceinline__ void lane_init(Lane& a, const Tree& s, bool live,
                                          const Ray& r, float limit = INF) {
  a.r = r;
  a.c.pre = 0u; a.c.node = 0u; a.c.tri = 0u;
  a.t = limit;
  a.row = 0;
  bool zero = r.dx == 0.0f && r.dy == 0.0f && r.dz == 0.0f;
  a.resume = live && !zero ? 0 : s.m;
  a.probe = false;
  a.occ = false;
}

// A triangle row's test without branches (row_intersect's triangle case:
// the same arithmetic, with & for &&, so that the tests of several rows
// can interleave). row_intersect keeps its own short-circuit form: taking
// its triangles from tri_row slowed the per-thread walk that
// occlusion_kernel ran before it walked in lockstep, on scene 2 from
// 1.73-1.75 to 2.24-2.27 ms a call (NVIDIA H100 80GB HBM3 at 700 W,
// tools/kernel_ab.py).
template <bool MT, class L>
__device__ __forceinline__ bool tri_row(const float* p, const Ray& r,
                                        float& t) {
  if (MT) return mt_test<L>(p + 9, r, t);
  float hx, hy, hz;
  bool v_pl = plane_hit<L>(p + 5, r, t, hx, hy, hz);
  return v_pl & bary_inside<L>(p + 9, hx, hy, hz);
}

// The probing lanes test U consecutive staged rows at p (local rows row0
// ..): every test first, then the strict t < t_best updates in row order.
// A closest-hit row test does not read t_best, so this is the in-order
// result; the U independent tests give each lane U chains of arithmetic to
// overlap, where one row's test is one long dependent chain. Where all U
// rows are triangles (a warp-uniform test), they take tri_row, without
// row_intersect's type branches between them (scene 2: 0.62-0.65 ms
// against 0.71-0.74 ms with row_intersect alone, tools/kernel_ab.py).
// OCC (any hit): a lane stops at its first row with an inner hit below its
// limit t: it sets occ, drops its probe and leaves the walk (resume = m),
// and counts the rows up to that one, as packet_walk<MT, CULL, true>
// returns there.
template <class W, bool MT, bool OCC, int U>
__device__ __forceinline__ void warp_rows(const float* p, int row0, Lane* ln,
                                          int m) {
  bool tris = true;
  for (int u = 0; u < U; ++u)
    tris = tris && (int)p[u * ROW_W] == TRIANGLE;
  for (int l = 0; l < W::N; ++l) {
    Lane& a = ln[l];
    if (!a.probe) continue;
    float t[U];
    bool inner[U];
    Counts tested = {0u, 0u, 0u};   // OCC: counted below, up to the hit
    if (tris) {
      if (!OCC) a.c.tri += U;
      for (int u = 0; u < U; ++u)
        inner[u] = tri_row<MT, Plain>(p + u * ROW_W, a.r, t[u]);
    } else {
      for (int u = 0; u < U; ++u)
        inner[u] = row_intersect<MT, Plain>(p + u * ROW_W, a.r, t[u],
                                            OCC ? tested : a.c);
    }
    if (OCC) {
      int u = 0;
      while (u < U && !(inner[u] && t[u] < a.t)) ++u;
      for (int k = 0; k < U && k <= u; ++k) {
        if ((int)p[k * ROW_W] == TRIANGLE) a.c.tri += 1;
        else a.c.pre += 1;
      }
      if (u < U) {
        a.occ = true;
        a.probe = false;
        a.resume = m;
      }
      continue;
    }
    for (int u = 0; u < U; ++u) {
      if (inner[u] && t[u] < a.t) {
        a.t = t[u];
        a.row = row0 + u;
      }
    }
  }
}

// The closest hit of the W::N lanes ln (of one warp): each lane's t (INF
// on a miss) and row (0 on a miss), as packet_walk<MT, CULL, false> gives
// them. With CULL a lane probes a node that is not cullable (column 6 is
// 0) or that it enters at tmin <= its t. OCC: whether each lane has an
// inner hit below its limit (lane_init's limit, held in t), as
// packet_walk<MT, CULL, true> answers, with the cull against the limit;
// the warp leaves the tree once no lane is left. A leaf's rows are staged
// CHUNK_ROWS at a time. buf: this warp's staging buffer (2 * CHUNK_FLOATS
// floats, 16-byte aligned).
template <class W, bool MT, bool CULL, bool OCC = false>
__device__ __forceinline__ void warp_walk(const Tree& s, Lane* ln,
                                          float* buf, WarpCounts& wc) {
  lockstep_walk<W, 7, OCC>(
      s, ln, wc,
      [](const Lane& a, const float* box, float tmin) {
        return !CULL || box[6] == 0.0f || tmin <= a.t;
      },
      [&](int st, int cnt) {
        return lockstep_leaf<W, OCC>(
            s.rows + (long long)st * ROW_W, cnt, CHUNK_ROWS, ROW_W, ln, buf,
            [&](auto g, const float* p, int j) {
              warp_rows<W, MT, OCC, decltype(g)::n>(p, st + j, ln, s.m);
            });
      });
}

// ---- brute_kernel's walk over box runs ---------------------------------
//
// _closest_hit_kernel (pallas_kernel.py:95): the first type-sorted row of
// least t among the inner hits, each gated by its row's leaf box with
// GATE; t INF and row 0 on a miss. The gate is a logical AND with the row
// test, and consecutive type-sorted rows often share a leaf box, so the
// walk gates first, once per run of a run table (render/brute.py::
// box_runs: maximal ranges of consecutive rows of one type with
// bitwise-equal box columns, each as its box, first row and row count),
// and tests only the rows whose gate passes. Per run, each lane gates its
// own ray against the box (RUN_ILP runs at a time, then one vote for the
// group); the warp skips a run that no lane passes, and otherwise the
// passing lanes test its rows, ROW_ILP at a time: every test first, then
// the strict t < t_best updates in row order. A run holds one type, so its
// tests need no type branch. Rows are visited in type-sorted order and a
// row is skipped only where its gate fails, so t and the row, ties
// included, are the plain version's (brute.py::brute_plain). Without GATE
// every lane tests every row of every run (the runs are then the type
// segments).
//
// The run table is staged in shared memory, chunk by chunk (chunk runs, 32
// bytes each) into one of two buffers, by the whole block (W::stage,
// W::sync is a block barrier), so every warp visits every run and control
// flow stays uniform across the block. W is the lane policy as for
// warp_walk; the host check runs one 32-lane warp as the block.
constexpr int RUN_W = 8;     // box min xyz, max xyz, first row, row count
constexpr int RUN_ILP = 8;   // gates a lane evaluates before the warp votes

// The rows, the run table and where each type's rows end (spheres,
// planes, walls; triangles to the end).
struct Runs {
  const float* rows;   // (n_rows, ROW_EXT_W), type-sorted
  const float* runs;   // (n_runs, RUN_W)
  int n_runs, chunk;   // runs per staged chunk
  int end[3];
};

// One lane of the brute walk: its ray, best t and row, whether it walks,
// its gate and row tests. A thread past n never walks, and neither does a
// ray whose direction is exactly zero: it hits no shape (packet_walk's
// argument), but its slabs are +-inf, so where its origin lies below a box
// on every axis it passes the gate (the Whitted loop's shadow rays of
// missed lanes are such rays).
struct BruteLane {
  Ray r;
  float t;
  int row;
  bool walks;
  unsigned gates, tests;
};

__device__ __forceinline__ void brute_lane_init(BruteLane& a, bool live,
                                                const Ray& r) {
  a.r = r;
  a.t = INF;
  a.row = 0;
  a.walks = live && !(r.dx == 0.0f && r.dy == 0.0f && r.dz == 0.0f);
  a.gates = 0u;
  a.tests = 0u;
}

// min / max that give NaN where either operand is NaN, in one instruction
// on the card (PTX min.NaN, sm_80 and later); jmin / jmax elsewhere. They
// may differ from jmin / jmax in the sign of a zero only, which no compare
// of the gate sees.
#ifdef __CUDA_ARCH__
__device__ __forceinline__ float nan_min(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
#else
__device__ __forceinline__ float nan_min(float a, float b) { return jmin(a, b); }
__device__ __forceinline__ float nan_max(float a, float b) { return jmax(a, b); }
#endif

// box_gate of a staged run's box b (32-byte aligned): the same slab
// arithmetic and decision. The card reads the box as two 16-byte loads.
__device__ __forceinline__ bool run_gate(const float* b, const Ray& r) {
#ifdef __CUDA_ARCH__
  float4 lo = *reinterpret_cast<const float4*>(b);
  float4 hi = *reinterpret_cast<const float4*>(b + 4);
  float b0 = lo.x, b1 = lo.y, b2 = lo.z, b3 = lo.w, b4 = hi.x, b5 = hi.y;
#else
  float b0 = b[0], b1 = b[1], b2 = b[2], b3 = b[3], b4 = b[4], b5 = b[5];
#endif
  float tx0 = (b0 - r.ox) * r.ix;
  float tx1 = (b3 - r.ox) * r.ix;
  float ty0 = (b1 - r.oy) * r.iy;
  float ty1 = (b4 - r.oy) * r.iy;
  float tz0 = (b2 - r.oz) * r.iz;
  float tz1 = (b5 - r.oz) * r.iz;
  float tmin = nan_max(nan_max(nan_min(tx0, tx1), nan_min(ty0, ty1)),
                       nan_min(tz0, tz1));
  float tmax = nan_min(nan_min(nan_max(tx0, tx1), nan_max(ty0, ty1)),
                       nan_max(tz0, tz1));
  return (tmax >= tmin) && (tmax > 0.0f);
}

// The union test (row_intersect) of a row of type TYP, with & for && (no
// branches, so that the tests of several rows interleave).
template <int TYP, bool MT>
__device__ __forceinline__ bool brute_test(const float* p, const Ray& r,
                                           float& t) {
  if (TYP == SPHERE) return pre_sphere(p, r, t);
  if (TYP == TRIANGLE && MT) return mt_test(p + 9, r, t);
  float hx, hy, hz;
  bool v_pl = plane_hit(p + 5, r, t, hx, hy, hz);
  if (TYP == PLANE) return v_pl;
  if (TYP == WALL) return v_pl & wall_inside(p + 9, hx, hy, hz);
  return v_pl & bary_inside(p + 9, hx, hy, hz);
}

// The lanes that pass test the U rows j .. of type TYP: every test first,
// then the updates in row order.
template <class W, int TYP, bool MT, int U>
__device__ __forceinline__ void brute_rows(const float* rows, int j,
                                           BruteLane* ln, const bool* pass) {
  const float* p = rows + (long long)j * ROW_EXT_W;
  for (int l = 0; l < W::N; ++l) {
    BruteLane& a = ln[l];
    if (!pass[l]) continue;
    float t[U];
    bool inner[U];
    for (int u = 0; u < U; ++u)
      inner[u] = brute_test<TYP, MT>(p + u * ROW_EXT_W, a.r, t[u]);
    a.tests += U;
    for (int u = 0; u < U; ++u) {
      if (inner[u] && t[u] < a.t) {
        a.t = t[u];
        a.row = j + u;
      }
    }
  }
}

template <class W, int TYP, bool MT>
__device__ __forceinline__ void brute_run(const float* rows, int st, int cnt,
                                          BruteLane* ln, const bool* pass) {
  int j = 0;
  for (; j + ROW_ILP <= cnt; j += ROW_ILP)
    brute_rows<W, TYP, MT, ROW_ILP>(rows, st + j, ln, pass);
  for (; j < cnt; ++j) brute_rows<W, TYP, MT, 1>(rows, st + j, ln, pass);
}

// U consecutive runs at b: each lane's gates, one vote for the group, then
// per run a vote and the passing lanes' row tests. Returns the rows the
// warp stepped through. The U gates are evaluated without branches (a
// lane that does not walk gates too, and its bits are dropped), so that
// their arithmetic interleaves, and a lane keeps its U results as bits of
// one register.
template <class W, bool MT, bool GATE, int U>
__device__ __forceinline__ unsigned brute_runs(const Runs& s, const float* b,
                                               BruteLane* ln) {
  unsigned pass[W::N];
  bool vote[W::N];
  for (int l = 0; l < W::N; ++l) {
    BruteLane& a = ln[l];
    unsigned bits = (1u << U) - 1u;
    if (GATE) {
      bits = 0u;
      for (int u = 0; u < U; ++u)
        bits |= (unsigned)run_gate(b + u * RUN_W, a.r) << u;
      if (a.walks) a.gates += U;
    }
    pass[l] = a.walks ? bits : 0u;
    vote[l] = pass[l] != 0u;
  }
  if (!W::any(vote)) return 0u;
  unsigned stepped = 0u;
  for (int u = 0; u < U; ++u) {
    for (int l = 0; l < W::N; ++l) vote[l] = (pass[l] >> u) & 1u;
    if (!W::any(vote)) continue;
    const float* run = b + u * RUN_W;
    int st = (int)run[6], cnt = (int)run[7];
    int typ = (st >= s.end[0]) + (st >= s.end[1]) + (st >= s.end[2]);
    if (typ == SPHERE) brute_run<W, SPHERE, MT>(s.rows, st, cnt, ln, vote);
    else if (typ == PLANE) brute_run<W, PLANE, MT>(s.rows, st, cnt, ln, vote);
    else if (typ == WALL) brute_run<W, WALL, MT>(s.rows, st, cnt, ln, vote);
    else brute_run<W, TRIANGLE, MT>(s.rows, st, cnt, ln, vote);
    stepped += (unsigned)cnt;
  }
  return stepped;
}

// The closest hit of the W::N lanes ln over every run: each lane's t (INF
// on a miss) and row (0 on a miss). buf: the block's two chunk buffers
// (2 * chunk * RUN_W floats, 16-byte aligned).
template <class W, bool MT, bool GATE>
__device__ __forceinline__ void brute_walk(const Runs& s, BruteLane* ln,
                                           float* buf, WarpCounts& wc) {
  staged_chunks<W>(s.runs, s.n_runs, s.chunk, RUN_W, buf,
                   [&](const float* cur, int, int nr) {
    int k = 0;
    for (; k + RUN_ILP <= nr; k += RUN_ILP)
      wc.row += brute_runs<W, MT, GATE, RUN_ILP>(s, cur + k * RUN_W, ln);
    for (; k < nr; ++k)
      wc.row += brute_runs<W, MT, GATE, 1>(s, cur + k * RUN_W, ln);
    return true;
  });
}

// ---- closest_hit_kernel's warp-synchronous split walk ------------------
//
// closest_walk<TRI, false> and occluded<TRI> for the 32 rays of a warp.
// Each lane first runs the pre-pass over the n_other rows alone (every
// lane tests the same rows, so no vote is needed): spheres, then planes
// and walls, PRE_ILP rows at a time, every test first and then the
// strict-< updates in row order, so the earliest row still wins exact
// ties. Then the warp walks the triangle tree in lockstep as warp_walk
// walks the reference tree (lockstep_walk): one pointer ptr, a resume
// index per lane, votes, each lane probing with its own cull (tmin <= t
// after the pre-pass; in occlusion mode tmin <= limit). A leaf's triangle
// rows are staged in shared memory SPLIT_CHUNK rows at a time, double
// buffered (staged_chunks), and each probing lane tests ROW_ILP rows with
// tri_split, the branch-free form of tri_test, before its in-order
// updates. In occlusion mode a lane whose inner hit lies below its limit
// is done (resume = m; its counts stop where occluded returns), and the
// warp leaves the tree, or the rest of a leaf, once no lane is left. By
// warp_walk's argument each lane evaluates the pre rows, nodes and
// triangles of its per-thread walk in the same order with the same t at
// each cull test: t, the winning row and the per-lane counts are
// closest_walk's (occluded's). A parked ray (ox >= 1e30, or NaN) neither
// tests nor walks, as closest_walk returns at once for it. Closest mode
// keeps a reference to the winning row (a pre row or a triangle row, as
// closest_walk<..., MAT> keeps its material pointer): the caller reads
// the id column and the normal once, after the walk (split_id,
// split_normal).
constexpr int SPLIT_CHUNK = 32;
constexpr int SPLIT_CHUNK_FLOATS = SPLIT_CHUNK * TRI_W;
constexpr int PRE_ILP = 4;

// One lane of the split walk. Closest mode: t (INF on a miss) and ref, the
// winning row: i < n_other for pre row i, n_other + k for triangle row k,
// -1 on a miss; occlusion mode: limit, and occ once an occluder is found.
struct SplitLane {
  Ray r;
  Counts c;
  float t, limit;
  int ref, resume;
  bool walks, probe, occ;
};

__device__ __forceinline__ void split_lane_init(SplitLane& a, const Tables& s,
                                                bool live, const Ray& r,
                                                float limit) {
  a.r = r;
  a.c.pre = 0u; a.c.node = 0u; a.c.tri = 0u;
  a.t = INF;
  a.ref = -1;
  a.limit = limit;
  a.walks = live && r.ox < 1e30f;
  a.resume = a.walks ? 0 : s.m;
  a.probe = false;
  a.occ = false;
}

// pre_planewall with & for &&.
__device__ __forceinline__ bool pre_pw(const float* p, const Ray& r,
                                       float& t) {
  float hx, hy, hz;
  bool v_pl = plane_hit(p + 5, r, t, hx, hy, hz);
  return v_pl & wall_inside(p + 9, hx, hy, hz) & box_gate(p + G_B0X, r);
}

// tri_test<TRI> with & for &&.
template <int TRI, class L>
__device__ __forceinline__ bool tri_split(const float* p, const Ray& r,
                                          float& t) {
  if (TRI == TRI_MT) return mt_test<L>(p + T_E1X, r, t);
  float hx, hy, hz;
  bool inner = plane_hit<L>(p + T_NX, r, t, hx, hy, hz);
  if (TRI == TRI_GRAM) {
    float evx = L::f(p + T_EVX), evy = L::f(p + T_EVX + 1),
          evz = L::f(p + T_EVX + 2);
    float ewx = L::f(p + T_EWX), ewy = L::f(p + T_EWX + 1),
          ewz = L::f(p + T_EWX + 2);
    float d_ev = r.dx * evx + r.dy * evy + r.dz * evz;
    float o_ev = r.ox * evx + r.oy * evy + r.oz * evz - L::f(p + T_CV);
    float v = o_ev + t * d_ev;
    float d_ew = r.dx * ewx + r.dy * ewy + r.dz * ewz;
    float o_ew = r.ox * ewx + r.oy * ewy + r.oz * ewz - L::f(p + T_CW);
    float w = o_ew + t * d_ew;
    return inner & (v >= 0.0f) & (w >= 0.0f) & ((v + w) <= 1.0f);
  }
  return inner & bary_inside<L>(p + T_E1X, hx, hy, hz);
}

// U pre rows from row i (all spheres, or all planes and walls). Closest
// mode: the strict-< updates of best and bi in row order; occlusion mode:
// true at the first row occluding below the limit, counting the rows
// occluded would have tested.
template <bool SPH, int U, bool OCC>
__device__ __forceinline__ bool pre_group(const float* pre, int i,
                                          SplitLane& a, float& best,
                                          int& bi) {
  float t[U];
  bool inner[U];
  for (int u = 0; u < U; ++u) {
    const float* p = pre + (i + u) * PRE_W;
    inner[u] = SPH ? pre_sphere(p, a.r, t[u]) : pre_pw(p, a.r, t[u]);
  }
  if (OCC) {
    for (int u = 0; u < U; ++u) {
      if (inner[u] && t[u] < a.limit) {
        a.c.pre += u + 1;
        return true;
      }
    }
    a.c.pre += U;
    return false;
  }
  for (int u = 0; u < U; ++u) {
    if (inner[u] && t[u] < best) {
      best = t[u];
      bi = i + u;
    }
  }
  return false;
}

template <bool OCC>
__device__ __forceinline__ void split_pre(const Tables& s, SplitLane& a) {
  float best = INF;
  int bi = -1;
  bool occ = false;
  int i = 0;
  for (; !occ && i + PRE_ILP <= s.n_sph; i += PRE_ILP)
    occ = pre_group<true, PRE_ILP, OCC>(s.pre, i, a, best, bi);
  for (; !occ && i < s.n_sph; ++i)
    occ = pre_group<true, 1, OCC>(s.pre, i, a, best, bi);
  for (; !occ && i + PRE_ILP <= s.n_other; i += PRE_ILP)
    occ = pre_group<false, PRE_ILP, OCC>(s.pre, i, a, best, bi);
  for (; !occ && i < s.n_other; ++i)
    occ = pre_group<false, 1, OCC>(s.pre, i, a, best, bi);
  if (OCC) {
    a.occ = occ;
    if (occ) a.resume = s.m;
    return;
  }
  a.c.pre += s.n_other;
  if (best < a.t) {
    a.t = best;
    a.ref = bi;
  }
}

// The probing lanes test the U staged triangle rows at p; ref0: the
// reference of the first (n_other + its triangle row).
template <class W, int TRI, bool OCC, int U>
__device__ __forceinline__ void split_rows(const float* p, int ref0,
                                           SplitLane* ln, int m) {
  for (int l = 0; l < W::N; ++l) {
    SplitLane& a = ln[l];
    if (!a.probe) continue;
    float t[U];
    bool inner[U];
    for (int u = 0; u < U; ++u)
      inner[u] = tri_split<TRI, Plain>(p + u * TRI_W, a.r, t[u]);
    if (OCC) {
      int u = 0;
      while (u < U && !(inner[u] && t[u] < a.limit)) ++u;
      a.c.tri += u < U ? u + 1 : U;
      if (u < U) {
        a.occ = true;
        a.probe = false;
        a.resume = m;
      }
    } else {
      a.c.tri += U;
      for (int u = 0; u < U; ++u) {
        if (inner[u] && t[u] < a.t) {
          a.t = t[u];
          a.ref = ref0 + u;
        }
      }
    }
  }
}

// The pre-pass and the tree walk of the W::N lanes ln (of one warp). buf:
// this warp's staging buffer (2 * SPLIT_CHUNK_FLOATS floats, 16-byte
// aligned).
template <class W, int TRI, bool OCC>
__device__ __forceinline__ void split_walk(const Tables& s, SplitLane* ln,
                                           float* buf, WarpCounts& wc) {
  for (int l = 0; l < W::N; ++l)
    if (ln[l].walks) split_pre<OCC>(s, ln[l]);
  lockstep_walk<W, 6, OCC>(
      s, ln, wc,
      [](const SplitLane& a, const float*, float tmin) {
        return tmin <= (OCC ? a.limit : a.t);
      },
      [&](int st, int cnt) {
        return lockstep_leaf<W, OCC>(
            s.tri + (long long)st * TRI_W, cnt, SPLIT_CHUNK, TRI_W, ln, buf,
            [&](auto g, const float* p, int j) {
              split_rows<W, TRI, OCC, decltype(g)::n>(p, s.n_other + st + j,
                                                      ln, s.m);
            });
      });
}

// Column pre_col of the winning pre row or tri_col of the winning
// triangle row of a closest-mode split walk (G_GID/T_GID, or the resolve
// id G_RID/T_RID); -1 on a miss.
__device__ __forceinline__ float split_id(const Tables& s, const SplitLane& a,
                                          int pre_col, int tri_col) {
  if (a.ref < 0) return -1.0f;
  if (a.ref < s.n_other) return ld(s.pre + a.ref * PRE_W + pre_col);
  return ld(s.tri + (long long)(a.ref - s.n_other) * TRI_W + tri_col);
}

// The normal of a closest-mode split walk's hit (a.ref >= 0), with
// closest_walk's NORMALS arithmetic: a sphere's from the hit point
// o + t * d of the lane's ray and the centre, a plane's, wall's or
// triangle's from its row.
__device__ __forceinline__ void split_normal(const Tables& s,
                                             const SplitLane& a, float& nx,
                                             float& ny, float& nz) {
  if (a.ref < s.n_other) {
    const float* p = s.pre + a.ref * PRE_W;
    if (a.ref < s.n_sph) {
      float px = a.r.ox + a.t * a.r.dx - ld(p + 1);
      float py = a.r.oy + a.t * a.r.dy - ld(p + 2);
      float pz = a.r.oz + a.t * a.r.dz - ld(p + 3);
      float inv = 1.0f / sqrtf(px * px + py * py + pz * pz + 1e-30f);
      nx = px * inv; ny = py * inv; nz = pz * inv;
    } else {
      nx = ld(p + 5); ny = ld(p + 6); nz = ld(p + 7);
    }
    return;
  }
  const float* p = s.tri + (long long)(a.ref - s.n_other) * TRI_W;
  nx = ld(p + T_NX); ny = ld(p + T_NX + 1); nz = ld(p + T_NX + 2);
}

// The material columns (colour rgb, ka, kd, ks, kf, shininess) of the
// winning row of a closest-mode split walk: G_MCR.. of a pre row, T_MCR..
// of a triangle row, as closest_walk<..., MAT> keeps h.mat; null on a miss.
__device__ __forceinline__ const float* split_mat(const Tables& s,
                                                  const SplitLane& a) {
  if (a.ref < 0) return nullptr;
  if (a.ref < s.n_other) return s.pre + a.ref * PRE_W + G_MCR;
  return s.tri + (long long)(a.ref - s.n_other) * TRI_W + T_MCR;
}

// closest_attrs_kernel's 11 shading attributes of a closest-mode split
// walk's hit, read once after the walk: the normal (split_normal) and the
// material columns (split_mat); zeros on a miss, as closest_walk<TRI,
// true, true> leaves them.
__device__ __forceinline__ void split_attrs(const Tables& s,
                                            const SplitLane& a, float* v) {
  const float* mat = split_mat(s, a);
  if (mat == nullptr) {
    for (int k = 0; k < 3 + N_MAT; ++k) v[k] = 0.0f;
    return;
  }
  split_normal(s, a, v[0], v[1], v[2]);
  for (int k = 0; k < N_MAT; ++k) v[3 + k] = ld(mat + k);
}

// ---- wholeframe_kernel's lockstep frame trace -------------------------
//
// trace_ray for the 32 pixels (or rays) of a warp. The bounce loop is
// warp-uniform: the warp loops while some lane's ray lives (one vote a
// bounce), and a lane whose ray has ended, or that has no pixel, stays in
// the loop as a lane that never walks. Per bounce the closest hit is a
// closest-mode split_walk over the lanes whose ray lives (each lane's
// unrolled pre-pass, then the lockstep walk of the triangle tree with the
// leaf rows staged per warp); its winning row gives the resolve id and
// the normal. The shadow leg is an occlusion-mode split_walk with limit =
// the light's distance, for the lanes with a hit (with enable_shadows):
// trace_ray<TRI, true>'s occluded, so each lane's tests are closest_walk's
// and occluded's, and its colour and continuation state are trace_ray's
// bit for bit (shadow_ray and shade_hit are the same code). Raygen mode
// gives a warp an 8x4 pixel patch of a TILE_W x TILE_H block tile; consume
// mode 32 neighbours of the given (sorted) stream, where parked rays come
// last, so a warp of parked rays leaves at its first vote.
constexpr int TILE_W = 8, TILE_H = 16, BLOCK = TILE_W * TILE_H;

// One lane of the frame trace: its ray's state, its pixel's background
// fraction, its colour, whether its ray lives, and its tests.
struct TraceLane {
  State st;
  float f_bg, rgb[3];
  bool alive;
  Counts c;
};

__device__ __forceinline__ void add_counts(Counts& a, const Counts& b) {
  a.pre += b.pre; a.node += b.node; a.tri += b.tri;
}

// The entry of thread tid of block (bx, by) of wholeframe_kernel's grid:
// in raygen mode pixel (bx * TILE_W + tid % TILE_W, by * TILE_H + tid /
// TILE_W); in consume mode ray bx * BLOCK + tid of the n given (rays:
// n_rows (6 or 9) rows of n floats, o, d and, with 9 rows, the entry
// attenuation, else 1; ret: their image-order pixel indices y * W + x,
// from which the background is re-derived). Returns the pixel's index y *
// W + x or the ray's (n = W * H or the rays' count: an int), or -1 for a
// thread past the frame or the rays: its lane starts dead and never walks.
template <bool CONSUME>
__device__ __forceinline__ int trace_entry(TraceLane& a, const Params& q,
                                           const float* rays, int n_rows,
                                           const int* ret, int n, int W,
                                           int H, int bx, int by, int tid) {
  State& st = a.st;
  park(st);
  st.atr = 1.0f; st.atg = 1.0f; st.atb = 1.0f;
  a.f_bg = 0.0f;
  int i = -1;
  if (CONSUME) {
    long long j = (long long)bx * BLOCK + tid;
    if (j < n) {
      i = (int)j;
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
      }
      a.f_bg = ((float)(ret[i] / W) + q.y_off) / (float)H;
    }
  } else {
    int x = bx * TILE_W + tid % TILE_W;
    int y = by * TILE_H + tid / TILE_W;
    if (x < W && y < H) {
      i = y * W + x;
      primary_ray(q, x, y, W, H, st, a.f_bg);
    }
  }
  a.rgb[0] = 0.0f; a.rgb[1] = 0.0f; a.rgb[2] = 0.0f;
  a.alive = i >= 0 && st.ox < 1e30f;
  a.c.pre = 0u; a.c.node = 0u; a.c.tri = 0u;
  return i;
}

// Store lane a's colour at out[3 i ..] and, with EMIT, its continuation
// state in the 9 rows of n floats at state (o, d, atten).
template <bool EMIT>
__device__ __forceinline__ void trace_store(const TraceLane& a, int i, int n,
                                            float* out, float* state) {
  out[3LL * i] = a.rgb[0];
  out[3LL * i + 1] = a.rgb[1];
  out[3LL * i + 2] = a.rgb[2];
  if (EMIT) {
    const State& st = a.st;
    const float v[9] = {st.ox, st.oy, st.oz, st.dx, st.dy, st.dz,
                        st.atr, st.atg, st.atb};
    for (int k = 0; k < 9; ++k) state[k * (long long)n + i] = v[k];
  }
}

// The W::N lanes ln (of one warp) trace their rays over sh.bounces
// bounces; on return each lane holds trace_ray's colour and continuation
// state, and its closest walks' tests (trace_ray's c). cs: where lane l's
// shadow-leg tests go (trace_ray's cs), cs[l]; null: into its c as well.
// buf: this warp's staging buffer (2 * SPLIT_CHUNK_FLOATS floats, 16-byte
// aligned).
template <class W, int TRI>
__device__ __forceinline__ void warp_trace(const Tables& s, const float* tab,
                                           const float* par, const Shade& sh,
                                           TraceLane* ln, Counts* cs,
                                           float* buf, WarpCounts& wc) {
  for (int b = 0; b < sh.bounces; ++b) {
    bool vote[W::N];
    for (int l = 0; l < W::N; ++l) vote[l] = ln[l].alive;
    if (!W::any(vote)) break;
    SplitLane h[W::N];
    for (int l = 0; l < W::N; ++l) {
      const State& st = ln[l].st;
      split_lane_init(h[l], s, ln[l].alive,
                      make_ray(st.ox, st.oy, st.oz, st.dx, st.dy, st.dz),
                      INF);
    }
    split_walk<W, TRI, false>(s, h, buf, wc);
    bool hit[W::N], in_shadow[W::N];
    for (int l = 0; l < W::N; ++l) {
      TraceLane& a = ln[l];
      add_counts(a.c, h[l].c);
      hit[l] = a.alive && h[l].t < INF;
      in_shadow[l] = false;
      if (a.alive && !hit[l]) {   // miss: background, and the ray ends
        float bg[3];
        background(a.f_bg, bg);
        a.rgb[0] = a.rgb[0] + a.st.atr * bg[0];
        a.rgb[1] = a.rgb[1] + a.st.atg * bg[1];
        a.rgb[2] = a.rgb[2] + a.st.atb * bg[2];
        a.alive = false;
      }
    }
    if (sh.enable_shadows) {
      SplitLane sl[W::N];
      for (int l = 0; l < W::N; ++l) {
        Ray sr = make_ray(0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f);
        float dist = 0.0f;
        if (hit[l]) {
          float nx, ny, nz;
          split_normal(s, h[l], nx, ny, nz);
          sr = shadow_ray(par, sh, ln[l].st, h[l].t, nx, ny, nz, dist);
        }
        split_lane_init(sl[l], s, hit[l], sr, dist);
      }
      split_walk<W, TRI, true>(s, sl, buf, wc);
      for (int l = 0; l < W::N; ++l) {
        add_counts(cs != nullptr ? cs[l] : ln[l].c, sl[l].c);
        in_shadow[l] = sl[l].occ;
      }
    }
    for (int l = 0; l < W::N; ++l) {
      if (!hit[l]) continue;
      float nx, ny, nz;
      split_normal(s, h[l], nx, ny, nz);
      ln[l].alive = shade_hit(tab, par, sh, split_id(s, h[l], G_RID, T_RID),
                              h[l].t, nx, ny, nz, in_shadow[l], ln[l].st,
                              ln[l].rgb);
    }
  }
  if (sh.bounces > 0)   // an ended ray leaves the parked ray
    for (int l = 0; l < W::N; ++l)
      if (!ln[l].alive) park(ln[l].st);
}

// ---- fused_kernel's lockstep walk --------------------------------------
//
// fused_ray<TRI, true> for the W::N lanes h of one warp, each set up by
// split_lane_init with its ray (live or not) and limit INF: the closest
// hit by a closest-mode split_walk, whose winning row gives the normal
// (split_normal); then each lane with a hit builds fused_shadow_ray, and
// the any-hit split_walk tests it below the light's distance; a lane
// without one never walks (in_shadow false, as fused_ray's parked shadow
// ray). On return h holds the closest walk (t, the winning row for
// split_id, its tests), in_shadow[l] the lane's answer, and lane l's
// shadow-leg tests are in cs[l] (null: in h[l].c as well). Each lane's
// t, id, answer and tests are fused_ray<TRI, true>'s. buf: this warp's
// staging buffer (2 * SPLIT_CHUNK_FLOATS floats, 16-byte aligned).
template <class W, int TRI>
__device__ __forceinline__ void warp_fused(const Tables& s, SplitLane* h,
                                           float lx, float ly, float lz,
                                           float shadow_eps, bool* in_shadow,
                                           Counts* cs, float* buf,
                                           WarpCounts& wc) {
  split_walk<W, TRI, false>(s, h, buf, wc);
  SplitLane sl[W::N];
  for (int l = 0; l < W::N; ++l) {
    bool hit = h[l].t < INF;
    float nx = 0.0f, ny = 0.0f, nz = 0.0f, limit;
    if (hit) split_normal(s, h[l], nx, ny, nz);
    Ray sr = fused_shadow_ray(h[l].r, hit, h[l].t, nx, ny, nz, lx, ly, lz,
                              shadow_eps, limit);
    split_lane_init(sl[l], s, hit, sr, limit);
  }
  split_walk<W, TRI, true>(s, sl, buf, wc);
  for (int l = 0; l < W::N; ++l) {
    in_shadow[l] = sl[l].occ;
    add_counts(cs != nullptr ? cs[l] : h[l].c, sl[l].c);
  }
}

}  // namespace rt
