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
// walks the skip-pointer tree alone. Every arithmetic expression keeps the
// JAX kernel's order of operations; build with -fmad=false so that no
// multiply-add is contracted and edge accepts stay in step with the plain
// PyTorch versions. min/max propagate NaN like jnp.minimum/jnp.maximum
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
__device__ __forceinline__ void slab(const float* b, const Ray& r,
                                     float& tmin, float& tmax) {
  float tx0 = (ld(b + 0) - r.ox) * r.ix;
  float tx1 = (ld(b + 3) - r.ox) * r.ix;
  float ty0 = (ld(b + 1) - r.oy) * r.iy;
  float ty1 = (ld(b + 4) - r.oy) * r.iy;
  float tz0 = (ld(b + 2) - r.oz) * r.iz;
  float tz1 = (ld(b + 5) - r.oz) * r.iz;
  tmin = jmax(jmax(jmin(tx0, tx1), jmin(ty0, ty1)), jmin(tz0, tz1));
  tmax = jmin(jmin(jmax(tx0, tx1), jmax(ty0, ty1)), jmax(tz0, tz1));
}

// _pre_sphere: strict D > 0, inner hits only; no box gate (a sphere lies
// inside every box its row carries).
__device__ __forceinline__ bool pre_sphere(const float* p, const Ray& r,
                                           float& t) {
  float ocx = r.ox - ld(p + 1);
  float ocy = r.oy - ld(p + 2);
  float ocz = r.oz - ld(p + 3);
  float rad = ld(p + 4);
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
__device__ __forceinline__ bool plane_hit(const float* n, const Ray& r,
                                          float& t, float& hx, float& hy,
                                          float& hz) {
  float nx = ld(n), ny = ld(n + 1), nz = ld(n + 2);
  float d_n = r.dx * nx + r.dy * ny + r.dz * nz;
  float o_n = r.ox * nx + r.oy * ny + r.oz * nz;
  t = -(ld(n + 3) + o_n) / (d_n == 0.0f ? 1.0f : d_n);
  bool inner = (d_n > 0.0f) && (t > 0.0f);
  float tw = inner ? t : 0.0f;
  hx = r.ox + tw * r.dx;
  hy = r.oy + tw * r.dy;
  hz = r.oz + tw * r.dz;
  return inner;
}

// (h.e1 - s0, h.e2 - s1): a wall's (u, v), a barycentric triangle's
// (d20, d21).
__device__ __forceinline__ void project(const float* e, float hx, float hy,
                                        float hz, float& a, float& b) {
  a = hx * ld(e) + hy * ld(e + 1) + hz * ld(e + 2) - ld(e + 9);
  b = hx * ld(e + 3) + hy * ld(e + 4) + hz * ld(e + 5) - ld(e + 10);
}

// A wall keeps a plane hit inside its width x height rectangle; a
// degenerate basis (flag at e[14]) makes it an infinite plane.
__device__ __forceinline__ bool wall_inside(const float* e, float hx,
                                            float hy, float hz) {
  float u, v;
  project(e, hx, hy, hz, u, v);
  bool outside = (u < 0.0f) || (u > ld(e + 11)) || (v < 0.0f) ||
                 (v > ld(e + 12));
  return (ld(e + 14) > 0.0f) || !outside;
}

// The barycentric test of a plane hit with the premultiplied ratios; a
// degenerate triangle packs zeros and is always inside.
__device__ __forceinline__ bool bary_inside(const float* e, float hx,
                                            float hy, float hz) {
  float d20, d21;
  project(e, hx, hy, hz, d20, d21);
  float v = ld(e + 11) * d20 - ld(e + 12) * d21;
  float w = ld(e + 13) * d21 - ld(e + 12) * d20;
  float u = 1.0f - v - w;
  return !((u < 0.0f) || (v < 0.0f) || (w < 0.0f));
}

// Moller-Trumbore (double-sided), with its own t.
__device__ __forceinline__ bool mt_test(const float* e, const Ray& r,
                                        float& t) {
  float e1x = ld(e), e1y = ld(e + 1), e1z = ld(e + 2);
  float e2x = ld(e + 3), e2y = ld(e + 4), e2z = ld(e + 5);
  float hcx = r.dy * e2z - r.dz * e2y;
  float hcy = r.dz * e2x - r.dx * e2z;
  float hcz = r.dx * e2y - r.dy * e2x;
  float a = e1x * hcx + e1y * hcy + e1z * hcz;
  bool ok = fabsf(a) >= 1e-5f;
  float f = 1.0f / (ok ? a : 1.0f);
  float smx = r.ox - ld(e + 6);
  float smy = r.oy - ld(e + 7);
  float smz = r.oz - ld(e + 8);
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


// Camera and light scalars of the frame (the JAX kernel's par row):
// light pos(3) + color(3), camera pos/front/right/up (12), half_w, half_h,
// pixel-row offset of the window.
struct Params {
  float lx, ly, lz, lcr, lcg, lcb;
  float cpx, cpy, cpz, fx, fy, fz, rx, ry, rz, ux, uy, uz;
  float half_w, half_h, y_off;
};

__device__ __forceinline__ Params load_params(const float* par) {
  Params q;
  q.lx = ld(par + 0); q.ly = ld(par + 1); q.lz = ld(par + 2);
  q.lcr = ld(par + 3); q.lcg = ld(par + 4); q.lcb = ld(par + 5);
  q.cpx = ld(par + 6); q.cpy = ld(par + 7); q.cpz = ld(par + 8);
  q.fx = ld(par + 9); q.fy = ld(par + 10); q.fz = ld(par + 11);
  q.rx = ld(par + 12); q.ry = ld(par + 13); q.rz = ld(par + 14);
  q.ux = ld(par + 15); q.uy = ld(par + 16); q.uz = ld(par + 17);
  q.half_w = ld(par + 18); q.half_h = ld(par + 19); q.y_off = ld(par + 20);
  return q;
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
// arithmetic; the consume branch derives yi from the pixel index).
__device__ __forceinline__ void background(float yi, int H, float* bg) {
  float f_bg = yi / (float)H;
  bg[0] = BG_DARK_R + BG_SPAN_R * f_bg;
  bg[1] = BG_DARK_G + BG_SPAN_G * f_bg;
  bg[2] = BG_DARK_B + BG_SPAN_B * f_bg;
}

// Raygen: the primary ray and background of pixel (x, y) from the camera
// scalars (core/camera.get_rays + pixel_ndc, term by term).
__device__ __forceinline__ void primary_ray(const Params& q, int x, int y,
                                            int W, int H, State& st,
                                            float* bg) {
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
  background(yi, H, bg);
}

// One ray's Whitted trace over sh.bounces bounces (the bounce loop of
// _wholeframe_kernel), shared by the raygen, emit and consume modes: per
// bounce a closest walk with normals, a shadow walk with t_init = light
// distance, the material gather attr_tab[rid], Phong with 1/d attenuation
// and x0.3 shadows, and the reflection. rgb receives the colour added
// from the entry attenuation st.at*. A ray parked on entry (ox >= 1e30) is
// dead and adds nothing. On return st is the continuation state: the
// reflected ray while the ray lives; once it ends (a miss, or ks <= 0) the
// parked ray, with the attenuation frozen at its last value.
template <int TRI>
__device__ void trace_ray(const Tables& s, const float* tab, const Params& q,
                          const Shade& sh, const float* bg, State& st,
                          Counts& c, float* rgb) {
  float accr = 0.0f, accg = 0.0f, accb = 0.0f;
  float ox = st.ox, oy = st.oy, oz = st.oz;
  float dx = st.dx, dy = st.dy, dz = st.dz;
  float atr = st.atr, atg = st.atg, atb = st.atb;
  bool alive = ox < 1e30f;
  for (int b = 0; b < sh.bounces && alive; ++b) {
    Ray ray = make_ray(ox, oy, oz, dx, dy, dz);
    Hit h = closest_walk<TRI, true>(s, G_RID, T_RID, ray, INF, c);
    if (!(h.t < INF)) {   // miss: background, and the ray ends
      accr = accr + atr * bg[0];
      accg = accg + atg * bg[1];
      accb = accb + atb * bg[2];
      alive = false;
      break;
    }
    float px = ox + h.t * dx;
    float py = oy + h.t * dy;
    float pz = oz + h.t * dz;
    float ldx = q.lx - px;
    float ldy = q.ly - py;
    float ldz = q.lz - pz;
    float dist = sqrtf(ldx * ldx + ldy * ldy + ldz * ldz);
    bool in_shadow = false;
    if (sh.enable_shadows) {
      float inv = 1.0f / jmax(dist, 1e-30f);
      Ray sray = make_ray(px + h.nx * sh.shadow_eps, py + h.ny * sh.shadow_eps,
                          pz + h.nz * sh.shadow_eps, ldx * inv, ldy * inv,
                          ldz * inv);
      Hit sh_hit = closest_walk<TRI, false>(s, G_RID, T_RID, sray, dist, c);
      in_shadow = sh_hit.t < dist;
    }

    const float* mat = tab + (int)h.id * ATTR_W;
    float mcr = ld(mat + 3), mcg = ld(mat + 4), mcb = ld(mat + 5);
    float ka = ld(mat + 6), kd = ld(mat + 7), ks = ld(mat + 8);
    float kf = ld(mat + 9), shin = ld(mat + 10);

    float dist_p = sqrtf(jmax(ldx * ldx + ldy * ldy + ldz * ldz, 1e-30f));
    float lc_r = q.lcr / dist_p;
    float lc_g = q.lcg / dist_p;
    float lc_b = q.lcb / dist_p;
    float ldnx = ldx / dist_p;
    float ldny = ldy / dist_p;
    float ldnz = ldz / dist_p;
    float diff = jmax(h.nx * ldnx + h.ny * ldny + h.nz * ldnz, 0.0f);
    float dotln = h.nx * ldnx + h.ny * ldny + h.nz * ldnz;
    float rdx = -ldnx + 2.0f * dotln * h.nx;
    float rdy = -ldny + 2.0f * dotln * h.ny;
    float rdz = -ldnz + 2.0f * dotln * h.nz;
    float spec_cos = jmax(dx * rdx + dy * rdy + dz * rdz, 0.0f);
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
    accr = accr + atr * col_r;
    accg = accg + atg * col_g;
    accb = accb + atb * col_b;

    if (!(ks > 0.0f)) {   // no reflection: the ray ends
      alive = false;
      break;
    }
    float dotdn = h.nx * dx + h.ny * dy + h.nz * dz;
    float ndx = dx - 2.0f * dotdn * h.nx;
    float ndy = dy - 2.0f * dotdn * h.ny;
    float ndz = dz - 2.0f * dotdn * h.nz;
    if (sh.use_fresnel) {
      float cosr = jmax(-(ndx * h.nx + ndy * h.ny + ndz * h.nz), 0.0f);
      float x1 = 1.0f - cosr;
      float x2 = x1 * x1;
      float x5 = x1 * (x2 * x2);   // lax.integer_pow(x, 5)
      float f = jmin(jmax(x5, 0.0f), 0.8f);
      float w = kf * f;
      float natr = atr * (mcr + (1.0f - mcr) * w);
      float natg = atg * (mcg + (1.0f - mcg) * w);
      float natb = atb * (mcb + (1.0f - mcb) * w);
      // the extra term is NOT attenuated (reference double-count)
      accr = accr + (1.0f - w) * mcr * col_r;
      accg = accg + (1.0f - w) * mcg * col_g;
      accb = accb + (1.0f - w) * mcb * col_b;
      atr = natr; atg = natg; atb = natb;
    } else {
      atr = atr * ks; atg = atg * ks; atb = atb * ks;
    }
    ox = px + h.nx * sh.reflect_eps;
    oy = py + h.ny * sh.reflect_eps;
    oz = pz + h.nz * sh.reflect_eps;
    dx = ndx; dy = ndy; dz = ndz;
  }
  if (!alive && sh.bounces > 0) {   // an ended ray leaves the parked ray
    ox = PARK_ORIGIN; oy = PARK_ORIGIN; oz = PARK_ORIGIN;
    dx = PARK_DIR; dy = PARK_DIR; dz = PARK_DIR;
  }
  st.ox = ox; st.oy = oy; st.oz = oz;
  st.dx = dx; st.dy = dy; st.dz = dz;
  st.atr = atr; st.atg = atg; st.atb = atb;
  rgb[0] = accr;
  rgb[1] = accg;
  rgb[2] = accb;
}

// _fused_kernel for one ray: the closest hit with normals, then, in the
// same thread, the shadow ray from p + n * shadow_eps toward the light,
// walked with t_init = limit (the light distance), so in_shadow = st <
// limit. A miss parks the shadow ray with limit 0: unshadowed. A parked
// input ray misses.
template <int TRI>
__device__ void fused_ray(const Tables& s, const Ray& r, float lx, float ly,
                          float lz, float shadow_eps, Counts& c, float& t,
                          float& gid, bool& in_shadow) {
  Hit h = closest_walk<TRI, true>(s, G_GID, T_GID, r, INF, c);
  bool hit = h.t < INF;
  float ts = hit ? h.t : 0.0f;
  float px = r.ox + ts * r.dx;
  float py = r.oy + ts * r.dy;
  float pz = r.oz + ts * r.dz;
  float ldx = lx - px;
  float ldy = ly - py;
  float ldz = lz - pz;
  float dist = sqrtf(ldx * ldx + ldy * ldy + ldz * ldz);
  float inv = 1.0f / jmax(dist, 1e-30f);   // normalize(.., eps=1e-30)
  Ray sray = hit ? make_ray(px + h.nx * shadow_eps, py + h.ny * shadow_eps,
                            pz + h.nz * shadow_eps, ldx * inv, ldy * inv,
                            ldz * inv)
                 : make_ray(PARK_ORIGIN, PARK_ORIGIN, PARK_ORIGIN, PARK_DIR,
                            PARK_DIR, PARK_DIR);
  float limit = hit ? dist : 0.0f;
  Hit sh_hit = closest_walk<TRI, false>(s, G_GID, T_GID, sray, limit, c);
  t = h.t;
  gid = h.id;
  in_shadow = sh_hit.t < limit;
}

// _resolve_kernel for one ray: the shading attributes of row max(gid, 0)
// of attr_tab (n(3), color(3), ka, kd, ks, kf, shininess), where a
// sphere's normal comes from the hit point p, blended by is_sphere as the
// JAX kernel does. 1/sqrt is IEEE division of a correctly rounded root
// (not rsqrtf, which is not correctly rounded). The row is clamped to the
// table, as the plain version clamps it.
__device__ __forceinline__ void resolve_ray(const float* tab, int n_tab,
                                            float gid, float px, float py,
                                            float pz, float* a) {
  int si = (int)jmax(gid, 0.0f);
  si = si < n_tab ? si : n_tab - 1;
  const float* row = tab + si * ATTR_W;
  float is_s = ld(row + 14);
  float rx = px - ld(row + 11);
  float ry = py - ld(row + 12);
  float rz = pz - ld(row + 13);
  float inv = 1.0f / sqrtf(rx * rx + ry * ry + rz * rz + 1e-30f);
  a[0] = is_s * (rx * inv) + (1.0f - is_s) * ld(row + 0);
  a[1] = is_s * (ry * inv) + (1.0f - is_s) * ld(row + 1);
  a[2] = is_s * (rz * inv) + (1.0f - is_s) * ld(row + 2);
  for (int k = 3; k < 11; ++k) a[k] = ld(row + k);
}

// ---- The packet-BVH and brute-force kernels' per-ray code -------------
// Both test the 24-column packed rows (geom/rowwise.py::intersect_rows).

// _row_intersect for one ray and one row, by the row's type: t and inner
// as the JAX union test gives them (sphere (-b - sq) / 2a; plane, wall and
// barycentric triangle t_pl; Moller-Trumbore its own t). Counts the test
// in c.tri (triangles) or c.pre (other rows).
template <bool MT>
__device__ __forceinline__ bool row_intersect(const float* p, const Ray& r,
                                              float& t, Counts& c) {
  int typ = (int)ld(p);
  if (typ != TRIANGLE) c.pre += 1;
  if (typ == SPHERE) return pre_sphere(p, r, t);
  if (typ == TRIANGLE) {
    c.tri += 1;
    if (MT) return mt_test(p + 9, r, t);
  }
  float hx, hy, hz;
  bool v_pl = plane_hit(p + 5, r, t, hx, hy, hz);
  if (typ == PLANE) return v_pl;
  if (typ == WALL) return v_pl && wall_inside(p + 9, hx, hy, hz);
  return typ == TRIANGLE && v_pl && bary_inside(p + 9, hx, hy, hz);
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

// _packet_kernel / _occlusion_kernel for one ray: the skip-pointer walk,
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

// _closest_hit_kernel for one ray: every row in type-sorted order, one
// loop per type (counts n[0..3] of spheres, planes, walls, triangles),
// each hit gated by its row's leaf box with GATE. The first row of the
// least t wins; t INF and row 0 on a miss.
template <bool MT, bool GATE>
__device__ void brute_ray(const float* rows, const int* n, const Ray& r,
                          float& t_best, int& best) {
  t_best = INF;
  best = 0;
  int i = 0;
  const float* p = rows;
  for (int e = n[0]; i < e; ++i, p += ROW_EXT_W) {
    float t;
    bool inner = pre_sphere(p, r, t);
    if (GATE) inner = inner && box_gate(p + R_B0X, r);
    if (inner && t < t_best) { t_best = t; best = i; }
  }
  for (int e = i + n[1]; i < e; ++i, p += ROW_EXT_W) {
    float t, hx, hy, hz;
    bool inner = plane_hit(p + 5, r, t, hx, hy, hz);
    if (GATE) inner = inner && box_gate(p + R_B0X, r);
    if (inner && t < t_best) { t_best = t; best = i; }
  }
  for (int e = i + n[2]; i < e; ++i, p += ROW_EXT_W) {
    float t, hx, hy, hz;
    bool inner = plane_hit(p + 5, r, t, hx, hy, hz) &&
                 wall_inside(p + 9, hx, hy, hz);
    if (GATE) inner = inner && box_gate(p + R_B0X, r);
    if (inner && t < t_best) { t_best = t; best = i; }
  }
  for (int e = i + n[3]; i < e; ++i, p += ROW_EXT_W) {
    float t;
    bool inner;
    if (MT) {
      inner = mt_test(p + 9, r, t);
    } else {
      float hx, hy, hz;
      inner = plane_hit(p + 5, r, t, hx, hy, hz) &&
              bary_inside(p + 9, hx, hy, hz);
    }
    if (GATE) inner = inner && box_gate(p + R_B0X, r);
    if (inner && t < t_best) { t_best = t; best = i; }
  }
}

}  // namespace rt
