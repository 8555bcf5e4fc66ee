// Device functions of the port's path-tracing kernels (CUDA C++, sm_90a).
//
// One thread traces one lane at a time (kernel 9 hands a thread a new lane
// when its path ends: path_init, path_bounce and path_finish are the steps
// of trace_path_t).  The scene and the material table are packed
// tables in device memory (ops/cuda_trace.py HostScene, ops/cuda_path.py
// HostMaterials); kernels 1-4 and 7 copy the primitive rows into shared
// memory once per block (stage_rows).  Every thread of a warp walks the same
// primitive row at the same time, so each row load is a broadcast.  Nothing
// is baked per scene.
//
// The arithmetic follows the plain PyTorch versions (ops/cuda_trace.py
// intersect_lanes, ops/cuda_path.py build_path_core / build_fused_raygen)
// operation for operation and in the same order, compiled with -fmad=false
// and without fast math, so the two agree bit for bit on almost every lane.
// Each .cu file of csrc/ is its own library (ops/_build.py) and includes
// this header.
//
// The body is a template on its number type T (csrc/fspt_tangent.cuh),
// float for every kernel (1-4, 7, 8, 9, and the forward trace of the
// reverse-mode adjoints 10 and 8's whole chain, which record each bounce's
// state through the direct mode's sink).  Comparisons and branches read
// val(x).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "fspt_tangent.cuh"

namespace fspt {

// Constants as the reference rounds them: its Python float64 constants are
// converted to float32 where they meet float32 data.
constexpr float kPi = 3.14159262f;                      // math/base.h:80
constexpr float kTwoPi = (float)(2.0 * 3.14159262);
constexpr float kHalfPi = (float)(0.5 * 3.14159262);
constexpr float kEps = 1.0e-5f;                          // math/base.h:83
constexpr float kInvalid = 2.0f;                         // math/trace.cpp:18-21
constexpr float kUnit24 = 1.0f / 16777216.0f;

// Primitive kinds (merge order) and material families.
enum { SPHERE = 0, PLANE = 1, DISC = 2, QUAD = 3, CUBOID = 4, TRIANGLE = 5 };
enum { DIFFUSE = 0, LIGHT = 1, METAL = 2, MIRROR = 3, GLASS = 4, LIQUID = 5,
       CERAMIC = 6, GLOW = 7, FOG = 8 };

// Table layouts (must match ops/cuda_trace.py and ops/cuda_path.py).
constexpr int kPrimStride = 32;   // floats per primitive row
constexpr int kMaxPrims = 512;    // rows at most (MAX_SPECIALIZED_PRIMS)
constexpr int kMatStride = 16;    // floats per material row
constexpr int kMetaStride = 3;    // ints per material meta row
// Material row: diffuse 0..2, emissive 3..5, glow 6..8, param 9, ior 10,
// reflectivity 11, frost 12.  Material meta: (mtype, flags, tex_id); the
// texture id decides a row's deferred regime at run time.
constexpr int kFlagGlassStraight = 1;   // |ior - 1| < EPS
constexpr int kFlagFrostFull = 2;       // |pi*frost - pi| < EPS
constexpr int kFlagFrostNone = 4;       // |pi*frost| < EPS
constexpr int kFlagMetalSmooth = 8;     // roughness <= 0.95

struct PathParams {
  float ray_offset;
  float seg_scale;   // z_far - ray_offset
  float z_far;
  float light_clamp;
  float sky_e[3];    // sky emission x3
  int depth;
  int bounce_slots;
  int sky_idx;
  int fast_render;
  int n_prims;
  int n_mats;
};

struct CamParams {
  float origin[3];
  float proj_origin[3];
  float right[3];
  float up[3];
  float focal_plane[4];
  float half_w, half_h, inv_wm1, inv_hm1;
  float aperture;
  float z_far;
  int width;
  int spp;
  int dof;
};

// --- counter-based RNG (bit-identical to ops/rng.py) ----------------------

__device__ __forceinline__ uint32_t pcg(uint32_t x) {
  x = x * 747796405u + 2891336453u;
  uint32_t word = ((x >> ((x >> 28u) + 4u)) ^ x) * 277803737u;
  return (word >> 22u) ^ word;
}

// pcg(pcg(h0 + pixel) + sample): the prefix shared by a lane's draws.
__device__ __forceinline__ uint32_t sample_hash(uint32_t h0, uint32_t pix,
                                                uint32_t smp) {
  return pcg(pcg(h0 + pix) + smp);
}

__device__ __forceinline__ float uniform(uint32_t hs, uint32_t ctr) {
  return (float)(pcg(hs + ctr) >> 8u) * kUnit24;
}

// --- small vector helpers --------------------------------------------------

template <class T>
__device__ __forceinline__ void norm3(T& x, T& y, T& z) {
  T n2 = x * x + y * y + z * z;
  T inv = val(n2) > 0.0f ? rsqrt_(n2) : T(0.0f);
  x = x * inv;
  y = y * inv;
  z = z * inv;
}

template <class T>
__device__ __forceinline__ T pow25(T x) {
  T x2 = x * x;
  T x4 = x2 * x2;
  T x8 = x4 * x4;
  T x16 = x8 * x8;
  return x16 * x8 * x;
}

// Polynomial atan2 of the reference (pallas_trace.py:101-118), not atan2f.
__device__ __forceinline__ float atan2_poly(float y, float x) {
  float ax = fabsf(x), ay = fabsf(y);
  float mx = fmaxf(ax, ay), mn = fminf(ax, ay);
  float z = mn / (mx > 0.0f ? mx : 1.0f);
  float z2 = z * z;
  float p = z * (0.9998660f + z2 * (-0.3302995f + z2 * (0.1801410f
                 + z2 * (-0.0851330f + z2 * 0.0208351f))));
  float r = ay > ax ? kHalfPi - p : p;
  r = x < 0.0f ? kPi - r : r;
  return y < 0.0f ? -r : r;
}

// --- closest hit over the primitive table ---------------------------------

struct Hit {
  float t, nx, ny, nz;
  int mat, kind;
  float u, v;
  int prim;  // the winning table row, -1 on a miss
};

// Strict-< merge: the first primitive wins ties (the reference's order).
__device__ __forceinline__ void merge(Hit& h, float t, bool valid, float nx,
                                      float ny, float nz, int mat, int kind,
                                      int prim) {
  if (valid && t < h.t) {
    h.t = t; h.nx = nx; h.ny = ny; h.nz = nz; h.mat = mat; h.kind = kind;
    h.prim = prim;
  }
}

// The closest hit so far as its row alone (kernel 1's walk): its t, its
// row and, for a triangle, the barycentrics.  merge() and the row tests
// then keep nothing else, and winner_hit() reads the normal, material,
// kind and texcoords from the winning row after the walk, with the
// operations the tests would have done.
struct RowHit {
  float t;
  int prim;  // -1 on a miss
  float ub, vb;
};

__device__ __forceinline__ void merge(RowHit& h, float t, bool valid, float, float, float,
                                      int, int, int prim) {
  if (valid && t < h.t) {
    h.t = t;
    h.prim = prim;
  }
}

// Where the body reads the primitive table, and how it walks it (every
// thread of a warp reads the same row at the same time, so each load is a
// broadcast).  TableRows: the table in device memory, each row's floats
// loaded one at a time through the read-only cache, a switch on each row's
// kind (kernels 8-10).  SmemRows: a block's own copy in shared memory
// (stage_rows), 16-byte loads, and the first row of each kind, so the walk
// runs one loop a kind with no switch (kernels 1-4, 7): the rows are in merge
// order (ops/cuda_trace.py HostScene), which sorts them by kind.  The
// factored row tests below, tried on the table in device memory, made
// kernel 8 slower on a table of many spheres (PERF.md §6), so that table
// keeps its own walk.
struct TableRows {
  static constexpr bool kByKind = false;
  const float* __restrict__ prims;  // [n_prims][kPrimStride]
  const int* __restrict__ meta;     // [n_prims][2]
};

struct SmemRows {
  static constexpr bool kByKind = true;
  const float4* prims;  // [n_prims][kPrimStride / 4]
  const int2* meta;     // [n_prims]
  const int* first;     // [TRIANGLE + 2]: the first row of each kind; n_prims last

  __device__ __forceinline__ int2 kind_mat(int p) const { return meta[p]; }
  __device__ __forceinline__ float4 row(int p, int j) const {
    return prims[p * (kPrimStride / 4) + j];
  }
};

// The closest-hit test of row p of each kind (pallas_trace.py:189), merged
// into h (a Hit, or a RowHit).  kTex adds the texcoords of a triangle
// winner.
template <class H, class Rows>
__device__ __forceinline__ void test_sphere(H& h, const Rows& rows, int p, int mat,
                                            float sx, float sy, float sz, float dx,
                                            float dy, float dz) {
  const float4 q0 = rows.row(p, 0);
  const float c0 = q0.x, c1 = q0.y, c2 = q0.z;
  const float r = q0.w, inv_r = rows.row(p, 1).x;
  float ox = sx - c0, oy = sy - c1, oz = sz - c2;
  float a = dx * dx + dy * dy + dz * dz;
  float b = 2.0f * (ox * dx + oy * dy + oz * dz);
  float oc2 = ox * ox + oy * oy + oz * oz;
  float rr = r * r;
  float cc = oc2 - rr;
  float disc = b * b - 4.0f * a * cc;
  float sq = sqrtf(disc >= 0.0f ? disc : 1.0f);
  bool inside = oc2 <= rr;
  float tc = (inside ? -b + sq : -b - sq) / (2.0f * a);
  bool valid = (disc >= 0.0f) && (tc >= 0.0f) && (tc <= 1.0f);
  if (valid && tc < h.t) {
    float px = sx + dx * tc, py = sy + dy * tc, pz = sz + dz * tc;
    merge(h, tc, true, (px - c0) * inv_r, (py - c1) * inv_r, (pz - c2) * inv_r, mat,
          SPHERE, p);
  }
}

// A triangle winner's texcoords (kTex; texcoords at 19..24), or, for a
// RowHit, its barycentrics.
template <bool kTex, class Rows>
__device__ __forceinline__ void tri_texcoords(Hit& h, const Rows& rows, int p,
                                              const float4& q4, float ub, float vb) {
  if (kTex) {
    const float4 q5 = rows.row(p, 5), q6 = rows.row(p, 6);
    h.u = q4.w + q5.y * ub + q5.w * vb;
    h.v = q5.x + q5.z * ub + q6.x * vb;
  }
}

template <bool kTex, class Rows>
__device__ __forceinline__ void tri_texcoords(RowHit& h, const Rows&, int, const float4&,
                                              float ub, float vb) {
  h.ub = ub;
  h.vb = vb;
}

template <bool kTex, class H, class Rows>
__device__ __forceinline__ void test_triangle(H& h, const Rows& rows, int p, int mat,
                                              float sx, float sy, float sz, float dx,
                                              float dy, float dz) {
  const float4 q0 = rows.row(p, 0), q1 = rows.row(p, 1), q2 = rows.row(p, 2);
  const float v0x = q0.x, v0y = q0.y, v0z = q0.z;
  const float e1x = q0.w, e1y = q1.x, e1z = q1.y;
  const float e2x = q1.z, e2y = q1.w, e2z = q2.x;
  const float eps_area = q2.y;
  float pvx = dy * e2z - dz * e2y;
  float pvy = dz * e2x - dx * e2z;
  float pvz = dx * e2y - dy * e2x;
  float det = e1x * pvx + e1y * pvy + e1z * pvz;
  bool np = fabsf(det) >= eps_area;
  float inv = 1.0f / (np ? det : 1.0f);
  float tx = sx - v0x, ty = sy - v0y, tz = sz - v0z;
  float ub = (tx * pvx + ty * pvy + tz * pvz) * inv;
  float qvx = ty * e1z - tz * e1y;
  float qvy = tz * e1x - tx * e1z;
  float qvz = tx * e1y - ty * e1x;
  float vb = (dx * qvx + dy * qvy + dz * qvz) * inv;
  float tc = (e2x * qvx + e2y * qvy + e2z * qvz) * inv;
  bool valid = np && (ub >= 0.0f) && (vb >= 0.0f) && (ub + vb <= 1.0f)
               && (tc >= 0.0f) && (tc <= 1.0f);
  if (valid && tc < h.t) {
    // Vertex normals n0, n1 - n0, n2 - n0 at 10..18.
    const float4 q3 = rows.row(p, 3), q4 = rows.row(p, 4);
    float inx = q2.z + q3.y * ub + q4.x * vb;
    float iny = q2.w + q3.z * ub + q4.y * vb;
    float inz = q3.x + q3.w * ub + q4.z * vb;
    merge(h, tc, true, inx, iny, inz, mat, TRIANGLE, p);
    tri_texcoords<kTex>(h, rows, p, q4, ub, vb);
  }
}

// Plane-based kinds: plane, disc, quad, cuboid face.
template <class H, class Rows>
__device__ __forceinline__ void test_planar(H& h, const Rows& rows, int p, int kind,
                                            int mat, float sx, float sy, float sz,
                                            float dx, float dy, float dz) {
  const float4 q0 = rows.row(p, 0);
  const float p0 = q0.x, p1 = q0.y, p2 = q0.z;
  const float pw = q0.w;
  float ts = p0 * dx + p1 * dy + p2 * dz;
  float ns = -(p0 * sx + p1 * sy + p2 * sz + pw);
  bool np = fabsf(ts) >= kEps;
  float tc = ns / (np ? ts : 1.0f);
  bool valid = np && (tc >= 0.0f) && (tc <= 1.0f);
  // The bounds test only where the hit could win the strict-< merge:
  // behind the closest hit so far, its outcome changes nothing.
  if (kind != PLANE && valid && tc < h.t) {
    float px = sx + dx * tc, py = sy + dy * tc, pz = sz + dz * tc;
    const float4 q1 = rows.row(p, 1);
    if (kind == CUBOID) {
      // Adjacent-face half-spaces (object.cpp:140-150), at 4..19.
      float dist = q1.x * px + q1.y * py + q1.z * pz + q1.w;
      valid = valid && (dist <= 0.0f);
#pragma unroll
      for (int j = 2; j < 5; ++j) {
        const float4 sj = rows.row(p, j);
        dist = sj.x * px + sj.y * py + sj.z * pz + sj.w;
        valid = valid && (dist <= 0.0f);
      }
    } else {
      // Center at 4..6; disc: radius at 7; quad: axes at 7..12, half
      // extents at 13, 14.
      float ex = px - q1.x, ey = py - q1.y, ez = pz - q1.z;
      if (kind == DISC) {
        float r = q1.w;
        valid = (ex * ex + ey * ey + ez * ez) <= r * r;
      } else {  // QUAD
        const float4 q2 = rows.row(p, 2), q3 = rows.row(p, 3);
        float td = q1.w * ex + q2.x * ey + q2.y * ez;
        float bd = q2.z * ex + q2.w * ey + q3.x * ez;
        valid = (fabsf(bd) <= q3.y) && (fabsf(td) <= q3.z);
      }
    }
  }
  merge(h, tc, valid, p0, p1, p2, mat, kind, p);
}

// A segment start + seg*t, t in [0, 1].
struct Seg {
  float sx, sy, sz, dx, dy, dz;
};

__device__ __forceinline__ Hit no_hit() {
  return Hit{kInvalid, 0.0f, 0.0f, 0.0f, -1, -1, 0.0f, 0.0f, -1};
}

// Kernel 1's walk of staged rows one kind at a time (rows in merge order,
// so row order and ties are kept), for K segments at once: each row's
// material and the loads its tests share are read once for all K.
template <bool kTex, int K, class H>
__device__ __forceinline__ void walk_kinds(const SmemRows& rows, const Seg (&s)[K],
                                           H (&h)[K]) {
  const int* f = rows.first;
  for (int p = f[SPHERE]; p < f[PLANE]; ++p) {
    const int mat = rows.kind_mat(p).y;
#pragma unroll
    for (int k = 0; k < K; ++k)
      test_sphere(h[k], rows, p, mat, s[k].sx, s[k].sy, s[k].sz, s[k].dx, s[k].dy, s[k].dz);
  }
#pragma unroll
  for (int kind = PLANE; kind <= CUBOID; ++kind) {
    for (int p = f[kind]; p < f[kind + 1]; ++p) {
      const int mat = rows.kind_mat(p).y;
#pragma unroll
      for (int k = 0; k < K; ++k)
        test_planar(h[k], rows, p, kind, mat, s[k].sx, s[k].sy, s[k].sz, s[k].dx, s[k].dy,
                    s[k].dz);
    }
  }
  for (int p = f[TRIANGLE]; p < f[TRIANGLE + 1]; ++p) {
    const int mat = rows.kind_mat(p).y;
#pragma unroll
    for (int k = 0; k < K; ++k)
      test_triangle<kTex>(h[k], rows, p, mat, s[k].sx, s[k].sy, s[k].sz, s[k].dx, s[k].dy,
                          s[k].dz);
  }
}

// The Hit of a RowHit: the winning row's normal (a sphere's at the hit
// point, a plane's own, a triangle's interpolated), material and kind, and
// a triangle's texcoords (kTex), by the operations of the row tests.
template <bool kTex>
__device__ __forceinline__ Hit winner_hit(const SmemRows& rows, const RowHit& r,
                                          const Seg& s) {
  Hit h = no_hit();
  const int p = r.prim;
  if (p < 0) return h;
  const int2 km = rows.kind_mat(p);
  const float4 q0 = rows.row(p, 0);
  h.t = r.t;
  h.mat = km.y;
  h.kind = km.x;
  h.prim = p;
  if (km.x == SPHERE) {
    const float inv_r = rows.row(p, 1).x;
    float px = s.sx + s.dx * r.t, py = s.sy + s.dy * r.t, pz = s.sz + s.dz * r.t;
    h.nx = (px - q0.x) * inv_r;
    h.ny = (py - q0.y) * inv_r;
    h.nz = (pz - q0.z) * inv_r;
  } else if (km.x == TRIANGLE) {
    const float4 q2 = rows.row(p, 2), q3 = rows.row(p, 3), q4 = rows.row(p, 4);
    h.nx = q2.z + q3.y * r.ub + q4.x * r.vb;
    h.ny = q2.w + q3.z * r.ub + q4.y * r.vb;
    h.nz = q3.x + q3.w * r.ub + q4.z * r.vb;
    tri_texcoords<kTex>(h, rows, p, q4, r.ub, r.vb);
  } else {
    h.nx = q0.x;
    h.ny = q0.y;
    h.nz = q0.z;
  }
  return h;
}

// The texcoords of the winner (kTex: sphere map, planar map, cuboid x0.1;
// a triangle's are merged in the walk), and a miss's material 0.
template <bool kTex>
__device__ __forceinline__ void finish_hit(Hit& h, float sx, float sy, float sz, float dx,
                                           float dy, float dz) {
  if (kTex) {
    float px = sx + dx * h.t, py = sy + dy * h.t, pz = sz + dz * h.t;
    float su = atan2_poly(h.nx, h.nz) / kTwoPi + 0.5f;
    float sv = 1.0f - (h.ny * 0.5f + 0.5f);
    bool use_x = (h.nx > h.ny) && (h.nx > h.nz);
    bool use_y = (h.ny > h.nx) && (h.ny > h.nz) && !use_x;
    float pu = use_x ? py : px;
    float pv = use_x ? pz : (use_y ? pz : py);
    float scale = h.kind == CUBOID ? 0.1f : 1.0f;
    if (h.kind == SPHERE) {
      h.u = su;
      h.v = sv;
    } else if (h.kind != TRIANGLE) {
      h.u = pu * scale;
      h.v = pv * scale;
    }
  }
  h.mat = h.mat > 0 ? h.mat : 0;
}

// intersect_lanes (pallas_trace.py:189): closest hit of the segment
// start + seg*t, t in [0,1], over n_prims packed rows, in row order.  kTex
// adds the texcoords of the winner (sphere map, planar map, cuboid x0.1,
// triangle barycentric); only the deferred modes of the path body need them.
template <bool kTex, class Rows>
__device__ __forceinline__ Hit intersect_lanes(const Rows& rows, int n_prims,
                               float sx, float sy, float sz,
                               float dx, float dy, float dz) {
  Hit h = no_hit();
  if constexpr (Rows::kByKind) {
    // The path body's own loops: through walk_kinds<kTex, 1> kernels 2-4
    // ran 3 % slower (PERF.md §6).
    const int* f = rows.first;
    for (int p = f[SPHERE]; p < f[PLANE]; ++p)
      test_sphere(h, rows, p, rows.kind_mat(p).y, sx, sy, sz, dx, dy, dz);
#pragma unroll
    for (int kind = PLANE; kind <= CUBOID; ++kind) {
      for (int p = f[kind]; p < f[kind + 1]; ++p)
        test_planar(h, rows, p, kind, rows.kind_mat(p).y, sx, sy, sz, dx, dy, dz);
    }
    for (int p = f[TRIANGLE]; p < f[TRIANGLE + 1]; ++p)
      test_triangle<kTex>(h, rows, p, rows.kind_mat(p).y, sx, sy, sz, dx, dy, dz);
  } else {
    for (int p = 0; p < n_prims; ++p) {
      const float* q = rows.prims + p * kPrimStride;
      const int kind = __ldg(rows.meta + 2 * p);
      const int mat = __ldg(rows.meta + 2 * p + 1);
      if (kind == SPHERE) {
        const float c0 = __ldg(q), c1 = __ldg(q + 1), c2 = __ldg(q + 2);
        const float r = __ldg(q + 3), inv_r = __ldg(q + 4);
        float ox = sx - c0, oy = sy - c1, oz = sz - c2;
        float a = dx * dx + dy * dy + dz * dz;
        float b = 2.0f * (ox * dx + oy * dy + oz * dz);
        float oc2 = ox * ox + oy * oy + oz * oz;
        float rr = r * r;
        float cc = oc2 - rr;
        float disc = b * b - 4.0f * a * cc;
        float sq = sqrtf(disc >= 0.0f ? disc : 1.0f);
        bool inside = oc2 <= rr;
        float tc = (inside ? -b + sq : -b - sq) / (2.0f * a);
        bool valid = (disc >= 0.0f) && (tc >= 0.0f) && (tc <= 1.0f);
        if (valid && tc < h.t) {
          float px = sx + dx * tc, py = sy + dy * tc, pz = sz + dz * tc;
          merge(h, tc, true, (px - c0) * inv_r, (py - c1) * inv_r,
                (pz - c2) * inv_r, mat, SPHERE, p);
        }
      } else if (kind == TRIANGLE) {
        const float v0x = __ldg(q), v0y = __ldg(q + 1), v0z = __ldg(q + 2);
        const float e1x = __ldg(q + 3), e1y = __ldg(q + 4), e1z = __ldg(q + 5);
        const float e2x = __ldg(q + 6), e2y = __ldg(q + 7), e2z = __ldg(q + 8);
        const float eps_area = __ldg(q + 9);
        float pvx = dy * e2z - dz * e2y;
        float pvy = dz * e2x - dx * e2z;
        float pvz = dx * e2y - dy * e2x;
        float det = e1x * pvx + e1y * pvy + e1z * pvz;
        bool np = fabsf(det) >= eps_area;
        float inv = 1.0f / (np ? det : 1.0f);
        float tx = sx - v0x, ty = sy - v0y, tz = sz - v0z;
        float ub = (tx * pvx + ty * pvy + tz * pvz) * inv;
        float qvx = ty * e1z - tz * e1y;
        float qvy = tz * e1x - tx * e1z;
        float qvz = tx * e1y - ty * e1x;
        float vb = (dx * qvx + dy * qvy + dz * qvz) * inv;
        float tc = (e2x * qvx + e2y * qvy + e2z * qvz) * inv;
        bool valid = np && (ub >= 0.0f) && (vb >= 0.0f) && (ub + vb <= 1.0f)
                     && (tc >= 0.0f) && (tc <= 1.0f);
        if (valid && tc < h.t) {
          float inx = __ldg(q + 10) + __ldg(q + 13) * ub + __ldg(q + 16) * vb;
          float iny = __ldg(q + 11) + __ldg(q + 14) * ub + __ldg(q + 17) * vb;
          float inz = __ldg(q + 12) + __ldg(q + 15) * ub + __ldg(q + 18) * vb;
          merge(h, tc, true, inx, iny, inz, mat, TRIANGLE, p);
          if (kTex) {
            h.u = __ldg(q + 19) + __ldg(q + 21) * ub + __ldg(q + 23) * vb;
            h.v = __ldg(q + 20) + __ldg(q + 22) * ub + __ldg(q + 24) * vb;
          }
        }
      } else {
        // Plane-based kinds: plane, disc, quad, cuboid face.
        const float p0 = __ldg(q), p1 = __ldg(q + 1), p2 = __ldg(q + 2);
        const float pw = __ldg(q + 3);
        float ts = p0 * dx + p1 * dy + p2 * dz;
        float ns = -(p0 * sx + p1 * sy + p2 * sz + pw);
        bool np = fabsf(ts) >= kEps;
        float tc = ns / (np ? ts : 1.0f);
        bool valid = np && (tc >= 0.0f) && (tc <= 1.0f);
        // The bounds test only where the hit could win the strict-< merge:
        // behind the closest hit so far, its outcome changes nothing.
        if (kind != PLANE && valid && tc < h.t) {
          float px = sx + dx * tc, py = sy + dy * tc, pz = sz + dz * tc;
          if (kind == CUBOID) {
            // Adjacent-face half-spaces (object.cpp:140-150).
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float* s = q + 4 + 4 * j;
              float dist = __ldg(s) * px + __ldg(s + 1) * py + __ldg(s + 2) * pz
                           + __ldg(s + 3);
              valid = valid && (dist <= 0.0f);
            }
          } else {
            float ex = px - __ldg(q + 4), ey = py - __ldg(q + 5),
                  ez = pz - __ldg(q + 6);
            if (kind == DISC) {
              float r = __ldg(q + 7);
              valid = (ex * ex + ey * ey + ez * ez) <= r * r;
            } else {  // QUAD
              float td = __ldg(q + 7) * ex + __ldg(q + 8) * ey + __ldg(q + 9) * ez;
              float bd = __ldg(q + 10) * ex + __ldg(q + 11) * ey + __ldg(q + 12) * ez;
              valid = (fabsf(bd) <= __ldg(q + 13)) && (fabsf(td) <= __ldg(q + 14));
            }
          }
        }
        merge(h, tc, valid, p0, p1, p2, mat, kind, p);
      }
    }
  }
  finish_hit<kTex>(h, sx, sy, sz, dx, dy, dz);
  return h;
}

// --- path body (pallas_path.py build_path_core) ---------------------------

// normal_sphere::random_reflection: lerp the hemisphere sample g with the
// mirror direction r by amount, normalize, flip into the normal's side.
template <class T>
__device__ __forceinline__ void lerped(const T& amount, float gx, float gy, float gz,
                                       const T& rx, const T& ry, const T& rz, const T& nx,
                                       const T& ny, const T& nz, T& ox, T& oy, T& oz) {
  T inv = 1.0f - amount;
  T lx = gx * amount + rx * inv;
  T ly = gy * amount + ry * inv;
  T lz = gz * amount + rz * inv;
  norm3(lx, ly, lz);
  float d = val(lx) * val(nx) + val(ly) * val(ny) + val(lz) * val(nz);
  if (d < 0.0f) { lx = -lx; ly = -ly; lz = -lz; }
  ox = lx; oy = ly; oz = lz;
}

// vector3::refract (vector3.h:205-214): TIR gives the zero vector.
template <class T>
__device__ __forceinline__ void refract(const T& vx, const T& vy, const T& vz, const T& nx,
                                        const T& ny, const T& nz, const T& index,
                                        T& ox, T& oy, T& oz) {
  T ndv = -(vx * nx + vy * ny + vz * nz);
  T sin2 = (index * index) * (1.0f - ndv * ndv);
  T k = index * ndv - sqrt_(val(sin2) < 1.0f ? 1.0f - sin2 : T(1.0f));
  ox = vx * index + nx * k;
  oy = vy * index + ny * k;
  oz = vz * index + nz * k;
  norm3(ox, oy, oz);
  if (val(sin2) >= 1.0f) { ox = T(0.0f); oy = T(0.0f); oz = T(0.0f); }
}

// Rodrigues rotation (vector3.h:315-333) about the axis a.
template <class T>
__device__ __forceinline__ void rotate(const T& vx, const T& vy, const T& vz, const T& angle,
                                       float ax, float ay, float az, T& ox, T& oy, T& oz) {
  T c = cos_(angle);
  T s = sin_(angle);
  T ic = 1.0f - c;
  ox = (c + ic * ax * ax) * vx + (ic * ax * ay - az * s) * vy + (ic * ax * az + ay * s) * vz;
  oy = (ic * ax * ay + az * s) * vx + (c + ic * ay * ay) * vy + (ic * ay * az - ax * s) * vz;
  oz = (ic * ax * az - ay * s) * vx + (ic * ay * az + ax * s) * vy + (c + ic * az * az) * vz;
}

// The three modes of the body.  kDirect folds the radiance in registers
// (kernels 2-3, 9, 10 and 8's whole chain).  The deferred modes trace the
// same path but emit each depth's affine radiance transfer as a Slot
// instead: kDeferTex defers the textured rows (kernel 4), kDeferAll every
// radiometric table value (kernels 7-8).  The mode is a template argument,
// so each kernel compiles only its own branches.
enum PathMode { kDirect = 0, kDeferTex = 1, kDeferAll = 2 };

// One depth's affine transfer: coef_c = value_c(mat)·s + k_c and
// bias_c = value_c(mat_e)·se + ke_c, where value is the row's texel
// (kDeferTex: the texel of mat, or 1) or table value (kDeferAll).
// kDeferAll's k is channel-independent (k[0]) and it has no ke.
struct Slot {
  float s, k[3], se, ke[3], u, v;
  int mat, mat_e;
};

// The slot of an inactive lane: k = 1 keeps its throughput in the fold.
__device__ __forceinline__ Slot empty_slot() {
  Slot sl;
  sl.s = 0.0f;
  sl.k[0] = sl.k[1] = sl.k[2] = 1.0f;
  sl.se = 0.0f;
  sl.ke[0] = sl.ke[1] = sl.ke[2] = 0.0f;
  sl.u = 0.0f;
  sl.v = 0.0f;
  sl.mat = -1;
  sl.mat_e = -1;
  return sl;
}

// The direct mode's sink: it receives no slots.  A deferred kernel passes
// its own sink, whose put(depth, slot) stores the slot where that kernel
// keeps it (planes in device memory, or a per-thread array).  In the direct
// mode the body also hands its sink what a reverse sweep needs: each live
// bounce's segment, throughput and winner row (bounce), a depth-0 fog
// absorption at depth 1 (fog_absorbed), and the path's end (end: alive
// after the last bounce, radiance before the light clamp).  NoSlots keeps
// none of it.
struct NoSlots {
  __device__ __forceinline__ void put(int, const Slot&) {}
  template <class T>
  __device__ __forceinline__ void bounce(int, const T&, const T&, const T&, const T&,
                                         const T&, const T&, const T&, const T&, const T&,
                                         int) {}
  __device__ __forceinline__ void fog_absorbed() {}
  template <class T>
  __device__ __forceinline__ void end(bool, const T&, const T&, const T&) {}
};

template <class T>
struct PathOutT {
  T L[3];  // radiance (direct mode only)
  float aov_n[3];
  float aov_d;
  int aov_m;
  int segcnt;
  bool p_light;  // depth-0 hit of a light (the fold's clamp mask)
};
using PathOut = PathOutT<float>;

// Where the body reads a material cell (row, column of the kMatStride-wide
// row) and the sky's emission.  TableMats: the table in device memory, with
// the sky emission x3 precomputed on the host (kernels 2-4, 7, 8).
// SmemMats: a block's own copy of the table in shared memory (kernel 9,
// and the reverse-mode adjoints 10 and 8's whole chain, whose optimized
// cells come from the parameter vector).
struct TableMats {
  const float* mats;

  __device__ __forceinline__ float get(int row, int col) const {
    return __ldg(mats + row * kMatStride + col);
  }
  __device__ __forceinline__ float sky(int c, const PathParams& pp) const {
    return pp.sky_e[c];
  }
};

struct SmemMats {
  const float* tab;

  __device__ __forceinline__ float get(int row, int col) const {
    return tab[row * kMatStride + col];
  }
  __device__ __forceinline__ float sky(int c, const PathParams& pp) const {
    return get(pp.sky_idx, 3 + c) * 3.0f;
  }
};

// One lane's path between bounces: its segment, radiance and throughput,
// whether it is alive, its segment count, the depth-0 fog bookkeeping
// (material.cpp:319-339, resolved at depth 1), the depth-0 AOVs and light
// mask, and its sample_hash prefix.
template <class T>
struct PathState {
  T sx, sy, sz, dx, dy, dz;
  T Lx, Ly, Lz;
  T Tx, Ty, Tz;
  bool alive;
  int segcnt;
  bool f_active;
  T f_fx, f_fy, f_fz;
  T f_dx, f_dy, f_dz;
  T f_dens;
  float f_u;
  int f_row;
  float aov_n[3];
  float aov_d;
  int aov_m;
  bool p_light;  // depth-0 hit of a light (the fold's clamp mask)
  uint32_t hs;
};

// A lane's path before its first bounce, from its primary segment.
template <class T>
__device__ __forceinline__ PathState<T> path_init(const PathParams& pp, uint32_t hs, T sx,
                                                  T sy, T sz, T dx, T dy, T dz) {
  PathState<T> st;
  st.sx = sx; st.sy = sy; st.sz = sz;
  st.dx = dx; st.dy = dy; st.dz = dz;
  st.Lx = 0.0f; st.Ly = 0.0f; st.Lz = 0.0f;
  st.Tx = 1.0f; st.Ty = 1.0f; st.Tz = 1.0f;
  st.alive = true;
  st.segcnt = 0;
  st.f_active = false;
  st.f_fx = 0.0f; st.f_fy = 0.0f; st.f_fz = 0.0f;
  st.f_dx = 0.0f; st.f_dy = 0.0f; st.f_dz = 0.0f;
  st.f_dens = 0.0f;
  st.f_u = 0.0f;
  st.f_row = -1;
  st.aov_n[0] = st.aov_n[1] = st.aov_n[2] = 0.0f;
  st.aov_d = 0.0f;
  st.aov_m = pp.sky_idx;
  st.p_light = false;
  st.hs = hs;
  return st;
}

// One bounce of a lane's path at depth `depth`; returns whether the lane is
// alive after it.  The switch on the hit material's family replaces the
// reference's masked loop over material rows (the masks are disjoint); a
// row at or past n_mats matches no family and the path dies with zero
// coefficients, as in the reference.  The deferred modes hand sink this
// depth's slot (an inactive lane's slot is empty_slot()).
template <int kMode, class T, class Rows, class Mats, class Sink>
__device__ __forceinline__ bool path_bounce(PathState<T>& st, int depth, const Rows& rows,
                                            const Mats& mats,
                                            const int* __restrict__ mat_meta,
                                            const PathParams& pp, Sink& sink) {
  constexpr bool kDeferred = kMode != kDirect;
  T &sx = st.sx, &sy = st.sy, &sz = st.sz, &dx = st.dx, &dy = st.dy, &dz = st.dz;
  T &Lx = st.Lx, &Ly = st.Ly, &Lz = st.Lz, &Tx = st.Tx, &Ty = st.Ty, &Tz = st.Tz;
  bool& alive = st.alive;
  bool& f_active = st.f_active;
  T &f_fx = st.f_fx, &f_fy = st.f_fy, &f_fz = st.f_fz;
  T &f_dx = st.f_dx, &f_dy = st.f_dy, &f_dz = st.f_dz;
  T& f_dens = st.f_dens;
  float& f_u = st.f_u;
  int& f_row = st.f_row;
  // Read each bounce rather than kept in the state: a register fewer for
  // the deferred modes (PERF.md §6).
  const bool sky_textured =
      kDeferred && __ldg(mat_meta + kMetaStride * pp.sky_idx + 2) >= 0;
  const uint32_t hs = st.hs;

  st.segcnt += alive ? 1 : 0;
  Slot sl = empty_slot();
  if (!alive) {
    // A dead lane changes nothing; the deferred modes get an empty slot.
    if constexpr (kDeferred) sink.put(depth, sl);
    return false;
  }
  const Hit h = intersect_lanes<kDeferred>(rows, pp.n_prims, val(sx), val(sy), val(sz),
                                           val(dx), val(dy), val(dz));
  if constexpr (kMode == kDirect) sink.bounce(depth, sx, sy, sz, dx, dy, dz, Tx, Ty, Tz, h.prim);
  T t = h.t, hnx = h.nx, hny = h.ny, hnz = h.nz;
  bool hit = h.t < kInvalid;
  T px = sx + dx * t, py = sy + dy * t, pz = sz + dz * t;
  // Backface flip (scene.cpp:238-247).
  float side = val(hnx) * (val(sx) - val(px)) + val(hny) * (val(sy) - val(py))
               + val(hnz) * (val(sz) - val(pz));
  if (side < 0.0f) { hnx = -hnx; hny = -hny; hnz = -hnz; }

  if (depth >= 1) {
    // Depth-0 fog resolution one bounce later (material.cpp:330-337).
    if (f_active) {
      float lpx = hit ? val(px) : val(sx) + val(dx);
      float lpy = hit ? val(py) : val(sy) + val(dy);
      float lpz = hit ? val(pz) : val(sz) + val(dz);
      float ddx = lpx - val(f_fx), ddy = lpy - val(f_fy), ddz = lpz - val(f_fz);
      float dist2 = ddx * ddx + ddy * ddy + ddz * ddz;
      float thresh = fminf(fmaxf(dist2 * val(f_dens) * 0.00005f, 0.0f), 1.0f);
      if (f_u < thresh) {
        if constexpr (kMode == kDeferAll) {
          sl.se = 1.0f;  // bias event on the fog row's (diffuse) column
          sl.mat_e = f_row;
        } else if constexpr (kMode == kDeferTex) {
          sl.ke[0] = f_dx; sl.ke[1] = f_dy; sl.ke[2] = f_dz;
        } else {
          Lx = Lx + Tx * f_dx;
          Ly = Ly + Ty * f_dy;
          Lz = Lz + Tz * f_dz;
          sink.fog_absorbed();
        }
        alive = false;
      }
    }
    f_active = false;
  }

  if (alive && !hit) {  // miss -> sky (engine.cpp:92-101)
    if constexpr (kMode == kDeferAll || kMode == kDeferTex) {
      if (kMode == kDeferAll || sky_textured) {
        // Bias event: sky emission x3, or its sphere-mapped texel.
        sl.se = 3.0f;
        if (kMode == kDeferAll) sl.mat_e = pp.sky_idx;
        else sl.mat = pp.sky_idx;
        if (sky_textured) {
          float mvx = dx, mvy = dy, mvz = dz;
          norm3(mvx, mvy, mvz);
          sl.u = atan2_poly(mvx, mvz) / kTwoPi + 0.5f;
          sl.v = 1.0f - (mvy * 0.5f + 0.5f);
        }
      } else {
        sl.ke[0] = pp.sky_e[0]; sl.ke[1] = pp.sky_e[1]; sl.ke[2] = pp.sky_e[2];
      }
    } else {
      Lx = Lx + Tx * mats.sky(0, pp);
      Ly = Ly + Ty * mats.sky(1, pp);
      Lz = Lz + Tz * mats.sky(2, pp);
    }
  }
  const bool active = alive && hit;

  T bx = 0.0f, by = 0.0f, bz = 0.0f;   // direction
  T cx = 0.0f, cy = 0.0f, cz = 0.0f;   // coef
  T ex = 0.0f, ey = 0.0f, ez = 0.0f;   // bias
  bool will = false, is_light = false, is_fog = false;
  T fog_dens = 0.0f, fog_cx = 0.0f, fog_cy = 0.0f, fog_cz = 0.0f;
  float u3 = 0.0f;

  if (active) {
    // View vector (engine.cpp:114) and the bounce's uniforms.
    T vx = px - sx, vy = py - sy, vz = pz - sz;
    norm3(vx, vy, vz);
    const uint32_t base = 16u + (uint32_t)(depth * pp.bounce_slots);
    const float u0 = uniform(hs, base + 0u);
    const float u1 = uniform(hs, base + 1u);
    const float u2 = uniform(hs, base + 2u);
    u3 = uniform(hs, base + 3u);

    T ndv = hnx * vx + hny * vy + hnz * vz;
    T rx = vx - 2.0f * ndv * hnx;
    T ry = vy - 2.0f * ndv * hny;
    T rz = vz - 2.0f * ndv * hnz;
    // Hemisphere sample: uniform sphere direction flipped to the normal.
    float gz = 1.0f - 2.0f * u1;
    float gr = sqrtf(fmaxf(1.0f - gz * gz, 0.0f));
    float phi = kTwoPi * u2;
    float gx = gr * cosf(phi);
    float gy = gr * sinf(phi);
    float gdot = gx * val(hnx) + gy * val(hny) + gz * val(hnz);
    if (gdot < 0.0f) { gx = -gx; gy = -gy; gz = -gz; }

    const int row = h.mat;
    if (row < pp.n_mats) {
      const int* mm = mat_meta + kMetaStride * row;
      const int mtype = __ldg(mm);
      const int flags = __ldg(mm + 1);
      // Deferred coefficient: (s, k) of a textured row, or of every row
      // in kDeferAll; otherwise the full coefficient c lands in k.
      const bool tex_row = kMode == kDeferTex && __ldg(mm + 2) >= 0;
      const bool defer_coef = kMode == kDeferAll || tex_row;
      bool shaded = true, has_dsk = false;
      float dsv = 0.0f, dk = 0.0f;
      const T d0 = mats.get(row, 0), d1 = mats.get(row, 1), d2 = mats.get(row, 2);
      T ox, oy, oz;
      switch (mtype) {
        case LIGHT:
          if (kMode == kDeferAll) {
            sl.se = 1.0f;
            sl.mat_e = row;
          } else if (tex_row) {
            sl.se = 1.0f;  // textured emission: bias = texel
          } else {
            ex = mats.get(row, 3); ey = mats.get(row, 4); ez = mats.get(row, 5);
          }
          is_light = true;
          shaded = false;
          break;
        case DIFFUSE: {
          T ndl = gx * hnx + gy * hny + gz * hnz;
          will = val(ndl) > 0.001f;
          T nl = fmax_(ndl, 0.0f);
          bx = gx; by = gy; bz = gz;
          cx = d0 * nl; cy = d1 * nl; cz = d2 * nl;
          if constexpr (kDeferred) {
            if (defer_coef) { has_dsk = true; dsv = nl; }
          }
          break;
        }
        case METAL: {
          const T rough = mats.get(row, 9);
          lerped(rough, gx, gy, gz, rx, ry, rz, hnx, hny, hnz, ox, oy, oz);
          T ndl = ox * hnx + oy * hny + oz * hnz;
          will = (flags & kFlagMetalSmooth) || (val(ndl) > 0.001f);
          T nl = fmax_(ndl, 0.0f);
          T f = rough * nl + (1.0f - rough);
          bx = ox; by = oy; bz = oz;
          cx = d0 * f; cy = d1 * f; cz = d2 * f;
          if constexpr (kDeferred) {
            if (defer_coef) { has_dsk = true; dsv = f; }
          }
          break;
        }
        case MIRROR:
          bx = rx; by = ry; bz = rz;
          will = true;
          cx = d0; cy = d1; cz = d2;
          if (kMode == kDeferAll) { has_dsk = true; dsv = 1.0f; }
          break;
        case CERAMIC:
        case GLOW: {
          const T shin = mats.get(row, 9);
          T amount = u0 < 0.1f ? T(0.0f) : 1.0f - shin;
          lerped(amount, gx, gy, gz, rx, ry, rz, hnx, hny, hnz, ox, oy, oz);
          T ndl = ox * hnx + oy * hny + oz * hnz;
          T nl = fmax_(ndl, 0.0f);
          T hx = ox - vx, hy = oy - vy, hz = oz - vz;
          norm3(hx, hy, hz);
          T hn = hx * hnx + hy * hny + hz * hnz;
          T spec = pow25(hn * hn);
          cx = spec + d0 * nl * (1.0f - spec);
          cy = spec + d1 * nl * (1.0f - spec);
          cz = spec + d2 * nl * (1.0f - spec);
          bx = ox; by = oy; bz = oz;
          will = true;
          // The mirror spike is a constant: it lands in k.
          if constexpr (kDeferred) {
            if (defer_coef) { has_dsk = true; dsv = nl * (1.0f - spec); dk = spec; }
          }
          if (mtype == GLOW) {
            if (kMode == kDeferAll) {
              sl.se = 1.0f;
              sl.mat_e = row;
            } else {
              ex = mats.get(row, 6); ey = mats.get(row, 7); ez = mats.get(row, 8);
            }
          }
          break;
        }
        case GLASS: {
          const T index = mats.get(row, 10), refl = mats.get(row, 11);
          const T frost = mats.get(row, 12);
          if (u0 < val(refl)) {
            lerped(frost, gx, gy, gz, rx, ry, rz, hnx, hny, hnz, ox, oy, oz);
          } else {
            // random_refraction (normal.cpp:64-105).
            T fx0, fy0, fz0;
            if (flags & kFlagGlassStraight) {
              fx0 = vx; fy0 = vy; fz0 = vz;
              norm3(fx0, fy0, fz0);
            } else {
              refract(vx, vy, vz, hnx, hny, hnz, index, fx0, fy0, fz0);
            }
            if (flags & kFlagFrostFull) {
              ox = gx; oy = gy; oz = gz;
            } else if (flags & kFlagFrostNone) {
              ox = fx0; oy = fy0; oz = fz0;
            } else {
              T sa = kPi * frost;
              T delta = (u3 * 2.0f - 1.0f) * (sa * 0.5f);
              rotate(fx0, fy0, fz0, delta, gx, gy, gz, ox, oy, oz);
            }
          }
          bx = ox; by = oy; bz = oz;
          will = true;
          cx = d0; cy = d1; cz = d2;
          if (kMode == kDeferAll) { has_dsk = true; dsv = 1.0f; }
          break;
        }
        case LIQUID: {
          const T index = mats.get(row, 10), refl = mats.get(row, 11);
          if (u0 < val(refl)) {
            ox = rx; oy = ry; oz = rz;
          } else {
            refract(vx, vy, vz, hnx, hny, hnz, index, ox, oy, oz);
          }
          bx = ox; by = oy; bz = oz;
          will = true;
          cx = d0; cy = d1; cz = d2;
          if (kMode == kDeferAll) { has_dsk = true; dsv = 1.0f; }
          break;
        }
        case FOG:
          bx = vx; by = vy; bz = vz;
          will = true;
          cx = 1.0f; cy = 1.0f; cz = 1.0f;
          is_fog = true;
          fog_dens = mats.get(row, 12);
          fog_cx = d0; fog_cy = d1; fog_cz = d2;
          break;
        default:
          shaded = false;
          break;
      }
      if constexpr (kDeferred) {
        if (shaded) {
          if (has_dsk) {
            sl.s = dsv;
            sl.k[0] = dk; sl.k[1] = dk; sl.k[2] = dk;
          } else {
            sl.k[0] = cx; sl.k[1] = cy; sl.k[2] = cz;
          }
        }
      }
    }
  }

  if (depth == 0) {
    float anx = hit ? val(hnx) : val(dx), any = hit ? val(hny) : val(dy),
          anz = hit ? val(hnz) : val(dz);
    if (!hit) norm3(anx, any, anz);
    st.aov_n[0] = anx; st.aov_n[1] = any; st.aov_n[2] = anz;
    float dpx = val(px) - val(sx), dpy = val(py) - val(sy), dpz = val(pz) - val(sz);
    st.aov_d = hit ? sqrtf(dpx * dpx + dpy * dpy + dpz * dpz) : pp.z_far;
    st.aov_m = hit ? h.mat : pp.sky_idx;
    st.p_light = hit && is_light;
    if (active && is_fog) {
      f_active = true;
      f_fx = px; f_fy = py; f_fz = pz;
      f_dx = fog_cx; f_dy = fog_cy; f_dz = fog_cz;
      f_dens = fog_dens;
      f_u = u3;
      f_row = h.mat;
    }
  }

  if (active) {
    if constexpr (kDeferred) {
      sl.mat = h.mat;
      sl.u = h.u;
      sl.v = h.v;
      // Untextured emission (lights, glow); disjoint from the fog and
      // sky events above, whose lanes are not active.
      if (kMode == kDeferTex) { sl.ke[0] = ex; sl.ke[1] = ey; sl.ke[2] = ez; }
    } else {
      Lx = Lx + Tx * ex;
      Ly = Ly + Ty * ey;
      Lz = Lz + Tz * ez;
      Tx = Tx * cx;
      Ty = Ty * cy;
      Tz = Tz * cz;
    }
    sx = px + bx * pp.ray_offset;
    sy = py + by * pp.ray_offset;
    sz = pz + bz * pp.ray_offset;
    dx = bx * pp.seg_scale;
    dy = by * pp.seg_scale;
    dz = bz * pp.seg_scale;
  }
  alive = active && will;
  if constexpr (kDeferred) sink.put(depth, sl);
  return alive;
}

// The depth-0 light tone clamp (engine.cpp:148-151) of a lane's radiance.
template <class T>
__device__ __forceinline__ void light_clamp(T& Lx, T& Ly, T& Lz, bool p_light,
                                            const PathParams& pp) {
  T n2 = Lx * Lx + Ly * Ly + Lz * Lz;
  T norm = sqrt_(fmax_(n2, 1e-20f));
  T s = (p_light && val(norm) > pp.light_clamp) ? pp.light_clamp / norm : T(1.0f);
  Lx = Lx * s;
  Ly = Ly * s;
  Lz = Lz * s;
}

// The end of a lane's path after its last bounce: the fast-render white
// terminal (one more slot when deferred), the direct mode's sink.end, and
// the depth-0 light tone clamp (engine.cpp:148-151; the deferred modes
// apply it after their fold).
template <int kMode, class T, class Sink>
__device__ __forceinline__ PathOutT<T> path_finish(const PathState<T>& st,
                                                   const PathParams& pp, Sink& sink) {
  constexpr bool kDeferred = kMode != kDirect;
  T Lx = st.Lx, Ly = st.Ly, Lz = st.Lz;
  if (pp.fast_render) {
    // White terminal (engine.cpp:67-70).
    const float wht = st.alive ? 1.0f : 0.0f;
    if constexpr (kDeferred) {
      Slot sl = empty_slot();
      if (kMode == kDeferAll) sl.se = wht;
      else { sl.ke[0] = wht; sl.ke[1] = wht; sl.ke[2] = wht; }
      sink.put(pp.depth, sl);
    } else if (st.alive) {
      Lx = Lx + st.Tx;
      Ly = Ly + st.Ty;
      Lz = Lz + st.Tz;
    }
  }
  if constexpr (kMode == kDirect) sink.end(st.alive, Lx, Ly, Lz);
  light_clamp(Lx, Ly, Lz, st.p_light, pp);
  PathOutT<T> out;
  out.L[0] = Lx;
  out.L[1] = Ly;
  out.L[2] = Lz;
  out.aov_n[0] = st.aov_n[0]; out.aov_n[1] = st.aov_n[1]; out.aov_n[2] = st.aov_n[2];
  out.aov_d = st.aov_d;
  out.aov_m = st.aov_m;
  out.segcnt = st.segcnt;
  out.p_light = st.p_light;
  return out;
}

// Trace one lane's whole path from its primary segment: every depth's
// bounce in turn (a dead lane's too, so the deferred modes get a slot for
// every depth), then its end.
template <int kMode, class T, class Rows, class Mats, class Sink>
__device__ __forceinline__ PathOutT<T> trace_path_t(const Rows& rows, const Mats& mats,
                                                    const int* __restrict__ mat_meta,
                                                    const PathParams& pp, uint32_t hs, T sx,
                                                    T sy, T sz, T dx, T dy, T dz,
                                                    Sink& sink) {
  PathState<T> st = path_init<T>(pp, hs, sx, sy, sz, dx, dy, dz);
  for (int depth = 0; depth < pp.depth; ++depth)
    path_bounce<kMode>(st, depth, rows, mats, mat_meta, pp, sink);
  return path_finish<kMode>(st, pp, sink);
}

// The float body over the material table in device memory: kernels 2-4
// and 7 (the primitive rows in shared memory, stage_rows) and 8
// (TableRows).
template <int kMode, class Rows, class Sink>
__device__ __forceinline__ PathOut trace_path(const Rows& rows, const float* __restrict__ mats,
                                              const int* __restrict__ mat_meta,
                                              const PathParams& pp, uint32_t hs, float sx,
                                              float sy, float sz, float dx, float dy,
                                              float dz, Sink& sink) {
  return trace_path_t<kMode, float>(rows, TableMats{mats}, mat_meta, pp, hs, sx, sy, sz, dx,
                                    dy, dz, sink);
}

// A block's copy of the primitive table in shared memory (kernels 1-4 and
// 7): the n_prims rows as float4s, their (kind, material) pairs, then the
// first row of each kind (the rows are sorted by kind); rows_smem bytes of
// dynamic shared memory, sized from the scene.  Every thread of the block
// calls it before any returns.  The walk of every row per segment takes
// most of a kernel's time (PERF.md §6); a row comes sooner from shared
// memory than from L1, and one loop a kind needs no switch.  Each kind's
// first row (the first row of a kind >= k) is written by the row that
// starts it, for the kinds after the previous row's up to its own, and by
// the table's end for the kinds after the last row's: every thread reads
// the kinds it needs from the table in device memory, in parallel with the
// staging, so nothing staged is read before the block's one barrier.
__device__ __forceinline__ SmemRows stage_rows(float4* smem, const float* __restrict__ prims,
                                               const int* __restrict__ meta, int n_prims) {
  constexpr int kRow4 = kPrimStride / 4;
  int2* smeta = reinterpret_cast<int2*>(smem + n_prims * kRow4);
  int* first = reinterpret_cast<int*>(smeta + n_prims);
  for (int j = threadIdx.x; j < n_prims * kRow4; j += blockDim.x)
    smem[j] = __ldg(reinterpret_cast<const float4*>(prims) + j);
  for (int j = threadIdx.x; j <= n_prims; j += blockDim.x) {
    const int2 km = j < n_prims ? __ldg(reinterpret_cast<const int2*>(meta) + j)
                                : make_int2(TRIANGLE + 1, 0);
    if (j < n_prims) smeta[j] = km;
    const int after = j > 0 ? __ldg(meta + 2 * (j - 1)) + 1 : 0;
    for (int k = after; k <= km.x; ++k) first[k] = j;
  }
  __syncthreads();
  return SmemRows{smem, smeta, first};
}

// The path kernels' block (kernels 2-4 and 7) and their launch bounds:
// eight blocks an SM (64 registers, a few hundred bytes of spill), faster
// on an H100 than the compiler's free choice of five (PERF.md §6).
constexpr int kPathBlock = 128;
constexpr int kPathMinBlocks = 8;

inline size_t rows_smem(int n_prims) {
  return (size_t)n_prims * (kPrimStride * sizeof(float) + sizeof(int2))
         + (TRIANGLE + 2) * sizeof(int);
}

// Let kernel take smem bytes of dynamic shared memory (past 48 KB it must
// ask).
template <class Kernel>
inline cudaError_t allow_smem(Kernel* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// --- primary rays (pallas_path.py build_fused_raygen) ---------------------

struct CameraRay {
  float sx, sy, sz, dx, dy, dz;
  uint32_t hs;  // the lane's sample_hash prefix
};

// build_fused_raygen (pallas_path.py:1109): frame lane -> pixel/sample ids,
// PCG jitter, pinhole ray through the far-plane image, thin-lens DoF.
__device__ __forceinline__ CameraRay camera_ray(const CamParams& cp, uint32_t h0,
                                                int sample0, int flat) {
  const int s = flat % cp.spp;
  const int pxy = flat / cp.spp;
  const int x = pxy % cp.width;
  const int y = pxy / cp.width;
  const int pix = y * cp.width + x;
  const int smp = s + sample0;
  CameraRay r;
  r.hs = sample_hash(h0, (uint32_t)pix, (uint32_t)smp);

  const float u0 = uniform(r.hs, 0u);
  const float u1 = uniform(r.hs, 1u);
  const float xf = (float)x + (u0 - 0.5f);
  const float yf = (float)y + (u1 - 0.5f);
  const float x_dist = cp.half_w * ((xf * cp.inv_wm1) * 2.0f - 1.0f);
  const float y_dist = cp.half_h * ((yf * cp.inv_hm1) * 2.0f - 1.0f);
  const float stopx = cp.proj_origin[0] + cp.right[0] * x_dist + cp.up[0] * y_dist;
  const float stopy = cp.proj_origin[1] + cp.right[1] * x_dist + cp.up[1] * y_dist;
  const float stopz = cp.proj_origin[2] + cp.right[2] * x_dist + cp.up[2] * y_dist;
  float sx = cp.origin[0], sy = cp.origin[1], sz = cp.origin[2];
  float dx = stopx - sx, dy = stopy - sy, dz = stopz - sz;

  if (cp.dof) {
    // Thin-lens DoF (engine.cpp:221-244).
    const float u2 = uniform(r.hs, 2u);
    const float u3 = uniform(r.hs, 3u);
    const float* fp = cp.focal_plane;
    float ts = fp[0] * dx + fp[1] * dy + fp[2] * dz;
    float ns = -(fp[0] * sx + fp[1] * sy + fp[2] * sz + fp[3]);
    bool not_par = fabsf(ts) >= kEps;
    float tf = ns / (not_par ? ts : 1.0f);
    bool valid = not_par && (tf >= 0.0f) && (tf <= 1.0f);
    float fx = sx + dx * tf, fy = sy + dy * tf, fz = sz + dz * tf;
    float angle = u2 * kTwoPi;
    float mag = sqrtf(u3) * cp.aperture;
    float offc = cosf(angle) * mag;
    float offs = sinf(angle) * mag;
    float ox = cp.right[0] * offc + cp.up[0] * offs;
    float oy = cp.right[1] * offc + cp.up[1] * offs;
    float oz = cp.right[2] * offc + cp.up[2] * offs;
    float nsx = sx + ox, nsy = sy + oy, nsz = sz + oz;
    float ndx = fx - nsx, ndy = fy - nsy, ndz = fz - nsz;
    norm3(ndx, ndy, ndz);
    if (valid) {
      sx = nsx; sy = nsy; sz = nsz;
      dx = ndx * cp.z_far; dy = ndy * cp.z_far; dz = ndz * cp.z_far;
    }
  }
  r.sx = sx; r.sy = sy; r.sz = sz;
  r.dx = dx; r.dy = dy; r.dz = dz;
  return r;
}

// Constants of the traced raygen that do not depend on the camera values.
struct TracedCamParams {
  float aspect;    // width / height, rounded to float
  float half_deg;  // 0.5 * pi / 180 (the reference's pi), rounded to float
};

template <class T>
struct CameraRayT {
  T sx, sy, sz, dx, dy, dz;
  uint32_t hs;
};

// build_traced_raygen (pallas_path.py:1233-1334, ops/cuda_path.py): the
// primary ray of a frame lane from the 9 camera values cv (origin, target,
// fov_y in degrees, aperture, focal depth), the basis, projection and focal
// plane recomputed per lane from them (its adjoint: camera_adj,
// csrc/fspt_adjoint.cu).  cp supplies z_far, the lane layout and whether
// the thin-lens code runs (dof).  Not camera_ray's bits: that one takes
// the basis from the host.
template <class T>
__device__ __forceinline__ CameraRayT<T> traced_camera_ray(const CamParams& cp,
                                                           const TracedCamParams& tp,
                                                           const T* cv, uint32_t h0,
                                                           int sample0, int flat) {
  const T ox = cv[0], oy = cv[1], oz = cv[2];
  // Basis (engine.cpp:187-189, world up +Y): right = (fz, 0, -fx)/n.
  T fx = cv[3] - ox, fy = cv[4] - oy, fz = cv[5] - oz;
  const T fin = rsqrt_(fx * fx + fy * fy + fz * fz);
  fx = fx * fin; fy = fy * fin; fz = fz * fin;
  const T rin = rsqrt_(fmax_(fx * fx + fz * fz, 1e-20f));
  const T rx = fz * rin, ry = T(0.0f), rz = -fx * rin;
  const T ux = fy * rz - fz * ry;
  const T uy = fz * rx - fx * rz;
  const T uz = fx * ry - fy * rx;
  const T th = tan_(cv[6] * tp.half_deg);
  const T half_h = th * cp.z_far;
  const T half_w = th * tp.aspect * cp.z_far;
  const T pox = ox + fx * cp.z_far, poy = oy + fy * cp.z_far, poz = oz + fz * cp.z_far;

  const int s = flat % cp.spp;
  const int pxy = flat / cp.spp;
  const int x = pxy % cp.width;
  const int y = pxy / cp.width;
  const int pix = y * cp.width + x;
  const int smp = s + sample0;
  CameraRayT<T> r;
  r.hs = sample_hash(h0, (uint32_t)pix, (uint32_t)smp);
  const float u0 = uniform(r.hs, 0u);
  const float u1 = uniform(r.hs, 1u);
  const float xf = (float)x + (u0 - 0.5f);
  const float yf = (float)y + (u1 - 0.5f);
  const T x_dist = half_w * ((xf * cp.inv_wm1) * 2.0f - 1.0f);
  const T y_dist = half_h * ((yf * cp.inv_hm1) * 2.0f - 1.0f);
  const T stopx = pox + rx * x_dist + ux * y_dist;
  const T stopy = poy + ry * x_dist + uy * y_dist;
  const T stopz = poz + rz * x_dist + uz * y_dist;
  T sx = ox, sy = oy, sz = oz;
  T dx = stopx - sx, dy = stopy - sy, dz = stopz - sz;

  if (cp.dof) {
    // Thin-lens DoF (engine.cpp:221-244); the focal plane has normal
    // -forward through origin + forward * focal.
    const float u2 = uniform(r.hs, 2u);
    const float u3 = uniform(r.hs, 3u);
    const T qx = ox + fx * cv[8], qy = oy + fy * cv[8], qz = oz + fz * cv[8];
    const T fpw = qx * fx + qy * fy + qz * fz;
    const T ts = -(fx * dx + fy * dy + fz * dz);
    const T ns = -(-(fx * sx + fy * sy + fz * sz) + fpw);
    const bool not_par = fabsf(val(ts)) >= kEps;
    const T tf = ns / (not_par ? ts : T(1.0f));
    const bool valid = not_par && (val(tf) >= 0.0f) && (val(tf) <= 1.0f);
    const T fxp = sx + dx * tf, fyp = sy + dy * tf, fzp = sz + dz * tf;
    const float angle = u2 * kTwoPi;
    const T mag = sqrtf(u3) * cv[7];
    const T offc = cosf(angle) * mag;
    const T offs = sinf(angle) * mag;
    const T nsx = sx + (rx * offc + ux * offs);
    const T nsy = sy + (ry * offc + uy * offs);
    const T nsz = sz + (rz * offc + uz * offs);
    T ndx = fxp - nsx, ndy = fyp - nsy, ndz = fzp - nsz;
    norm3(ndx, ndy, ndz);
    if (valid) {
      sx = nsx; sy = nsy; sz = nsz;
      dx = ndx * cp.z_far; dy = ndy * cp.z_far; dz = ndz * cp.z_far;
    }
  }
  r.sx = sx; r.sy = sy; r.sz = sz;
  r.dx = dx; r.dy = dy; r.dz = dz;
  return r;
}

// A lane's outputs (kernels 2-4): radiance and the normal as [n][3], the
// depth, material AOV and segment count as [n].
__device__ __forceinline__ void write_path(const PathOut& o, int i,
                                           float* __restrict__ radiance,
                                           float* __restrict__ normal,
                                           float* __restrict__ depth,
                                           int* __restrict__ aov_mat,
                                           int* __restrict__ segcnt) {
  radiance[3 * i] = o.L[0];
  radiance[3 * i + 1] = o.L[1];
  radiance[3 * i + 2] = o.L[2];
  normal[3 * i] = o.aov_n[0];
  normal[3 * i + 1] = o.aov_n[1];
  normal[3 * i + 2] = o.aov_n[2];
  depth[i] = o.aov_d;
  aov_mat[i] = o.aov_m;
  segcnt[i] = o.segcnt;
}

inline int blocks_for(int n, int block) { return (n + block - 1) / block; }

}  // namespace fspt
