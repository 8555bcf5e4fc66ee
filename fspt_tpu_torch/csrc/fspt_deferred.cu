// Kernels 4 and 7 of the port: the camera-fused path body in its two
// deferred modes.  Plain C launchers, loaded with ctypes by ops/_build.py;
// each returns cudaGetLastError().
//
//   fspt_deferred_camera_path  kDeferTex  replaces pallas_path.py
//                                          _make_deferred_camera_tracer and
//                                          its fold (fold_deferred_radiance)
//   fspt_affine_planes         kDeferAll  replaces pallas_path.py
//                                          make_affine_grad_image_fn
//
// One thread per lane, kernel 2's blocks of 128 and launch bounds (eight
// blocks an SM), a masked ragged tail; both stage the primitive rows in
// shared memory once per block and walk them one kind at a time
// (stage_rows), as kernel 2 does.
//
// Kernel 4 folds
// each depth's slot as the body hands it over: it fetches the slot's texel
// (nearest neighbour, tiled; materials.sample_texture_p) from the texture
// pack, which sits in L2, and folds L += T·(t·se + ke), T *= t·s + k in
// the order of ops/cuda_path.py fold_deferred_radiance,
// then applies the depth-0 light clamp.  It writes what kernel 2 writes, 36
// bytes a lane.  The reference emits slot planes and folds them in XLA
// because a TPU kernel has no per-lane gather (PERF_NOTES.md:30-35); a
// Hopper thread loads its texel where the slot is made, so no plane reaches
// device memory.  What bounds it on the H100: operations, the path body's
// walk of every primitive row per segment, as kernel 2.
//
// Kernel 7 writes each slot as dense planes laid out [field][slot][lane]:
// the 32 lanes of a warp store 128 contiguous bytes per field and slot.  It
// writes 20 bytes per slot and lane (28 with the texcoords of a textured
// scene) plus 8; they feed the differentiable torch fold of the texel and
// albedo gradients.  What bounds it: those bytes (chip_smoke.py computes
// both bounds).  The design keeps every store coalesced and reads nothing
// but the scene tables; the walk of every row per segment, the same as
// kernel 2's, is what it spends its time on (PERF.md §6).  It writes
// p_light as one byte a lane, the layout of the bool tensor the wrapper
// hands out.

#include "fspt_kernels.cuh"

namespace fspt {

// The texture pack (materials.TexturePack: texels[offset[t] + y*width[t] +
// x]) and each material row's tiling scale (mirrors TexPack in
// ops/_build.py, passed by value).
struct TexPack {
  const float* texels;  // [n_texels][3]
  const int* offset;    // [T]
  const int* width;     // [T]
  const int* height;    // [T]
  const float* scale;   // [n_mats]: the row's tex_scale
  int n_texels;
};

// Python's floored a mod b of an int (torch.remainder).
__device__ __forceinline__ int floor_mod(int a, int b) {
  const int r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}

// Kernel 4's sink: the fold of fold_deferred_radiance, one slot at a time.
// A slot's texel is materials.sample_texture_p's for the slot's material
// row m (clamped into the table) at (u, v): x = int(u·scale·w + 0.5 − 1)
// floored mod w, the same for y, the index clamped into the pack; 1 where
// m < 0 or the row has no texture.
struct TexFold {
  TexPack tex;
  const int* __restrict__ mat_meta;
  int n_mats;
  float T[3] = {1.0f, 1.0f, 1.0f};
  float L[3] = {0.0f, 0.0f, 0.0f};

  __device__ __forceinline__ void put(int, const Slot& sl) {
    float t0 = 1.0f, t1 = 1.0f, t2 = 1.0f;
    if (sl.mat >= 0) {
      const int row = min(sl.mat, n_mats - 1);
      const int tid = __ldg(mat_meta + kMetaStride * row + 2);
      if (tid >= 0) {
        const int w = __ldg(tex.width + tid), h = __ldg(tex.height + tid);
        const float sc = __ldg(tex.scale + row);
        const float xf = sl.u * sc * (float)w + 0.5f - 1.0f;
        const float yf = sl.v * sc * (float)h + 0.5f - 1.0f;
        const int idx = __ldg(tex.offset + tid) + floor_mod((int)yf, h) * w
                        + floor_mod((int)xf, w);
        const float* t = tex.texels + 3 * (size_t)min(max(idx, 0), tex.n_texels - 1);
        t0 = __ldg(t);
        t1 = __ldg(t + 1);
        t2 = __ldg(t + 2);
      }
    }
    L[0] = L[0] + T[0] * (t0 * sl.se + sl.ke[0]);
    L[1] = L[1] + T[1] * (t1 * sl.se + sl.ke[1]);
    L[2] = L[2] + T[2] * (t2 * sl.se + sl.ke[2]);
    T[0] = T[0] * (t0 * sl.s + sl.k[0]);
    T[1] = T[1] * (t1 * sl.s + sl.k[1]);
    T[2] = T[2] * (t2 * sl.s + sl.k[2]);
  }
};

// Kernel 7's sink: s, k, se (then u, v when the scene has textures, i.e.
// n_fields == 5) and the two material rows mat, mat_e.
struct AllPlanes {
  float* __restrict__ fields;
  int n_fields;
  int* __restrict__ mat;
  int* __restrict__ mat_e;
  size_t lanes;
  size_t field_size;
  int i;

  __device__ __forceinline__ void put(int d, const Slot& sl) {
    const size_t o = (size_t)d * lanes + i;
    float* f = fields + o;
    f[0] = sl.s;
    f[field_size] = sl.k[0];
    f[2 * field_size] = sl.se;
    if (n_fields == 5) {
      f[3 * field_size] = sl.u;
      f[4 * field_size] = sl.v;
    }
    mat[o] = sl.mat;
    mat_e[o] = sl.mat_e;
  }
};

__device__ __forceinline__ int slot_count(const PathParams& pp) {
  return pp.depth + (pp.fast_render ? 1 : 0);
}

__global__ void __launch_bounds__(kPathBlock, kPathMinBlocks)
deferred_camera_kernel(const float* __restrict__ prims, const int* __restrict__ meta,
                       const float* __restrict__ mats,
                       const int* __restrict__ mat_meta, const PathParams pp,
                       const CamParams cp, const TexPack tex, uint32_t h0, int sample0,
                       int lane0, int n, float* __restrict__ radiance,
                       float* __restrict__ normal, float* __restrict__ depth,
                       int* __restrict__ aov_mat, int* __restrict__ segcnt) {
  extern __shared__ float4 smem[];
  const SmemRows rows = stage_rows(smem, prims, meta, pp.n_prims);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const CameraRay r = camera_ray(cp, h0, sample0, lane0 + i);
  TexFold sink{tex, mat_meta, pp.n_mats};
  PathOut o = trace_path<kDeferTex>(rows, mats, mat_meta, pp, r.hs, r.sx, r.sy, r.sz, r.dx,
                                    r.dy, r.dz, sink);
  light_clamp(sink.L[0], sink.L[1], sink.L[2], o.p_light, pp);
  o.L[0] = sink.L[0];
  o.L[1] = sink.L[1];
  o.L[2] = sink.L[2];
  write_path(o, i, radiance, normal, depth, aov_mat, segcnt);
}

__global__ void __launch_bounds__(kPathBlock, kPathMinBlocks)
affine_planes_kernel(const float* __restrict__ prims, const int* __restrict__ meta,
                     const float* __restrict__ mats,
                     const int* __restrict__ mat_meta, const PathParams pp,
                     const CamParams cp, uint32_t h0, int sample0, int lane0,
                     int n, float* __restrict__ fields, int n_fields,
                     int* __restrict__ mat, int* __restrict__ mat_e,
                     bool* __restrict__ p_light, int* __restrict__ segcnt) {
  extern __shared__ float4 smem[];
  const SmemRows rows = stage_rows(smem, prims, meta, pp.n_prims);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const CameraRay r = camera_ray(cp, h0, sample0, lane0 + i);
  AllPlanes sink{fields, n_fields, mat, mat_e, (size_t)n, (size_t)slot_count(pp) * n, i};
  const PathOut o = trace_path<kDeferAll>(rows, mats, mat_meta, pp, r.hs, r.sx, r.sy, r.sz,
                                          r.dx, r.dy, r.dz, sink);
  p_light[i] = o.p_light;
  segcnt[i] = o.segcnt;
}

}  // namespace fspt

extern "C" {

// radiance, normal: [n][3] float; depth: [n] float; aov_mat, segcnt: [n]
// int.
int fspt_deferred_camera_path(const float* prims, const int* meta,
                              const float* mats, const int* mat_meta,
                              fspt::PathParams pp, fspt::CamParams cp,
                              fspt::TexPack tex, unsigned int h0, int sample0,
                              int lane0, int n, float* radiance, float* normal,
                              float* depth, int* aov_mat, int* segcnt, void* stream) {
  using namespace fspt;
  if (n <= 0) return 0;
  const size_t smem = rows_smem(pp.n_prims);
  cudaError_t err = allow_smem(deferred_camera_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  deferred_camera_kernel<<<blocks_for(n, kPathBlock), kPathBlock, smem, (cudaStream_t)stream>>>(
      prims, meta, mats, mat_meta, pp, cp, tex, h0, sample0, lane0, n, radiance, normal, depth,
      aov_mat, segcnt);
  return (int)cudaGetLastError();
}

// fields: [n_fields][slots][n] float; mat, mat_e: [slots][n] int; p_light:
// [n] bool (one byte); segcnt: [n] int.
int fspt_affine_planes(const float* prims, const int* meta, const float* mats,
                       const int* mat_meta, fspt::PathParams pp,
                       fspt::CamParams cp, unsigned int h0, int sample0,
                       int lane0, int n, float* fields, int n_fields, int* mat,
                       int* mat_e, bool* p_light, int* segcnt, void* stream) {
  using namespace fspt;
  if (n <= 0) return 0;
  const size_t smem = rows_smem(pp.n_prims);
  cudaError_t err = allow_smem(affine_planes_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  affine_planes_kernel<<<blocks_for(n, kPathBlock), kPathBlock, smem, (cudaStream_t)stream>>>(
      prims, meta, mats, mat_meta, pp, cp, h0, sample0, lane0, n, fields, n_fields, mat,
      mat_e, p_light, segcnt);
  return (int)cudaGetLastError();
}

}  // extern "C"
