// Kernels 4 and 7 of the port: the camera-fused path body in its two
// deferred modes, writing slot planes.  Plain C launchers, loaded with
// ctypes by ops/_build.py; each returns cudaGetLastError().
//
//   fspt_deferred_camera_path  kDeferTex  replaces pallas_path.py
//                                          _make_deferred_camera_tracer
//   fspt_affine_planes         kDeferAll  replaces pallas_grad.py
//                                          make_affine_grad_image_fn
//
// One thread per lane, blocks of 128, a masked ragged tail.  Every lane
// writes every slot, alive or not, so the outputs are dense planes laid out
// [field][slot][lane]: the 32 lanes of a warp store 128 contiguous bytes per
// field and slot.  What bounds them on the H100: those bytes.  Kernel 4
// writes 44 bytes per slot and lane (ten floats, one int) plus 32 bytes of
// lane planes; kernel 7 writes 20 bytes per slot and lane (28 with the
// texcoords of a textured scene) plus 8.  At depth 8 that is more time at
// the card's memory rate than the path body's operations take at its fp32
// rate (chip_smoke.py computes both bounds).  The design keeps every store
// coalesced and reads nothing but the scene tables.

#include "fspt_kernels.cuh"

namespace fspt {

constexpr int kDeferredBlock = 128;

// Kernel 4's sink: the ten float fields (s, k0..2, se, ke0..2, u, v) and the
// material row of each slot, as [field][slot][lane] planes.
struct TexPlanes {
  float* __restrict__ fields;
  int* __restrict__ mat;
  size_t lanes;       // n: the stride of a slot
  size_t field_size;  // slots * n: the stride of a field
  int i;

  __device__ __forceinline__ void put(int d, const Slot& sl) {
    const size_t o = (size_t)d * lanes + i;
    float* f = fields + o;
    f[0] = sl.s;
    f[field_size] = sl.k[0];
    f[2 * field_size] = sl.k[1];
    f[3 * field_size] = sl.k[2];
    f[4 * field_size] = sl.se;
    f[5 * field_size] = sl.ke[0];
    f[6 * field_size] = sl.ke[1];
    f[7 * field_size] = sl.ke[2];
    f[8 * field_size] = sl.u;
    f[9 * field_size] = sl.v;
    mat[o] = sl.mat;
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

__global__ void __launch_bounds__(kDeferredBlock)
deferred_camera_kernel(const float* __restrict__ prims, const int* __restrict__ meta,
                       const float* __restrict__ mats,
                       const int* __restrict__ mat_meta, const PathParams pp,
                       const CamParams cp, uint32_t h0, int sample0, int lane0,
                       int n, float* __restrict__ fields, int* __restrict__ mat,
                       int* __restrict__ p_light, float* __restrict__ normal,
                       float* __restrict__ depth, int* __restrict__ aov_mat,
                       int* __restrict__ segcnt) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const CameraRay r = camera_ray(cp, h0, sample0, lane0 + i);
  TexPlanes sink{fields, mat, (size_t)n, (size_t)slot_count(pp) * n, i};
  const PathOut o = trace_path<kDeferTex>(prims, meta, mats, mat_meta, pp, r.hs,
                                          r.sx, r.sy, r.sz, r.dx, r.dy, r.dz, sink);
  p_light[i] = o.p_light ? 1 : 0;
  normal[3 * i] = o.aov_n[0];
  normal[3 * i + 1] = o.aov_n[1];
  normal[3 * i + 2] = o.aov_n[2];
  depth[i] = o.aov_d;
  aov_mat[i] = o.aov_m;
  segcnt[i] = o.segcnt;
}

__global__ void __launch_bounds__(kDeferredBlock)
affine_planes_kernel(const float* __restrict__ prims, const int* __restrict__ meta,
                     const float* __restrict__ mats,
                     const int* __restrict__ mat_meta, const PathParams pp,
                     const CamParams cp, uint32_t h0, int sample0, int lane0,
                     int n, float* __restrict__ fields, int n_fields,
                     int* __restrict__ mat, int* __restrict__ mat_e,
                     int* __restrict__ p_light, int* __restrict__ segcnt) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const CameraRay r = camera_ray(cp, h0, sample0, lane0 + i);
  AllPlanes sink{fields, n_fields, mat, mat_e, (size_t)n, (size_t)slot_count(pp) * n, i};
  const PathOut o = trace_path<kDeferAll>(prims, meta, mats, mat_meta, pp, r.hs,
                                          r.sx, r.sy, r.sz, r.dx, r.dy, r.dz, sink);
  p_light[i] = o.p_light ? 1 : 0;
  segcnt[i] = o.segcnt;
}

}  // namespace fspt

extern "C" {

int fspt_deferred_camera_path(const float* prims, const int* meta,
                              const float* mats, const int* mat_meta,
                              fspt::PathParams pp, fspt::CamParams cp,
                              unsigned int h0, int sample0, int lane0, int n,
                              float* fields, int* mat, int* p_light,
                              float* normal, float* depth, int* aov_mat,
                              int* segcnt, void* stream) {
  using namespace fspt;
  if (n > 0) {
    deferred_camera_kernel<<<blocks_for(n, kDeferredBlock), kDeferredBlock, 0,
                             (cudaStream_t)stream>>>(
        prims, meta, mats, mat_meta, pp, cp, h0, sample0, lane0, n, fields, mat,
        p_light, normal, depth, aov_mat, segcnt);
  }
  return (int)cudaGetLastError();
}

int fspt_affine_planes(const float* prims, const int* meta, const float* mats,
                       const int* mat_meta, fspt::PathParams pp,
                       fspt::CamParams cp, unsigned int h0, int sample0,
                       int lane0, int n, float* fields, int n_fields, int* mat,
                       int* mat_e, int* p_light, int* segcnt, void* stream) {
  using namespace fspt;
  if (n > 0) {
    affine_planes_kernel<<<blocks_for(n, kDeferredBlock), kDeferredBlock, 0,
                           (cudaStream_t)stream>>>(
        prims, meta, mats, mat_meta, pp, cp, h0, sample0, lane0, n, fields,
        n_fields, mat, mat_e, p_light, segcnt);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
