// Kernels 1-3 of the port and their plain C launchers (loaded with ctypes by
// ops/_build.py; kernels 4, 7 and 8 live in fspt_deferred.cu and
// fspt_grad.cu).  Each launcher enqueues on the caller's stream and returns
// cudaGetLastError(); the Python wrapper raises on anything but 0.
//
//   fspt_intersect    closest hit per segment     replaces pallas_trace.py
//                                                  make_pallas_intersector
//   fspt_camera_path  camera-fused path tracer    replaces pallas_path.py
//                                                  make_camera_path_tracer
//   fspt_ray_path     path tracer, rays in memory replaces pallas_path.py
//                                                  make_path_tracer
//
// One thread per lane, a masked ragged tail, blocks of 256 (intersect) and
// 128 (path) threads.  All three are bound by arithmetic, not bytes: the
// only device-memory traffic is each lane's ray in (or nothing, for the
// camera-fused kernel) and its outputs, while the intersect walks every
// primitive of the scene for every segment.  The path kernels stage the
// primitive table in shared memory once per block and run seven blocks an
// SM (kPathMinBlocks); the walk of every row per segment takes most of
// their time, and a row from shared memory comes sooner than one from L1.
// Per-lane state stays in registers.

#include "fspt_kernels.cuh"

namespace fspt {

constexpr int kIntersectBlock = 256;

__global__ void __launch_bounds__(kIntersectBlock)
intersect_kernel(const float* __restrict__ prims, const int* __restrict__ meta,
                 int n_prims, const float* __restrict__ start,
                 const float* __restrict__ seg, int n, float* __restrict__ t,
                 float* __restrict__ normal, int* __restrict__ mat,
                 int* __restrict__ kind, float* __restrict__ uv) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Hit h = intersect_lanes<true>(
      TableRows{prims, meta}, n_prims, start[3 * i], start[3 * i + 1], start[3 * i + 2],
      seg[3 * i], seg[3 * i + 1], seg[3 * i + 2]);
  t[i] = h.t;
  normal[3 * i] = h.nx;
  normal[3 * i + 1] = h.ny;
  normal[3 * i + 2] = h.nz;
  mat[i] = h.mat;
  kind[i] = h.kind;
  uv[2 * i] = h.u;
  uv[2 * i + 1] = h.v;
}

__global__ void __launch_bounds__(kPathBlock, kPathMinBlocks)
camera_path_kernel(const float* __restrict__ prims, const int* __restrict__ meta,
                   const float* __restrict__ mats,
                   const int* __restrict__ mat_meta, const PathParams pp,
                   const CamParams cp, uint32_t h0, int sample0, int lane0,
                   int n, float* __restrict__ radiance,
                   float* __restrict__ normal, float* __restrict__ depth,
                   int* __restrict__ aov_mat, int* __restrict__ segcnt) {
  extern __shared__ float4 smem[];
  const SmemRows rows = stage_rows(smem, prims, meta, pp.n_prims);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const CameraRay r = camera_ray(cp, h0, sample0, lane0 + i);
  NoSlots none;
  const PathOut o = trace_path<kDirect>(rows, mats, mat_meta, pp, r.hs, r.sx, r.sy, r.sz,
                                        r.dx, r.dy, r.dz, none);
  write_path(o, i, radiance, normal, depth, aov_mat, segcnt);
}

__global__ void __launch_bounds__(kPathBlock, kPathMinBlocks)
ray_path_kernel(const float* __restrict__ prims, const int* __restrict__ meta,
                const float* __restrict__ mats, const int* __restrict__ mat_meta,
                const PathParams pp, const float* __restrict__ start,
                const float* __restrict__ seg, const int* __restrict__ pixel,
                const int* __restrict__ sample, uint32_t h0, int n,
                float* __restrict__ radiance, float* __restrict__ normal,
                float* __restrict__ depth, int* __restrict__ aov_mat,
                int* __restrict__ segcnt) {
  extern __shared__ float4 smem[];
  const SmemRows rows = stage_rows(smem, prims, meta, pp.n_prims);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t hs = sample_hash(h0, (uint32_t)pixel[i], (uint32_t)sample[i]);
  NoSlots none;
  const PathOut o = trace_path<kDirect>(rows, mats, mat_meta, pp, hs, start[3 * i],
                                        start[3 * i + 1], start[3 * i + 2], seg[3 * i],
                                        seg[3 * i + 1], seg[3 * i + 2], none);
  write_path(o, i, radiance, normal, depth, aov_mat, segcnt);
}

}  // namespace fspt

extern "C" {

int fspt_intersect(const float* prims, const int* meta, int n_prims,
                   const float* start, const float* seg, int n, float* t,
                   float* normal, int* mat, int* kind, float* uv,
                   void* stream) {
  using namespace fspt;
  if (n > 0) {
    intersect_kernel<<<blocks_for(n, kIntersectBlock), kIntersectBlock, 0,
                       (cudaStream_t)stream>>>(prims, meta, n_prims, start, seg,
                                               n, t, normal, mat, kind, uv);
  }
  return (int)cudaGetLastError();
}

int fspt_camera_path(const float* prims, const int* meta, const float* mats,
                     const int* mat_meta, fspt::PathParams pp,
                     fspt::CamParams cp, unsigned int h0, int sample0,
                     int lane0, int n, float* radiance, float* normal,
                     float* depth, int* aov_mat, int* segcnt, void* stream) {
  using namespace fspt;
  if (n <= 0) return 0;
  const size_t smem = rows_smem(pp.n_prims);
  cudaError_t err = allow_smem(camera_path_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  camera_path_kernel<<<blocks_for(n, kPathBlock), kPathBlock, smem, (cudaStream_t)stream>>>(
      prims, meta, mats, mat_meta, pp, cp, h0, sample0, lane0, n, radiance, normal, depth,
      aov_mat, segcnt);
  return (int)cudaGetLastError();
}

int fspt_ray_path(const float* prims, const int* meta, const float* mats,
                  const int* mat_meta, fspt::PathParams pp, const float* start,
                  const float* seg, const int* pixel, const int* sample,
                  unsigned int h0, int n, float* radiance, float* normal,
                  float* depth, int* aov_mat, int* segcnt, void* stream) {
  using namespace fspt;
  if (n <= 0) return 0;
  const size_t smem = rows_smem(pp.n_prims);
  cudaError_t err = allow_smem(ray_path_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  ray_path_kernel<<<blocks_for(n, kPathBlock), kPathBlock, smem, (cudaStream_t)stream>>>(
      prims, meta, mats, mat_meta, pp, start, seg, pixel, sample, h0, n, radiance, normal,
      depth, aov_mat, segcnt);
  return (int)cudaGetLastError();
}

}  // extern "C"
