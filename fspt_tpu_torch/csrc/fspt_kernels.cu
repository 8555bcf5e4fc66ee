// Kernels 1-3 and 13 of the port and their plain C launchers (loaded with
// ctypes by ops/_build.py; kernels 4, 7 and 8 live in fspt_deferred.cu and
// fspt_grad.cu).  Each launcher enqueues on the caller's stream and returns
// cudaGetLastError(); the Python wrapper raises on anything but 0.
//
//   fspt_intersect    closest hit per segment     replaces pallas_trace.py
//                                                  make_pallas_intersector
//   fspt_camera_path  camera-fused path tracer    replaces pallas_path.py
//                                                  make_camera_path_tracer
//   fspt_ray_path     path tracer, rays in memory replaces pallas_path.py
//                                                  make_path_tracer
//   fspt_mesh_camera_path  camera-fused path      no TPU kernel: the
//                     tracer of a BVH scene       reference queues BVH scenes
//                                                  (render/queue.py)
//
// Kernel 13 (mesh_camera_path_kernel) is kernel 2's body on MeshRows
// (fspt_mesh.cuh): after the staged rows, the live lanes of a warp walk
// the scene's BVH for their segments, node steps and leaf tests in
// warp-wide phases.  Its launch can count the walk: the node steps and
// triangle tests, and the warp walks, the leaf phases and the leaves tested
// in them.  Each thread sums its own over its path, each warp adds its
// lanes' sums (__reduce_add_sync) and one lane adds them to the launch's
// five 64-bit totals.  The counting build spills more at 64
// registers (206 + 152 bytes against 162 + 112) and takes 6-7 % more time
// a frame on an H100, so ops/cuda_path launches it only where its caller
// reads the counts (PERF.md §6).
//
// Every kernel here copies the primitive table into shared memory once per
// block (stage_rows) and walks it one kind at a time: the walk of every row
// per segment takes most of their time (PERF.md §6), and a row comes sooner
// from shared memory than from L1.
//
// Kernel 1 runs a grid of at most kIntersectWaves times the blocks the card
// holds at once, each staging the table once and striding over the
// segments, kIntersectSegs segments a thread so that each row read serves
// all of them; the walk keeps each segment's winning row alone (RowHit), and
// its normal, material and texcoords are read from that row after it.  Per
// segment it reads 24 bytes and writes 32, so at the flagship's 14 rows its
// bound is those bytes; past a few dozen rows, the walk's operations.  What
// holds it back is the walk's instruction rate (PERF.md §6).
//
// The path kernels run one thread per lane in blocks of 128, eight blocks
// an SM (kPathMinBlocks), with a masked ragged tail; the only device-memory
// traffic is each lane's ray in (or nothing, for the camera-fused kernel)
// and its outputs.  Per-lane state stays in registers.

#include "fspt_kernels.cuh"
#include "fspt_mesh.cuh"

namespace fspt {

// Kernel 1's block, the segments a thread walks the rows for at once, its
// launch bounds, and its grid in waves of resident blocks (PERF.md §6: a
// single wave, each block striding over an equal share, lost 7 % to
// the shares' uneven cost; eight let the card's block scheduler even them.
// Three segments a thread gained 1-3 % at 4 M segments and took 22-36 %
// more device time on the 131,072 of a mesh queue's seed).
constexpr int kIntersectBlock = 256;
constexpr int kIntersectSegs = 2;
constexpr int kIntersectMinBlocks = 4;
constexpr int kIntersectWaves = 8;
constexpr int kIntersectTile = kIntersectBlock * kIntersectSegs;

__global__ void __launch_bounds__(kIntersectBlock, kIntersectMinBlocks)
intersect_kernel(const float* __restrict__ prims, const int* __restrict__ meta,
                 int n_prims, const float* __restrict__ start,
                 const float* __restrict__ seg, int n, float* __restrict__ t,
                 float* __restrict__ normal, int* __restrict__ mat,
                 int* __restrict__ kind, float* __restrict__ uv) {
  extern __shared__ float4 smem[];
  const SmemRows rows = stage_rows(smem, prims, meta, n_prims);
  for (int base = blockIdx.x * kIntersectTile; base < n; base += gridDim.x * kIntersectTile) {
    // Segment k of a thread is base + k * kIntersectBlock + threadIdx.x, so
    // each load and store of a warp is contiguous; past the end a thread
    // walks the last segment again and stores nothing.
    Seg s[kIntersectSegs];
    RowHit r[kIntersectSegs];
#pragma unroll
    for (int k = 0; k < kIntersectSegs; ++k) {
      const int i = min(base + k * kIntersectBlock + (int)threadIdx.x, n - 1);
      s[k] = Seg{start[3 * i], start[3 * i + 1], start[3 * i + 2],
                 seg[3 * i], seg[3 * i + 1], seg[3 * i + 2]};
      r[k] = RowHit{kInvalid, -1, 0.0f, 0.0f};
    }
    walk_kinds<true>(rows, s, r);
#pragma unroll
    for (int k = 0; k < kIntersectSegs; ++k) {
      const int i = base + k * kIntersectBlock + (int)threadIdx.x;
      if (i >= n) continue;
      Hit h = winner_hit<true>(rows, r[k], s[k]);
      finish_hit<true>(h, s[k].sx, s[k].sy, s[k].sz, s[k].dx, s[k].dy, s[k].dz);
      t[i] = h.t;
      normal[3 * i] = h.nx;
      normal[3 * i + 1] = h.ny;
      normal[3 * i + 2] = h.nz;
      mat[i] = h.mat;
      kind[i] = h.kind;
      uv[2 * i] = h.u;
      uv[2 * i + 1] = h.v;
    }
  }
}

// Kernel 1's grid cap a device and table size: 0 not yet computed.
static int intersect_resident[64][kMaxPrims + 1];

// The grid of a kernel-1 launch over n segments and n_prims rows:
// kIntersectWaves times the blocks resident on the card at once (occupancy
// at the table's shared memory times the SMs, computed once a device and
// table size), or fewer where the segments fill fewer tiles; -1 where CUDA
// fails.  The counts start at one SM of kIntersectMinBlocks for a runtime
// that reports none.
int intersect_grid(int n_prims, int n) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64 || n_prims < 0
      || n_prims > kMaxPrims)
    return -1;
  int& resident = intersect_resident[dev][n_prims];
  if (resident == 0) {
    const size_t smem = rows_smem(n_prims);
    if (allow_smem(intersect_kernel, smem) != cudaSuccess) return -1;
    int per_sm = kIntersectMinBlocks, sms = 1;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, intersect_kernel,
                                                      kIntersectBlock, smem) != cudaSuccess
        || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess
        || per_sm * sms <= 0)
      return -1;
    resident = kIntersectWaves * per_sm * sms;
  }
  const int wanted = blocks_for(n, kIntersectTile);
  return wanted < resident ? wanted : resident;
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

// Kernel 13: kernel 2 on a BVH scene.  Threads past n take no lane but
// reach the warp's count.
template <bool kCount>
__global__ void __launch_bounds__(kPathBlock, kMeshMinBlocks)
mesh_camera_path_kernel(const float* __restrict__ prims, const int* __restrict__ meta,
                        const float* __restrict__ mats, const int* __restrict__ mat_meta,
                        const PathParams pp, const CamParams cp,
                        const float4* __restrict__ nodes, int n_nodes,
                        const float4* __restrict__ tris, const float4* __restrict__ shade,
                        uint32_t h0, int sample0, int lane0, int n,
                        float* __restrict__ radiance, float* __restrict__ normal,
                        float* __restrict__ depth, int* __restrict__ aov_mat,
                        int* __restrict__ segcnt, unsigned long long* __restrict__ walk) {
  extern __shared__ float4 smem[];
  const MeshRows<kCount> rows{stage_rows(smem, prims, meta, pp.n_prims), nodes, tris, shade,
                              n_nodes, 0u, 0u, 0u, 0u, 0u};
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    const CameraRay r = camera_ray(cp, h0, sample0, lane0 + i);
    NoSlots none;
    const PathOut o = trace_path<kDirect>(rows, mats, mat_meta, pp, r.hs, r.sx, r.sy, r.sz,
                                          r.dx, r.dy, r.dz, none);
    write_path(o, i, radiance, normal, depth, aov_mat, segcnt);
  }
  if (kCount) {
    const unsigned counts[kMeshTotals] = {rows.visits, rows.tests, rows.phases, rows.leaves,
                                          rows.walks};
#ifdef __CUDA_ARCH__
#pragma unroll
    for (int k = 0; k < kMeshTotals; ++k) {
      const unsigned c = __reduce_add_sync(0xffffffffu, counts[k]);
      if ((threadIdx.x & 31) == 0) atomicAdd(walk + k, (unsigned long long)c);
    }
#elif defined(FSPT_HOST_SHIM)
    // The host build (tests/host_shim) runs each thread alone, twice; the
    // second pass, on complete staged rows, counts.
    if (shim_pass == 1)
      for (int k = 0; k < kMeshTotals; ++k) atomicAdd(walk + k, (unsigned long long)counts[k]);
#endif
  }
}

}  // namespace fspt

extern "C" {

// Kernel 1's launch over n segments and n_prims rows (fspt_intersect
// follows it): *grid blocks, each taking *tile segments a stride.
int fspt_intersect_plan(int n_prims, int n, int* grid, int* tile) {
  using namespace fspt;
  *grid = n > 0 ? intersect_grid(n_prims, n) : 0;
  *tile = kIntersectTile;
  return *grid < 0 ? (int)cudaErrorInvalidConfiguration : 0;
}

int fspt_intersect(const float* prims, const int* meta, int n_prims,
                   const float* start, const float* seg, int n, float* t,
                   float* normal, int* mat, int* kind, float* uv,
                   void* stream) {
  using namespace fspt;
  if (n <= 0) return 0;
  const int grid = intersect_grid(n_prims, n);
  if (grid < 0) return (int)cudaErrorInvalidConfiguration;
  intersect_kernel<<<grid, kIntersectBlock, rows_smem(n_prims), (cudaStream_t)stream>>>(
      prims, meta, n_prims, start, seg, n, t, normal, mat, kind, uv);
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

// Kernel 13.  walk: kMeshTotals 64-bit totals (node steps, triangle tests,
// leaf phases, leaves tested in them, warp walks), zeroed here and counted
// into; null launches the build that counts nothing.
int fspt_mesh_camera_path(const float* prims, const int* meta, const float* mats,
                          const int* mat_meta, fspt::PathParams pp, fspt::CamParams cp,
                          const float* nodes, int n_nodes, const float* tris,
                          const float* shade, unsigned int h0, int sample0, int lane0, int n,
                          float* radiance, float* normal, float* depth, int* aov_mat,
                          int* segcnt, unsigned long long* walk, void* stream) {
  using namespace fspt;
  if (walk != nullptr) {
    const cudaError_t err =
        cudaMemsetAsync(walk, 0, kMeshTotals * sizeof(unsigned long long), (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
  }
  if (n <= 0) return 0;
  const size_t smem = rows_smem(pp.n_prims);
  auto kernel = walk != nullptr ? mesh_camera_path_kernel<true> : mesh_camera_path_kernel<false>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks_for(n, kPathBlock), kPathBlock, smem, (cudaStream_t)stream>>>(
      prims, meta, mats, mat_meta, pp, cp, reinterpret_cast<const float4*>(nodes), n_nodes,
      reinterpret_cast<const float4*>(tris), reinterpret_cast<const float4*>(shade), h0,
      sample0, lane0, n, radiance, normal, depth, aov_mat, segcnt, walk);
  return (int)cudaGetLastError();
}

}  // extern "C"
