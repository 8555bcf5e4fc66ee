// The path-body adjoint of the port: kernels 9, 10 and kernel 8's whole
// chain.  Plain C launchers, loaded with ctypes by ops/_build.py; each
// returns cudaGetLastError().
//
//   fspt_grad_forward      kernel 9   replaces pallas_grad.py:216
//                                     make_grad_path_tracer fwd (body :188)
//   fspt_grad_backward     kernel 10  replaces pallas_grad.py:227
//                                     make_grad_path_tracer bwd (body :193)
//   fspt_fused_loss_chain  kernel 8   replaces pallas_grad.py:792
//                                     make_fused_loss_grad_fn, whole chain
//                                     and remat (body :589, :700-753)
//
// The optimized table cells come at run time in a parameter vector pvec
// [P] with a cell map cells[P_mat] (the row * kMatStride + column each
// packed material parameter overwrites; the 9 camera values of kernel 8
// follow the material ones).  Each block copies the material table into
// shared memory and writes the parameters into their cells, so the body
// reads them as it reads any table value.
//
// Kernel 9 traces the float body over that table: the plain version (the
// body with tmats) and it agree bit for bit.  Kernels 10 and 8 need the
// adjoint of the whole path body.  JAX got it from jax.vjp inside the
// kernel; here it is forward mode: the body instantiated on Tangent<K>
// (csrc/fspt_tangent.cuh), K derivatives per value, traced ceil(P/K)
// times per lane, pass j seeding parameter j*K + k into component k where
// the body reads its cell (or, for the camera, in traced_camera_ray).  Each
// lane dots its radiance tangents with its cotangent (kernel 10: the
// incoming radiance cotangent; kernel 8: (B - t) into buffer A and (A - t)
// into B) and writes nothing per lane: blocks sum their lanes in a fixed
// order (warp shuffles, then the warps in turn) into one row per block, and
// adjoint_reduce sums each column over the blocks in double.  No atomics:
// the same inputs give the same bits on every run.  A lane's contribution
// to an entry that is not finite is zeroed and the lane counted (the
// forward-mode counterpart of the reference's _keep_finite).  There is no
// live set to checkpoint in forward mode, so kernel 8's remat construction
// is this same kernel.
//
// What bounds them on the H100: operations.  Kernel 9 is kernel 2's work;
// kernel 10 re-traces each lane ceil(P/K) times at (1 + 2K) operations per
// multiply; kernel 8 traces two buffers per pass.  The tangent state of a
// lane (K + 1 floats per value) exceeds the register file at K = 8, so
// those kernels spill to local memory; K = 4 was chosen from -Xptxas -v
// (PERF.md), and ops/cuda_grad.py's TANGENT_K mirrors it.

#include "fspt_kernels.cuh"

namespace fspt {

constexpr int kTangentK = 4;
constexpr int kAdjBlock = 128;
constexpr int kAdjWarps = kAdjBlock / 32;
constexpr int kMaxAdjMats = 64;  // material rows of the shared table
constexpr int kReduceBlock = 256;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// The block's copy of the material table with pvec written into its cells;
// seed (when given) maps each cell to its parameter index, or -1.
__device__ __forceinline__ void load_table(float* tab, int* seed,
                                           const float* __restrict__ mats, int n_mats,
                                           const float* __restrict__ pvec,
                                           const int* __restrict__ cells, int n_cells) {
  const int total = n_mats * kMatStride;
  for (int j = threadIdx.x; j < total; j += blockDim.x) {
    tab[j] = mats[j];
    if (seed) seed[j] = -1;
  }
  __syncthreads();
  for (int p = threadIdx.x; p < n_cells; p += blockDim.x) {
    tab[cells[p]] = pvec[p];
    if (seed) seed[cells[p]] = p;
  }
  __syncthreads();
}

// The block sums of v[0..count) in a fixed order, written to dst[0..count).
template <int K>
__device__ __forceinline__ void block_row(const float (&v)[K], float* warp_part, float* dst,
                                          int count) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float s = warp_sum(v[k]);
    if (lane == 0) warp_part[warp * K + k] = s;
  }
  __syncthreads();
  if (threadIdx.x < count) {
    float s = 0.0f;
    for (int w = 0; w < kAdjWarps; ++w) s += warp_part[w * K + threadIdx.x];
    dst[threadIdx.x] = s;
  }
  __syncthreads();
}

__device__ __forceinline__ void block_ints(int a, int b, int* warp_int, int* dst) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sa = warp_sum(a), sb = warp_sum(b);
  if (lane == 0) { warp_int[2 * warp] = sa; warp_int[2 * warp + 1] = sb; }
  __syncthreads();
  if (threadIdx.x < 2) {
    int s = 0;
    for (int w = 0; w < kAdjWarps; ++w) s += warp_int[2 * w + threadIdx.x];
    dst[threadIdx.x] = s;
  }
}

// Shared memory of the tangent kernels: table and seed map [M·kMatStride]
// each, then the per-warp rows of block_row.
__host__ __device__ constexpr size_t adjoint_smem(int n_mats) {
  return sizeof(float) * (2 * n_mats * kMatStride + kAdjWarps * kTangentK);
}

// Kernel 9: the float body over the run-time table; radiance as [3][n]
// planes and the lane's segment count.
__global__ void __launch_bounds__(kAdjBlock)
grad_forward_kernel(const float* __restrict__ prims, const int* __restrict__ meta,
                    const float* __restrict__ mats, const int* __restrict__ mat_meta,
                    const PathParams pp, const CamParams cp, const float* __restrict__ pvec,
                    const int* __restrict__ cells, int n_cells, uint32_t h0, int sample0,
                    int lane0, int n, float* __restrict__ radiance,
                    int* __restrict__ segcnt) {
  extern __shared__ float smem[];
  load_table(smem, nullptr, mats, pp.n_mats, pvec, cells, n_cells);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const CameraRay r = camera_ray(cp, h0, sample0, lane0 + i);
  NoSlots none;
  const PathOut o = trace_path_t<kDirect, float>(prims, meta, SmemMats{smem}, mat_meta, pp,
                                                 r.hs, r.sx, r.sy, r.sz, r.dx, r.dy, r.dz,
                                                 none);
  radiance[i] = o.L[0];
  radiance[(size_t)n + i] = o.L[1];
  radiance[2 * (size_t)n + i] = o.L[2];
  segcnt[i] = o.segcnt;
}

// One buffer of one lane on Tangent<K>: camera_ray's fixed ray, or with
// use_camera the traced ray of the camera values pvec[n_cells .. +9),
// seeded as parameters n_cells .. n_cells + 8.
template <int K>
__device__ __forceinline__ PathOutT<Tangent<K>> trace_tangent(
    const float* __restrict__ prims, const int* __restrict__ meta, const SeededMats<K>& sm,
    const int* __restrict__ mat_meta, const PathParams& pp, const CamParams& cp,
    const TracedCamParams& tp, const float* __restrict__ pvec, int n_cells,
    bool use_camera, uint32_t h0, int sample0, int flat) {
  using T = Tangent<K>;
  CameraRayT<T> r;
  if (use_camera) {
    T cv[9];
#pragma unroll
    for (int j = 0; j < 9; ++j) cv[j] = seeded<K>(pvec[n_cells + j], n_cells + j, sm.p0);
    r = traced_camera_ray(cp, tp, cv, h0, sample0, flat);
  } else {
    const CameraRay f = camera_ray(cp, h0, sample0, flat);
    r.sx = f.sx; r.sy = f.sy; r.sz = f.sz;
    r.dx = f.dx; r.dy = f.dy; r.dz = f.dz;
    r.hs = f.hs;
  }
  NoSlots none;
  return trace_path_t<kDirect, T>(prims, meta, sm, mat_meta, pp, r.hs, r.sx, r.sy, r.sz,
                                  r.dx, r.dy, r.dz, none);
}

// Kernel 10: per lane and pass, cot · d(radiance)/d(parameters of the
// pass); partial [blocks][n_cells], bad [blocks] (lanes with a zeroed
// non-finite contribution).
template <int K>
__global__ void __launch_bounds__(kAdjBlock)
grad_backward_kernel(const float* __restrict__ prims, const int* __restrict__ meta,
                     const float* __restrict__ mats, const int* __restrict__ mat_meta,
                     const PathParams pp, const CamParams cp, const float* __restrict__ pvec,
                     const int* __restrict__ cells, int n_cells, uint32_t h0, int sample0,
                     int lane0, int n, const float* __restrict__ cot,
                     float* __restrict__ partial, int* __restrict__ int_partial) {
  extern __shared__ float smem[];
  __shared__ int warp_int[2 * kAdjWarps];
  const int cells_total = pp.n_mats * kMatStride;
  float* tab = smem;
  int* seed = reinterpret_cast<int*>(smem + cells_total);
  float* warp_part = smem + 2 * cells_total;
  load_table(tab, seed, mats, pp.n_mats, pvec, cells, n_cells);

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  const TracedCamParams unused{0.0f, 0.0f};
  float c[3] = {0.0f, 0.0f, 0.0f};
  if (live) {
    c[0] = cot[i];
    c[1] = cot[(size_t)n + i];
    c[2] = cot[2 * (size_t)n + i];
  }
  int bad = 0;
  for (int p0 = 0; p0 < n_cells; p0 += K) {
    float g[K];
#pragma unroll
    for (int k = 0; k < K; ++k) g[k] = 0.0f;
    if (live) {
      const SeededMats<K> sm{tab, seed, p0};
      const PathOutT<Tangent<K>> o = trace_tangent<K>(prims, meta, sm, mat_meta, pp, cp,
                                                      unused, pvec, n_cells, false, h0,
                                                      sample0, lane0 + i);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        float v = c[0] * o.L[0].d[k] + c[1] * o.L[1].d[k] + c[2] * o.L[2].d[k];
        if (!isfinite(v)) { v = 0.0f; bad = 1; }
        g[k] = v;
      }
    }
    block_row<K>(g, warp_part, partial + (size_t)blockIdx.x * n_cells + p0,
                 min(K, n_cells - p0));
  }
  block_ints(bad, 0, warp_int, int_partial + 2 * (size_t)blockIdx.x);
}

// Kernel 8, whole chain: per lane the two buffers, the lane loss
// sum_c (a_c - t_c)(b_c - t_c) and, per pass, both adjoints (cotangent
// b - t into A, a - t into B); partial [blocks][1 + P] (loss, gradient),
// int_partial [blocks][2] (segments of both buffers, bad lanes).
template <int K>
__global__ void __launch_bounds__(kAdjBlock)
fused_loss_chain_kernel(const float* __restrict__ prims, const int* __restrict__ meta,
                        const float* __restrict__ mats, const int* __restrict__ mat_meta,
                        const PathParams pp, const CamParams cp, const TracedCamParams tp,
                        const float* __restrict__ pvec, const int* __restrict__ cells,
                        int n_cells, int P, int use_camera, uint32_t h0, int sample0_a,
                        int sample0_b, int lane0, int n, const float* __restrict__ target,
                        float* __restrict__ partial, int* __restrict__ int_partial) {
  extern __shared__ float smem[];
  __shared__ int warp_int[2 * kAdjWarps];
  const int cells_total = pp.n_mats * kMatStride;
  float* tab = smem;
  int* seed = reinterpret_cast<int*>(smem + cells_total);
  float* warp_part = smem + 2 * cells_total;
  load_table(tab, seed, mats, pp.n_mats, pvec, cells, n_cells);

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  const int Q = 1 + P;
  float* row = partial + (size_t)blockIdx.x * Q;
  float t[3] = {0.0f, 0.0f, 0.0f};
  if (live) {
    // The target pixel of this lane (band-local lane order pixel-major).
    const float* tp_ = target + 3 * (i / cp.spp);
    t[0] = tp_[0]; t[1] = tp_[1]; t[2] = tp_[2];
  }
  float loss = 0.0f;
  int segs = 0, bad = 0;
  for (int p0 = 0; p0 < P; p0 += K) {
    float g[K];
#pragma unroll
    for (int k = 0; k < K; ++k) g[k] = 0.0f;
    if (live) {
      const SeededMats<K> sm{tab, seed, p0};
      // Buffer A, then B, through one copy of the body.
      PathOutT<Tangent<K>> oa, ob;
#pragma unroll 1
      for (int buf = 0; buf < 2; ++buf) {
        const PathOutT<Tangent<K>> o = trace_tangent<K>(
            prims, meta, sm, mat_meta, pp, cp, tp, pvec, n_cells, use_camera != 0, h0,
            buf == 0 ? sample0_a : sample0_b, lane0 + i);
        if (buf == 0) oa = o;
        else ob = o;
      }
      float ra[3], rb[3];
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        ra[ch] = oa.L[ch].v - t[ch];
        rb[ch] = ob.L[ch].v - t[ch];
      }
      if (p0 == 0) {
        loss = ra[0] * rb[0] + ra[1] * rb[1] + ra[2] * rb[2];
        segs = oa.segcnt + ob.segcnt;
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        float v = rb[0] * oa.L[0].d[k] + rb[1] * oa.L[1].d[k] + rb[2] * oa.L[2].d[k]
                  + ra[0] * ob.L[0].d[k] + ra[1] * ob.L[1].d[k] + ra[2] * ob.L[2].d[k];
        if (!isfinite(v)) { v = 0.0f; bad = 1; }
        g[k] = v;
      }
    }
    if (p0 == 0) {
      float lv[K];
#pragma unroll
      for (int k = 0; k < K; ++k) lv[k] = k == 0 ? loss : 0.0f;
      block_row<K>(lv, warp_part, row, 1);
    }
    block_row<K>(g, warp_part, row + 1 + p0, min(K, P - p0));
  }
  block_ints(segs, bad, warp_int, int_partial + 2 * (size_t)blockIdx.x);
}

// Column j < Q of out sums partial[:, j], column Q + r of int_out sums
// int_partial[:, r]; one block per column, each thread a fixed stride of
// block rows, then a fixed tree, in double.
__global__ void __launch_bounds__(kReduceBlock)
adjoint_reduce(const float* __restrict__ partial, const int* __restrict__ int_partial,
               int blocks, int Q, int R, double* __restrict__ out,
               long long* __restrict__ int_out) {
  __shared__ double red[kReduceBlock];
  const int j = blockIdx.x;
  double acc = 0.0;
  for (int b = threadIdx.x; b < blocks; b += kReduceBlock) {
    acc += j < Q ? (double)partial[(size_t)b * Q + j]
                 : (double)int_partial[(size_t)b * R + (j - Q)];
  }
  red[threadIdx.x] = acc;
  __syncthreads();
  for (int s = kReduceBlock / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    if (j < Q) out[j] = red[0];
    else int_out[j - Q] = (long long)red[0];
  }
}

inline int check_mats(const PathParams& pp) {
  return pp.n_mats > kMaxAdjMats ? (int)cudaErrorInvalidValue : 0;
}

}  // namespace fspt

extern "C" {

// radiance: [3, n] float; segcnt: [n] int.
int fspt_grad_forward(const float* prims, const int* meta, const float* mats,
                      const int* mat_meta, fspt::PathParams pp, fspt::CamParams cp,
                      const float* pvec, const int* cells, int n_cells, unsigned int h0,
                      int sample0, int lane0, int n, float* radiance, int* segcnt,
                      void* stream) {
  using namespace fspt;
  if (int err = check_mats(pp)) return err;
  if (n <= 0) return 0;
  const size_t smem = sizeof(float) * pp.n_mats * kMatStride;
  grad_forward_kernel<<<blocks_for(n, kAdjBlock), kAdjBlock, smem, (cudaStream_t)stream>>>(
      prims, meta, mats, mat_meta, pp, cp, pvec, cells, n_cells, h0, sample0, lane0, n,
      radiance, segcnt);
  return (int)cudaGetLastError();
}

// cot: [3, n] float; partial: [blocks, n_cells] float and int_partial
// [blocks, 2] int scratch, blocks = ceil(n / 128); out: [n_cells] double;
// int_out: [2] int64 (0, lanes with a zeroed non-finite contribution).
int fspt_grad_backward(const float* prims, const int* meta, const float* mats,
                       const int* mat_meta, fspt::PathParams pp, fspt::CamParams cp,
                       const float* pvec, const int* cells, int n_cells, unsigned int h0,
                       int sample0, int lane0, int n, const float* cot, float* partial,
                       int* int_partial, double* out, long long* int_out, void* stream) {
  using namespace fspt;
  if (int err = check_mats(pp)) return err;
  if (n <= 0 || n_cells <= 0) return 0;
  const int blocks = blocks_for(n, kAdjBlock);
  cudaStream_t st = (cudaStream_t)stream;
  grad_backward_kernel<kTangentK><<<blocks, kAdjBlock, adjoint_smem(pp.n_mats), st>>>(
      prims, meta, mats, mat_meta, pp, cp, pvec, cells, n_cells, h0, sample0, lane0, n, cot,
      partial, int_partial);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  adjoint_reduce<<<n_cells + 2, kReduceBlock, 0, st>>>(partial, int_partial, blocks,
                                                       n_cells, 2, out, int_out);
  return (int)cudaGetLastError();
}

// n_cells material parameters, then (use_camera) the 9 camera values:
// P = n_cells + 9·use_camera.  target: [n / spp, 3]; partial [blocks, 1 +
// P] float and int_partial [blocks, 2] int scratch; out: [1 + P] double
// (loss, gradient); int_out: [2] int64 (segments, bad lanes).
int fspt_fused_loss_chain(const float* prims, const int* meta, const float* mats,
                          const int* mat_meta, fspt::PathParams pp, fspt::CamParams cp,
                          fspt::TracedCamParams tp, const float* pvec, const int* cells,
                          int n_cells, int use_camera, unsigned int h0, int sample0_a,
                          int sample0_b, int lane0, int n, const float* target,
                          float* partial, int* int_partial, double* out,
                          long long* int_out, void* stream) {
  using namespace fspt;
  if (int err = check_mats(pp)) return err;
  const int P = n_cells + (use_camera ? 9 : 0);
  if (n <= 0 || P <= 0) return 0;
  const int blocks = blocks_for(n, kAdjBlock);
  cudaStream_t st = (cudaStream_t)stream;
  fused_loss_chain_kernel<kTangentK><<<blocks, kAdjBlock, adjoint_smem(pp.n_mats), st>>>(
      prims, meta, mats, mat_meta, pp, cp, tp, pvec, cells, n_cells, P, use_camera, h0,
      sample0_a, sample0_b, lane0, n, target, partial, int_partial);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  adjoint_reduce<<<1 + P + 2, kReduceBlock, 0, st>>>(partial, int_partial, blocks, 1 + P, 2,
                                                     out, int_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
