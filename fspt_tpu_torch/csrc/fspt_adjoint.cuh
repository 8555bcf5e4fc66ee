// What the path-body adjoint kernels share (csrc/fspt_adjoint.cu, and the
// forward-mode witnesses in csrc/fspt_fwdmode.cu): the block's copy of the
// material table with the parameter vector written into its cells, the
// fixed-order block sums, and the reduction over blocks in double.  No
// atomics anywhere: the same inputs give the same bits on every run.
#pragma once

#include "fspt_kernels.cuh"

namespace fspt {

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

// The block sums of v[0..count) in a fixed order, written to dst[0..count)
// (blocks of kAdjBlock threads).
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

// The block sums of a and b (any block of whole warps, at most kAdjBlock
// threads) into dst[0..2).
__device__ __forceinline__ void block_ints(int a, int b, int* warp_int, int* dst) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sa = warp_sum(a), sb = warp_sum(b);
  if (lane == 0) { warp_int[2 * warp] = sa; warp_int[2 * warp + 1] = sb; }
  __syncthreads();
  if (threadIdx.x < 2) {
    int s = 0;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += warp_int[2 * w + threadIdx.x];
    dst[threadIdx.x] = s;
  }
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
