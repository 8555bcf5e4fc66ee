// What the gradient kernels share (the path-body adjoint in
// csrc/fspt_adjoint.cu, kernel 8's affine construction in csrc/fspt_grad.cu):
// the block's copy of the material table with the parameter vector written
// into its cells, the per-thread gradient columns in shared memory and the
// rule that sizes their block, the fixed-order block sums, and the
// reduction over blocks in double.  No atomics anywhere: the same inputs
// give the same bits on every run.
#pragma once

#include "fspt_kernels.cuh"

namespace fspt {

constexpr int kAdjBlock = 128;
constexpr int kAdjWarps = kAdjBlock / 32;
constexpr int kMaxAdjMats = 64;  // material rows of the shared table
constexpr int kReduceBlock = 256;
constexpr size_t kMaxDynSmem = 232448 - 1024;  // a block's shared memory, less static

// The threads of a block whose shared memory is fixed bytes plus
// per_thread bytes a thread (its gradient column, and what else it keeps
// there): 128, or 64 or 32 where 128 would not fit; 0 where none does.
__host__ __device__ constexpr int column_block(size_t fixed, size_t per_thread) {
  for (int block = kAdjBlock; block >= 32; block >>= 1) {
    if (fixed + per_thread * block <= kMaxDynSmem) return block;
  }
  return 0;
}

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

// The block's column of a [Q][gridDim.x] partial: dst[q * gridDim.x +
// blockIdx.x] = the block's sum of row q of acc ([Q][blockDim], thread t's
// column at acc[q * blockDim + t]), in a fixed order: warp shuffles, then
// the warps in turn.  Each warp's sum lands in its first slot of the row,
// which only that warp's lane 0 reads.
__device__ __forceinline__ void block_columns(float* acc, int Q, float* dst) {
  const int B = blockDim.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int q = 0; q < Q; ++q) {
    const float s = warp_sum(acc[q * B + threadIdx.x]);
    if (lane == 0) acc[q * B + warp * 32] = s;
  }
  __syncthreads();
  for (int q = threadIdx.x; q < Q; q += B) {
    float s = 0.0f;
    for (int w = 0; w < (B >> 5); ++w) s += acc[q * B + w * 32];
    dst[(size_t)q * gridDim.x + blockIdx.x] = s;
  }
}

// The block sums of a and b (any block of whole warps, at most kAdjBlock
// threads) into the block's column of a [2][gridDim.x] partial.
__device__ __forceinline__ void block_ints(int a, int b, int* warp_int, int* dst) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sa = warp_sum(a), sb = warp_sum(b);
  if (lane == 0) { warp_int[2 * warp] = sa; warp_int[2 * warp + 1] = sb; }
  __syncthreads();
  if (threadIdx.x < 2) {
    int s = 0;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += warp_int[2 * w + threadIdx.x];
    dst[(size_t)threadIdx.x * gridDim.x + blockIdx.x] = s;
  }
}

// out[j] (j < Q) sums row j of partial ([Q][blocks], one column a block)
// and int_out[r] row r of int_partial ([R][blocks]), read coalesced.  One
// block per row, each thread a fixed stride of its blocks, then a fixed
// tree, in double.
__global__ void __launch_bounds__(kReduceBlock)
adjoint_reduce(const float* __restrict__ partial, const int* __restrict__ int_partial,
               int blocks, int Q, double* __restrict__ out, long long* __restrict__ int_out) {
  __shared__ double red[kReduceBlock];
  const int j = blockIdx.x;
  double acc = 0.0;
  for (int b = threadIdx.x; b < blocks; b += kReduceBlock) {
    if (j < Q) {
      acc += (double)partial[(size_t)j * blocks + b];
    } else {
      acc += (double)int_partial[(size_t)(j - Q) * blocks + b];
    }
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
