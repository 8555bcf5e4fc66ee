// Kernel 8 of the port: the fused dual-buffer loss and its gradient, affine
// construction.  Replaces pallas_grad.py make_fused_loss_grad_fn (kernel
// body :589, call :792) for radiometric fields.  Plain C launcher, loaded
// with ctypes by ops/_build.py; it returns cudaGetLastError().
//
// One thread per lane:
//   1. trace buffer A (samples from sample0_a) and buffer B (sample0_b) in
//      kDeferAll mode; each buffer's <= kMaxSlots slots (s, k, se, mat,
//      mat_e) stay in a per-thread array;
//   2. fold each buffer with the table values held in shared memory
//      (coef value tc = diffuse[mat] or 0, bias value te = bias_table[mat_e]
//      or 1), L += T·te·se; T *= tc·s + k, then the depth-0 light clamp;
//   3. lane loss sum_c (a_c - t_c)(b_c - t_c);
//   4. the adjoint of the fold and the clamp, written out: A with
//      cotangent (b - t), B with (a - t).  The clamp's Jacobian is
//      c·(I - L̂L̂ᵀ)/|L| where it applies; then the D steps of the fold in
//      reverse accumulate d/d tc[row] and d/d te[row] into a per-thread
//      gradient of 6·M values.
// The TPU kernel carried its sums across sequential grid steps; Hopper
// blocks run in no order.  So each block reduces its lanes in a fixed order
// (warp shuffles, then the warps in turn) and writes one partial row
// [loss, grad(6M)] and its segment count; a second kernel sums the rows of
// all blocks per column in a fixed order, in double.  No atomics: the same
// inputs give the same bits on every run.
//
// What bounds it on the H100: operations.  It traces two buffers (twice
// the segments of one frame) and writes only ~4·(6M+1) bytes per block;
// the fold and its adjoint add a few dozen operations per slot.  The
// per-thread slots and gradient live in local memory (spills that stay in
// L1 for the most part); the design accepts that for a first port.

#include "fspt_kernels.cuh"

namespace fspt {

constexpr int kGradBlock = 128;
constexpr int kGradWarps = kGradBlock / 32;
constexpr int kMaxSlots = 16;      // depth + fast-render terminal
constexpr int kMaxGradMats = 64;   // material rows of the per-thread gradient
constexpr int kReduceBlock = 256;

struct SlotVals {
  float s, k, se;
  int mc, me;
};

// Kernel 8's sink: the slots of one buffer, in a per-thread array.
struct LocalSlots {
  SlotVals* v;

  __device__ __forceinline__ void put(int d, const Slot& sl) {
    v[d] = SlotVals{sl.s, sl.k[0], sl.se, sl.mat, sl.mat_e};
  }
};

// The value a slot's coefficient reads: diffuse[mat], 0 off the table.
__device__ __forceinline__ float coef_value(const float* tc_tab, int row, int n_mats,
                                            int c) {
  return (row >= 0 && row < n_mats) ? tc_tab[3 * row + c] : 0.0f;
}

// The value a slot's bias reads: bias_table[mat_e], 1 for mat_e < 0 (the
// fast-render white slot), 0 off the table's end.
__device__ __forceinline__ float bias_value(const float* te_tab, int row, int n_mats,
                                            int c) {
  return row < 0 ? 1.0f : (row < n_mats ? te_tab[3 * row + c] : 0.0f);
}

struct Folded {
  float L[3];    // radiance before the clamp
  float out[3];  // after
  float norm;
  bool clamped;
};

// The fold (pallas_grad.py _fold_slots, pallas_path.py fold_deferred_params)
// in the order of ops/cuda_path.py fold_deferred_params.  T_pre[d] keeps the
// throughput before slot d for the adjoint.
__device__ __forceinline__ Folded fold_slots(const SlotVals* sl, int n_slot,
                                             const float* tc_tab, const float* te_tab,
                                             int n_mats, bool p_light, float light_clamp,
                                             float (*T_pre)[3]) {
  Folded f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float T = 1.0f, L = 0.0f;
    for (int d = 0; d < n_slot; ++d) {
      const SlotVals v = sl[d];
      T_pre[d][c] = T;
      const float tc = coef_value(tc_tab, v.mc, n_mats, c);
      const float te = bias_value(te_tab, v.me, n_mats, c);
      L = L + T * (te * v.se);
      T = T * (tc * v.s + v.k);
    }
    f.L[c] = L;
  }
  // Depth-0 light tone clamp (engine.cpp:148-151).
  const float n2 = f.L[0] * f.L[0] + f.L[1] * f.L[1] + f.L[2] * f.L[2];
  f.norm = sqrtf(fmaxf(n2, 1e-20f));
  f.clamped = p_light && f.norm > light_clamp;
  const float sc = f.clamped ? light_clamp / f.norm : 1.0f;
  f.out[0] = f.L[0] * sc;
  f.out[1] = f.L[1] * sc;
  f.out[2] = f.L[2] * sc;
  return f;
}

// Adjoint of fold_slots for the cotangent g of its output: accumulates
// d<g, out>/d tc[row][c] into grad[3*row + c] and d/d te[row][c] into
// grad[3*(n_mats + row) + c].
__device__ __forceinline__ void fold_adjoint(const SlotVals* sl, int n_slot,
                                             const float* tc_tab, const float* te_tab,
                                             int n_mats, const Folded& f,
                                             float light_clamp, const float g[3],
                                             float (*T_pre)[3], float* grad) {
  float gL[3] = {g[0], g[1], g[2]};
  if (f.clamped) {
    // out = L·c/|L|: gL = (c/|L|)·(g - L̂ (L̂·g)).
    const float sc = light_clamp / f.norm;
    const float dot = g[0] * f.L[0] + g[1] * f.L[1] + g[2] * f.L[2];
    const float w = sc * dot / (f.norm * f.norm);
#pragma unroll
    for (int c = 0; c < 3; ++c) gL[c] = g[c] * sc - f.L[c] * w;
  }
  float* grad_te = grad + 3 * n_mats;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float gT = 0.0f;  // cotangent of the throughput after slot d
    for (int d = n_slot - 1; d >= 0; --d) {
      const SlotVals v = sl[d];
      const float T = T_pre[d][c];
      const float tc = coef_value(tc_tab, v.mc, n_mats, c);
      const float te = bias_value(te_tab, v.me, n_mats, c);
      if (v.me >= 0 && v.me < n_mats) grad_te[3 * v.me + c] += gL[c] * T * v.se;
      if (v.mc >= 0 && v.mc < n_mats) grad[3 * v.mc + c] += gT * T * v.s;
      gT = gL[c] * (te * v.se) + gT * (tc * v.s + v.k);
    }
  }
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

// Dynamic shared memory: tc_tab [3M], te_tab [3M], then one partial row
// [1 + 6M] per warp.
__global__ void __launch_bounds__(kGradBlock)
fused_loss_kernel(const float* __restrict__ prims, const int* __restrict__ meta,
                  const float* __restrict__ mats, const int* __restrict__ mat_meta,
                  const PathParams pp, const CamParams cp,
                  const float* __restrict__ tc_g, const float* __restrict__ te_g,
                  uint32_t h0, int sample0_a, int sample0_b, int lane0, int n,
                  const float* __restrict__ target, float* __restrict__ partial,
                  int* __restrict__ seg_partial) {
  extern __shared__ float smem[];
  __shared__ int seg_warp[kGradWarps];
  const int M = pp.n_mats;
  const int Q = 1 + 6 * M;
  float* tc_tab = smem;
  float* te_tab = smem + 3 * M;
  float* warp_part = smem + 6 * M;
  for (int j = threadIdx.x; j < 3 * M; j += blockDim.x) {
    tc_tab[j] = tc_g[j];
    te_tab[j] = te_g[j];
  }
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  float loss = 0.0f;
  int segs = 0;
  float grad[6 * kMaxGradMats];
  for (int j = 0; j < 6 * M; ++j) grad[j] = 0.0f;

  if (i < n) {
    const int n_slot = pp.depth + (pp.fast_render ? 1 : 0);
    SlotVals slots_a[kMaxSlots], slots_b[kMaxSlots];
    float T_a[kMaxSlots][3], T_b[kMaxSlots][3];
    const CameraRay ra = camera_ray(cp, h0, sample0_a, lane0 + i);
    LocalSlots sink_a{slots_a};
    const PathOut oa = trace_path<kDeferAll>(prims, meta, mats, mat_meta, pp, ra.hs,
                                             ra.sx, ra.sy, ra.sz, ra.dx, ra.dy, ra.dz,
                                             sink_a);
    const CameraRay rb = camera_ray(cp, h0, sample0_b, lane0 + i);
    LocalSlots sink_b{slots_b};
    const PathOut ob = trace_path<kDeferAll>(prims, meta, mats, mat_meta, pp, rb.hs,
                                             rb.sx, rb.sy, rb.sz, rb.dx, rb.dy, rb.dz,
                                             sink_b);
    segs = oa.segcnt + ob.segcnt;
    const Folded fa = fold_slots(slots_a, n_slot, tc_tab, te_tab, M, oa.p_light,
                                 pp.light_clamp, T_a);
    const Folded fb = fold_slots(slots_b, n_slot, tc_tab, te_tab, M, ob.p_light,
                                 pp.light_clamp, T_b);
    // The target pixel of this lane (band-local lane order pixel-major).
    const float* t = target + 3 * (i / cp.spp);
    float res_a[3], res_b[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      res_a[c] = fa.out[c] - t[c];
      res_b[c] = fb.out[c] - t[c];
    }
    loss = res_a[0] * res_b[0] + res_a[1] * res_b[1] + res_a[2] * res_b[2];
    fold_adjoint(slots_a, n_slot, tc_tab, te_tab, M, fa, pp.light_clamp, res_b, T_a, grad);
    fold_adjoint(slots_b, n_slot, tc_tab, te_tab, M, fb, pp.light_clamp, res_a, T_b, grad);
  }

  // Block partial, in a fixed order: each warp by shuffles, then the warps
  // in turn.  Lanes past n add zeros.
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int j = 0; j < Q; ++j) {
    const float v = warp_sum(j == 0 ? loss : grad[j - 1]);
    if (lane == 0) warp_part[warp * Q + j] = v;
  }
  const int sv = warp_sum(segs);
  if (lane == 0) seg_warp[warp] = sv;
  __syncthreads();
  for (int j = threadIdx.x; j < Q; j += blockDim.x) {
    float s = 0.0f;
    for (int w = 0; w < kGradWarps; ++w) s += warp_part[w * Q + j];
    partial[(size_t)blockIdx.x * Q + j] = s;
  }
  if (threadIdx.x == 0) {
    int s = 0;
    for (int w = 0; w < kGradWarps; ++w) s += seg_warp[w];
    seg_partial[blockIdx.x] = s;
  }
}

// Column j < Q of out sums partial[:, j]; block Q sums the segment counts.
// Each thread takes a fixed stride of block rows, then a fixed tree.
__global__ void __launch_bounds__(kReduceBlock)
fused_loss_reduce(const float* __restrict__ partial, const int* __restrict__ seg_partial,
                  int blocks, int Q, double* __restrict__ out,
                  long long* __restrict__ seg_out) {
  __shared__ double red[kReduceBlock];
  const int j = blockIdx.x;
  double acc = 0.0;
  for (int b = threadIdx.x; b < blocks; b += kReduceBlock) {
    acc += j < Q ? (double)partial[(size_t)b * Q + j] : (double)seg_partial[b];
  }
  red[threadIdx.x] = acc;
  __syncthreads();
  for (int s = kReduceBlock / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    if (j < Q) out[j] = red[0];
    else seg_out[0] = (long long)red[0];
  }
}

}  // namespace fspt

extern "C" {

// partial: [blocks, 1 + 6·n_mats] float scratch; seg_partial: [blocks] int
// scratch, blocks = ceil(n / 128); out: [1 + 6·n_mats] double (loss, then
// d/d diffuse-as-coefficient [M,3], then d/d bias value [M,3]); seg_out:
// [1] int64.
int fspt_fused_loss(const float* prims, const int* meta, const float* mats,
                    const int* mat_meta, fspt::PathParams pp, fspt::CamParams cp,
                    const float* tc_tab, const float* te_tab, unsigned int h0,
                    int sample0_a, int sample0_b, int lane0, int n,
                    const float* target, float* partial, int* seg_partial,
                    double* out, long long* seg_out, void* stream) {
  using namespace fspt;
  if (n <= 0) return 0;
  if (pp.n_mats > kMaxGradMats || pp.depth + pp.fast_render > kMaxSlots) {
    return (int)cudaErrorInvalidValue;
  }
  const int blocks = blocks_for(n, kGradBlock);
  const int Q = 1 + 6 * pp.n_mats;
  const size_t smem = sizeof(float) * (6 * pp.n_mats + kGradWarps * Q);
  cudaStream_t st = (cudaStream_t)stream;
  fused_loss_kernel<<<blocks, kGradBlock, smem, st>>>(
      prims, meta, mats, mat_meta, pp, cp, tc_tab, te_tab, h0, sample0_a,
      sample0_b, lane0, n, target, partial, seg_partial);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fused_loss_reduce<<<Q + 1, kReduceBlock, 0, st>>>(partial, seg_partial, blocks,
                                                    Q, out, seg_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
