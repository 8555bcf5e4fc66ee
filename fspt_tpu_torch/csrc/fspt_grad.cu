// Kernel 8 of the port: the fused dual-buffer loss and its gradient, affine
// construction.  Replaces pallas_grad.py make_fused_loss_grad_fn (kernel
// body :589, call :792) for radiometric fields.  Plain C launchers, loaded
// with ctypes by ops/_build.py; each returns cudaGetLastError().
//
// Two threads a lane, neighbours in a warp: the even one takes buffer A
// (samples from sample0_a), the odd one buffer B (sample0_b).  Each thread:
//   1. traces its buffer in kDeferAll mode; each slot goes into a 16-byte
//      record (s, k, se, and mat and mat_e packed into one int) of a
//      per-thread array;
//   2. folds it with the table values held in shared memory (coef value
//      tc = diffuse[mat] or 0, bias value te = bias_table[mat_e] or 1),
//      L += T·te·se; T *= tc·s + k, then the depth-0 light clamp;
//   3. takes its partner's output by a shuffle; the even thread adds the
//      lane loss sum_c (a_c - t_c)(b_c - t_c);
//   4. runs the adjoint of its fold and clamp, written out, for the
//      cotangent (partner - t): the clamp's Jacobian is c·(I - L̂L̂ᵀ)/|L|
//      where it applies; then the D steps of the fold in reverse, the
//      throughput before each slot recomputed from the record in the
//      fold's own order (so its own bits; O(D²) products, D ≤ 16), adding
//      d/d tc[row] and d/d te[row] into this thread's gradient column.
// No per-lane gradient vector in local memory: thread t owns column t of
// the block's [1 + 6M][blockDim] shared array (row 0 the loss, then d/d tc,
// d/d te), as the reverse kernels do (csrc/fspt_adjoint.cu).  One block
// takes blockDim/2 lanes; it sums its columns in a fixed order into column
// blockIdx.x of a [1 + 6M][blocks] partial (block_columns), and
// adjoint_reduce sums each row of it in double, reading it coalesced.  The
// grid depends on n alone, nothing is read from the card, and there are no
// atomics: the same inputs give the same bits on every run.
//
// What bounds it on the H100: operations, the two traces (twice the
// segments of one frame); it writes (1 + 6M) floats a block.  The design
// keeps the traces at the occupancy of a one-buffer kernel: a thread holds
// one buffer's record (256 bytes of local memory, read back while it is
// fresh), the columns take 4·(1 + 6M) bytes of shared memory a thread, and
// the fold and its adjoint add a few dozen operations a slot.  The block
// is 128 threads, or 64 or 32 where the columns of 128 would not fit
// (column_block, csrc/fspt_adjoint.cuh; at most 64 rows, 128 always fits).

#include "fspt_adjoint.cuh"

namespace fspt {

constexpr int kMaxSlots = 16;  // slots a buffer's record holds: depth + fast-render terminal

// One slot in 16 bytes: s, k, se, then mat in the low and mat_e in the high
// half of one int (each signed 16-bit: both lie in [-1, 64)).
__device__ __forceinline__ float4 pack_slot(const Slot& sl) {
  return make_float4(sl.s, sl.k[0], sl.se,
                     __int_as_float((sl.mat & 0xffff) | (sl.mat_e << 16)));
}
__device__ __forceinline__ int slot_mat(const float4& r) {
  return (__float_as_int(r.w) << 16) >> 16;
}
__device__ __forceinline__ int slot_mat_e(const float4& r) {
  return __float_as_int(r.w) >> 16;
}

// Kernel 8's sink: one buffer's records.
struct SlotRecord {
  float4 rec[kMaxSlots];

  __device__ __forceinline__ void put(int d, const Slot& sl) { rec[d] = pack_slot(sl); }
  __device__ __forceinline__ float4 operator[](int d) const { return rec[d]; }
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
// in the order of ops/cuda_path.py fold_deferred_params.
__device__ __forceinline__ Folded fold_slots(const SlotRecord& r, int n_slot,
                                             const float* tc_tab, const float* te_tab,
                                             int n_mats, bool p_light, float light_clamp) {
  Folded f;
  float T[3] = {1.0f, 1.0f, 1.0f};
  f.L[0] = f.L[1] = f.L[2] = 0.0f;
  for (int d = 0; d < n_slot; ++d) {
    const float4 v = r[d];
    const int mc = slot_mat(v), me = slot_mat_e(v);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float tc = coef_value(tc_tab, mc, n_mats, c);
      const float te = bias_value(te_tab, me, n_mats, c);
      f.L[c] = f.L[c] + T[c] * (te * v.z);
      T[c] = T[c] * (tc * v.x + v.y);
    }
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

// Adjoint of fold_slots for the cotangent g of its output: adds
// d<g, out>/d tc[row][c] into row 1 + 3·row + c of this thread's column
// col (entry q at col[q * B]) and d/d te[row][c] into row 1 + 3·(n_mats +
// row) + c.
__device__ __forceinline__ void fold_adjoint(const SlotRecord& r, int n_slot,
                                             const float* tc_tab, const float* te_tab,
                                             int n_mats, const Folded& f,
                                             float light_clamp, const float g[3], float* col,
                                             int B) {
  float gL[3] = {g[0], g[1], g[2]};
  if (f.clamped) {
    // out = L·c/|L|: gL = (c/|L|)·(g - L̂ (L̂·g)).
    const float sc = light_clamp / f.norm;
    const float dot = g[0] * f.L[0] + g[1] * f.L[1] + g[2] * f.L[2];
    const float w = sc * dot / (f.norm * f.norm);
#pragma unroll
    for (int c = 0; c < 3; ++c) gL[c] = g[c] * sc - f.L[c] * w;
  }
  float* col_tc = col + B;
  float* col_te = col + (1 + 3 * n_mats) * B;
  float gT[3] = {0.0f, 0.0f, 0.0f};  // cotangent of the throughput after slot d
  for (int d = n_slot - 1; d >= 0; --d) {
    // The throughput before slot d, as the fold formed it.
    float T[3] = {1.0f, 1.0f, 1.0f};
    for (int j = 0; j < d; ++j) {
      const float4 w = r[j];
      const int wm = slot_mat(w);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        T[c] = T[c] * (coef_value(tc_tab, wm, n_mats, c) * w.x + w.y);
      }
    }
    const float4 v = r[d];
    const int mc = slot_mat(v), me = slot_mat_e(v);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float tc = coef_value(tc_tab, mc, n_mats, c);
      const float te = bias_value(te_tab, me, n_mats, c);
      if (me >= 0 && me < n_mats) col_te[(3 * me + c) * B] += gL[c] * T[c] * v.z;
      if (mc >= 0 && mc < n_mats) col_tc[(3 * mc + c) * B] += gT[c] * T[c] * v.x;
      gT[c] = gL[c] * (te * v.z) + gT[c] * (tc * v.x + v.y);
    }
  }
}

// Dynamic shared memory: the columns [1 + 6M][blockDim], then tc_tab [3M]
// and te_tab [3M].
__host__ __device__ constexpr size_t loss_smem(int n_mats, int block) {
  return sizeof(float) * ((1 + 6 * (size_t)n_mats) * block + 6 * (size_t)n_mats);
}

__global__ void __launch_bounds__(kAdjBlock)
fused_loss_kernel(const float* __restrict__ prims, const int* __restrict__ meta,
                  const float* __restrict__ mats, const int* __restrict__ mat_meta,
                  const PathParams pp, const CamParams cp,
                  const float* __restrict__ tc_g, const float* __restrict__ te_g,
                  uint32_t h0, int sample0_a, int sample0_b, int lane0, int n,
                  const float* __restrict__ target, float* __restrict__ partial,
                  int* __restrict__ int_partial) {
  extern __shared__ float smem[];
  __shared__ int warp_int[2 * kAdjWarps];
  const int B = blockDim.x;
  const int M = pp.n_mats;
  const int Q = 1 + 6 * M;
  const int n_slot = pp.depth + (pp.fast_render ? 1 : 0);
  float* acc = smem;
  float* tc_tab = acc + Q * B;
  float* te_tab = tc_tab + 3 * M;
  for (int j = threadIdx.x; j < 3 * M; j += B) {
    tc_tab[j] = tc_g[j];
    te_tab[j] = te_g[j];
  }
  float* col = acc + threadIdx.x;
  for (int q = 0; q < Q; ++q) col[q * B] = 0.0f;
  __syncthreads();

  const int i = (int)(((long long)blockIdx.x * B + threadIdx.x) >> 1);
  const bool second = threadIdx.x & 1;  // this thread takes buffer B
  const bool active = i < n;
  SlotRecord rec;
  Folded f;
  f.out[0] = f.out[1] = f.out[2] = 0.0f;
  int segs = 0;
  if (active) {
    const CameraRay r = camera_ray(cp, h0, second ? sample0_b : sample0_a, lane0 + i);
    const PathOut o = trace_path<kDeferAll>(TableRows{prims, meta}, mats, mat_meta, pp, r.hs,
                                            r.sx, r.sy, r.sz, r.dx, r.dy, r.dz, rec);
    segs = o.segcnt;
    f = fold_slots(rec, n_slot, tc_tab, te_tab, M, o.p_light, pp.light_clamp);
  }
  float other[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) other[c] = __shfl_xor_sync(0xffffffffu, f.out[c], 1);
  if (active) {
    // The target pixel of this lane (band-local lane order pixel-major).
    const float* t = target + 3 * (i / cp.spp);
    float res[3], g[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      res[c] = f.out[c] - t[c];
      g[c] = other[c] - t[c];
    }
    if (!second) col[0] += res[0] * g[0] + res[1] * g[1] + res[2] * g[2];
    fold_adjoint(rec, n_slot, tc_tab, te_tab, M, f, pp.light_clamp, g, col, B);
  }
  block_columns(acc, Q, partial);
  block_ints(segs, 0, warp_int, int_partial);
}

// A launch of kernel 8 affine: its block, grid and shared memory.  False
// where the record or a block of 32 threads' columns does not fit.
struct LossPlan {
  int block;
  int grid;
  size_t smem;
};

inline bool plan_loss(int n_mats, int n_slot, int n, LossPlan& plan) {
  if (n_mats > kMaxAdjMats || n_mats < 0 || n_slot > kMaxSlots || n_slot < 0 || n < 0) {
    return false;
  }
  plan.block = column_block(loss_smem(n_mats, 0), loss_smem(n_mats, 1) - loss_smem(n_mats, 0));
  if (plan.block == 0) return false;
  plan.grid = (int)((2 * (long long)n + plan.block - 1) / plan.block);
  plan.smem = loss_smem(n_mats, plan.block);
  return true;
}

}  // namespace fspt

extern "C" {

// The launch plan of kernel 8 affine for n_mats table rows, n_slot slots a
// buffer and n lanes: *block, the threads of a block (two a lane), and
// *grid, its blocks (the columns of the partial buffers).  Returns
// cudaErrorInvalidValue past 64 rows or 16 slots.
int fspt_fused_loss_plan(int n_mats, int n_slot, int n, int* block, int* grid) {
  fspt::LossPlan plan;
  if (!fspt::plan_loss(n_mats, n_slot, n, plan)) return (int)cudaErrorInvalidValue;
  *block = plan.block;
  *grid = plan.grid;
  return 0;
}

// partial: [1 + 6·n_mats, grid] float and int_partial [2, grid] int
// scratch (fspt_fused_loss_plan); out: [1 + 6·n_mats] double (loss, then
// d/d diffuse-as-coefficient [M,3], then d/d bias value [M,3]); int_out:
// [2] int64 (segments of both buffers, 0).
int fspt_fused_loss(const float* prims, const int* meta, const float* mats,
                    const int* mat_meta, fspt::PathParams pp, fspt::CamParams cp,
                    const float* tc_tab, const float* te_tab, unsigned int h0,
                    int sample0_a, int sample0_b, int lane0, int n,
                    const float* target, float* partial, int* int_partial,
                    double* out, long long* int_out, void* stream) {
  using namespace fspt;
  LossPlan plan;
  if (!plan_loss(pp.n_mats, pp.depth + pp.fast_render, n, plan)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n <= 0) return 0;
  const int Q = 1 + 6 * pp.n_mats;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = allow_smem(fused_loss_kernel, plan.smem);
  if (err != cudaSuccess) return (int)err;
  fused_loss_kernel<<<plan.grid, plan.block, plan.smem, st>>>(
      prims, meta, mats, mat_meta, pp, cp, tc_tab, te_tab, h0, sample0_a, sample0_b, lane0,
      n, target, partial, int_partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  adjoint_reduce<<<Q + 2, kReduceBlock, 0, st>>>(partial, int_partial, plan.grid, Q, out,
                                                 int_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
