// Forward-mode witnesses of the path-body adjoint: kernel 10 and kernel 8's
// whole chain as they were before the reverse-mode kernels of
// csrc/fspt_adjoint.cu replaced them.  No user path launches these; they
// are kept beside the reverse-mode kernels as a second, independent
// derivative of the same body at full width (where the autograd plain
// version does not fit in memory), and as their earlier time.  Plain C
// launchers, loaded with ctypes by ops/_build.py; each returns
// cudaGetLastError().
//
//   fspt_grad_backward_fwdmode     kernel 10, forward mode
//   fspt_fused_loss_chain_fwdmode  kernel 8 whole chain, forward mode
//
// The body is instantiated on Tangent<K> (csrc/fspt_tangent.cuh), K
// derivatives per value, and traced ceil(P/K) times per lane, pass j seeding
// parameter j*K + k into component k where the body reads its cell (or, for
// the camera, in traced_camera_ray).  Each lane dots its radiance tangents
// with its cotangent (kernel 10: the incoming radiance cotangent; kernel 8:
// (B - t) into buffer A and (A - t) into B); blocks sum their lanes in a
// fixed order into one row per block, and adjoint_reduce sums each column
// over the blocks in double.  A lane's contribution to an entry that is not
// finite is zeroed and the lane counted.  The tangent state of a lane
// (K + 1 floats per value) sits at 254-255 registers at K = 4; the cost
// grows with ceil(P/K).

#include "fspt_adjoint.cuh"

namespace fspt {

constexpr int kTangentK = 4;

// Shared memory: table and seed map [M·kMatStride] each, then the per-warp
// rows of block_row.
__host__ __device__ constexpr size_t fwdmode_smem(int n_mats) {
  return sizeof(float) * (2 * n_mats * kMatStride + kAdjWarps * kTangentK);
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

// Kernel 10, forward mode: per lane and pass, cot · d(radiance)/d(parameters
// of the pass); partial [blocks][n_cells], int_partial [blocks][2] (0, lanes
// with a zeroed non-finite contribution).
template <int K>
__global__ void __launch_bounds__(kAdjBlock)
grad_backward_fwdmode_kernel(const float* __restrict__ prims, const int* __restrict__ meta,
                             const float* __restrict__ mats,
                             const int* __restrict__ mat_meta, const PathParams pp,
                             const CamParams cp, const float* __restrict__ pvec,
                             const int* __restrict__ cells, int n_cells, uint32_t h0,
                             int sample0, int lane0, int n, const float* __restrict__ cot,
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

// Kernel 8 whole chain, forward mode: per lane the two buffers, the lane
// loss sum_c (a_c - t_c)(b_c - t_c) and, per pass, both adjoints (cotangent
// b - t into A, a - t into B); partial [blocks][1 + P] (loss, gradient),
// int_partial [blocks][2] (segments of both buffers, bad lanes).
template <int K>
__global__ void __launch_bounds__(kAdjBlock)
fused_loss_chain_fwdmode_kernel(const float* __restrict__ prims,
                                const int* __restrict__ meta,
                                const float* __restrict__ mats,
                                const int* __restrict__ mat_meta, const PathParams pp,
                                const CamParams cp, const TracedCamParams tp,
                                const float* __restrict__ pvec,
                                const int* __restrict__ cells, int n_cells, int P,
                                int use_camera, uint32_t h0, int sample0_a, int sample0_b,
                                int lane0, int n, const float* __restrict__ target,
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

}  // namespace fspt

extern "C" {

// As fspt_grad_backward (csrc/fspt_adjoint.cu) without its scratch, at
// 128 threads a block: cot [3, n]; partial [blocks, n_cells] float and int_partial [blocks, 2]
// int scratch, blocks = ceil(n / 128); out [n_cells] double; int_out [2].
int fspt_grad_backward_fwdmode(const float* prims, const int* meta, const float* mats,
                               const int* mat_meta, fspt::PathParams pp,
                               fspt::CamParams cp, const float* pvec, const int* cells,
                               int n_cells, unsigned int h0, int sample0, int lane0, int n,
                               const float* cot, float* partial, int* int_partial,
                               double* out, long long* int_out, void* stream) {
  using namespace fspt;
  if (int err = check_mats(pp)) return err;
  if (n <= 0 || n_cells <= 0) return 0;
  const int blocks = blocks_for(n, kAdjBlock);
  cudaStream_t st = (cudaStream_t)stream;
  grad_backward_fwdmode_kernel<kTangentK><<<blocks, kAdjBlock, fwdmode_smem(pp.n_mats), st>>>(
      prims, meta, mats, mat_meta, pp, cp, pvec, cells, n_cells, h0, sample0, lane0, n, cot,
      partial, int_partial);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  adjoint_reduce<<<n_cells + 2, kReduceBlock, 0, st>>>(partial, int_partial, blocks,
                                                       n_cells, 2, out, int_out);
  return (int)cudaGetLastError();
}

// As fspt_fused_loss_chain (csrc/fspt_adjoint.cu) without its scratch, at
// 128 threads a block: partial [blocks, 1 + P], blocks = ceil(n / 128);
// out [1 + P] double (loss, gradient); int_out [2] (segments, bad).
int fspt_fused_loss_chain_fwdmode(const float* prims, const int* meta, const float* mats,
                                  const int* mat_meta, fspt::PathParams pp,
                                  fspt::CamParams cp, fspt::TracedCamParams tp,
                                  const float* pvec, const int* cells, int n_cells,
                                  int use_camera, unsigned int h0, int sample0_a,
                                  int sample0_b, int lane0, int n, const float* target,
                                  float* partial, int* int_partial, double* out,
                                  long long* int_out, void* stream) {
  using namespace fspt;
  if (int err = check_mats(pp)) return err;
  const int P = n_cells + (use_camera ? 9 : 0);
  if (n <= 0 || P <= 0) return 0;
  const int blocks = blocks_for(n, kAdjBlock);
  cudaStream_t st = (cudaStream_t)stream;
  fused_loss_chain_fwdmode_kernel<kTangentK>
      <<<blocks, kAdjBlock, fwdmode_smem(pp.n_mats), st>>>(
          prims, meta, mats, mat_meta, pp, cp, tp, pvec, cells, n_cells, P, use_camera, h0,
          sample0_a, sample0_b, lane0, n, target, partial, int_partial);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  adjoint_reduce<<<1 + P + 2, kReduceBlock, 0, st>>>(partial, int_partial, blocks, 1 + P, 2,
                                                     out, int_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
