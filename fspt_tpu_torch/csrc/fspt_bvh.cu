// Kernels 5 and 6 of the port: the treelet cull and the treelet sweep of the
// BVH mesh path (ops/cuda_bvh.py holds their plain versions and wrappers).
// Plain C launchers, loaded with ctypes by ops/_build.py; each returns
// cudaGetLastError().
//
//   fspt_treelet_cull   treelet_cull_kernel   replaces pallas_bvh.py
//                                              make_culled_traverser.pallas_cull
//   fspt_treelet_sweep  treelet_sweep_kernel  replaces pallas_bvh.py
//                                              make_culled_traverser.sweep
//                                              (parity and ring bodies)
//
// Rays come in blocks of kRays = 64 consecutive rows of the feature matrix
// F [n_pad, 16] = [d, o×d, o, 1, t0, 0...]; the caller has sorted them by
// Morton key, so a block's rays share origin and direction.
//
// Kernel 5, one CTA of 256 threads per ray block: the block's 64 rays
// (origin, guarded reciprocal direction, min(t0, 1), liveness) go to shared
// memory; each thread takes leaves tid, tid+256, ..., reads the leaf's box
// once and runs the exact slab test against the 64 rays, keeping the
// minimum entry t.  One float per (block, leaf) is written.  Bound by
// operations: ~30 per (ray, leaf), against 64 bytes a ray and 24 a leaf read
// and 4 bytes a (block, leaf) written.
//
// Kernel 6, one CTA of 64 threads (one per ray) per ray block: the block
// walks its front-to-back leaf list; each leaf's 128 triangles (20 floats
// each: 19 Möller–Trumbore weights and EPSILON·area) are staged in shared
// memory with 16-byte loads, and every thread tests its ray against all 128
// as warp-broadcast reads.  After each group of leaves the block's maximum t
// (warp shuffles, then shared memory) decides the early exit, the ring
// kernel's rule.  Bound by operations: ~51 per (ray, triangle) of a visited
// leaf.  The TPU kernel's DMA ring and MXU matmul are not carried over: a
// per-ray loop over shared memory is the simple form; wgmma and TMA are
// later work.
//
// Both kernels equal their plain versions bit for bit: the same terms are
// added in the same order, built with -fmad=false, and fminf/fmaxf match
// torch.fmin/fmax.

#include <cstdint>
#include <cuda_runtime.h>

namespace fspt_bvh {

constexpr int kRays = 64;          // rays per block (cuda_bvh.BLOCK_RAYS)
constexpr int kFeat = 16;          // floats per ray feature row
constexpr int kTreelet = 128;      // triangles per leaf
constexpr int kRows = 20;          // floats per triangle
constexpr int kCullThreads = 256;
constexpr float kBig = 3.0e38f;
constexpr int kNoHit = 0x7FFFFFFF;

__device__ __forceinline__ float guarded_rcp(float d) {
  const float g = fabsf(d) < 1e-30f ? (d >= 0.0f ? 1e-30f : -1e-30f) : d;
  return 1.0f / g;
}

__global__ void __launch_bounds__(kCullThreads)
treelet_cull_kernel(const float* __restrict__ F, const float* __restrict__ lbmin,
                    const float* __restrict__ lbmax, int n_leaves,
                    float* __restrict__ key) {
  __shared__ float s_o[3][kRays];
  __shared__ float s_r[3][kRays];
  __shared__ float s_t[kRays];
  __shared__ int s_live[kRays];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  if (tid < kRays) {
    const float* f = F + ((size_t)b * kRays + tid) * kFeat;
    for (int c = 0; c < 3; ++c) {
      s_o[c][tid] = f[6 + c];
      s_r[c][tid] = guarded_rcp(f[c]);
    }
    const float t0 = f[10];
    s_t[tid] = fminf(t0, 1.0f);
    s_live[tid] = t0 > 0.0f;
  }
  __syncthreads();

  for (int l = tid; l < n_leaves; l += kCullThreads) {
    const float x0 = __ldg(lbmin + 3 * l), y0 = __ldg(lbmin + 3 * l + 1),
                z0 = __ldg(lbmin + 3 * l + 2);
    const float x1 = __ldg(lbmax + 3 * l), y1 = __ldg(lbmax + 3 * l + 1),
                z1 = __ldg(lbmax + 3 * l + 2);
    float k = kBig;
    for (int r = 0; r < kRays; ++r) {
      if (!s_live[r]) continue;  // uniform across the warp
      const float tax = (x0 - s_o[0][r]) * s_r[0][r];
      const float tbx = (x1 - s_o[0][r]) * s_r[0][r];
      const float tay = (y0 - s_o[1][r]) * s_r[1][r];
      const float tby = (y1 - s_o[1][r]) * s_r[1][r];
      const float taz = (z0 - s_o[2][r]) * s_r[2][r];
      const float tbz = (z1 - s_o[2][r]) * s_r[2][r];
      const float t_lo = fmaxf(fmaxf(fminf(tax, tbx), fminf(tay, tby)), fminf(taz, tbz));
      const float t_hi = fminf(fminf(fmaxf(tax, tbx), fmaxf(tay, tby)), fmaxf(taz, tbz));
      if (t_lo <= t_hi && t_hi >= 0.0f && t_lo <= s_t[r]) k = fminf(k, fmaxf(t_lo, 0.0f));
    }
    key[(size_t)b * n_leaves + l] = k;
  }
}

__global__ void __launch_bounds__(kRays)
treelet_sweep_kernel(const int* __restrict__ counts, const int* __restrict__ order,
                     const float* __restrict__ tlo, int n_leaves, int group,
                     const float* __restrict__ F, const float* __restrict__ W,
                     float* __restrict__ t_out, int* __restrict__ best_out,
                     int* __restrict__ visits) {
  __shared__ float4 s_w[kTreelet * kRows / 4];  // one leaf: 10 KB
  __shared__ float s_max[kRays / 32];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t i = (size_t)b * kRays + tid;
  const float* f = F + i * kFeat;
  const float d0 = f[0], d1 = f[1], d2 = f[2];
  const float c0 = f[3], c1 = f[4], c2 = f[5];
  const float o0 = f[6], o1 = f[7], o2 = f[8];
  float tb = f[10];
  int best = -1;
  const int count = counts[b];
  const int* ord = order + (size_t)b * n_leaves;
  const float* tl = tlo + (size_t)b * n_leaves;
  const float* w = reinterpret_cast<const float*>(s_w);
  int swept = 0;

  for (int k = 0; k < count; k += group) {
    const int end = min(k + group, count);
    for (int s = k; s < end; ++s) {
      const int leaf = ord[s];
      const float4* src =
          reinterpret_cast<const float4*>(W + (size_t)leaf * kTreelet * kRows);
      __syncthreads();  // the previous leaf's readers are done
      for (int q = tid; q < kTreelet * kRows / 4; q += kRays) s_w[q] = __ldg(src + q);
      __syncthreads();
      int kmin = kNoHit;
#pragma unroll 2
      for (int j = 0; j < kTreelet; ++j) {
        const float* wj = w + j * kRows;
        const float det = d0 * wj[0] + d1 * wj[1] + d2 * wj[2];
        const float u_num = d0 * wj[3] + d1 * wj[4] + d2 * wj[5] + c0 * wj[6] +
                            c1 * wj[7] + c2 * wj[8];
        const float v_num = d0 * wj[9] + d1 * wj[10] + d2 * wj[11] + c0 * wj[12] +
                            c1 * wj[13] + c2 * wj[14];
        const float t_num = o0 * wj[15] + o1 * wj[16] + o2 * wj[17] + wj[18];
        const float ad = fabsf(det);
        const float sm = det < 0.0f ? -1.0f : 1.0f;
        const float un = u_num * sm, vn = v_num * sm, tn = t_num * sm;
        const float min4 = fminf(fminf(un, vn), fminf(ad - (un + vn), tn));
        if (min4 >= 0.0f && tn < tb * ad && ad >= wj[19]) {
          const float tc = tn / ad;
          kmin = min(kmin, (__float_as_int(tc) & ~(kTreelet - 1)) | j);
        }
      }
      if (kmin != kNoHit) {
        best = leaf * kTreelet + (kmin & (kTreelet - 1));
        tb = __int_as_float(kmin & ~(kTreelet - 1));
      }
      ++swept;
    }
    // Early exit: the next leaf starts beyond every ray's best hit.
    float m = tb;
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if ((tid & 31) == 0) s_max[tid >> 5] = m;
    __syncthreads();
    const float t_blk = fminf(fmaxf(s_max[0], s_max[1]), 1.0f);
    const int nk = k + group;
    if (nk < count && tl[nk] > t_blk) break;
  }
  t_out[i] = tb;
  best_out[i] = best;
  if (tid == 0) visits[b] = swept;
}

}  // namespace fspt_bvh

extern "C" {

int fspt_treelet_cull(const float* F, const float* lbmin, const float* lbmax,
                      int n_leaves, int n_blocks, float* key, void* stream) {
  using namespace fspt_bvh;
  if (n_blocks > 0 && n_leaves > 0) {
    treelet_cull_kernel<<<n_blocks, kCullThreads, 0, (cudaStream_t)stream>>>(
        F, lbmin, lbmax, n_leaves, key);
  }
  return (int)cudaGetLastError();
}

int fspt_treelet_sweep(const int* counts, const int* order, const float* tlo,
                       int n_leaves, int group, const float* F, const float* W,
                       int n_blocks, float* t, int* best, int* visits,
                       void* stream) {
  using namespace fspt_bvh;
  if (n_blocks > 0) {
    treelet_sweep_kernel<<<n_blocks, kRays, 0, (cudaStream_t)stream>>>(
        counts, order, tlo, n_leaves, group, F, W, t, best, visits);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
