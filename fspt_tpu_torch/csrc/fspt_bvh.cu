// Kernels 5, 6, 11 and 12 of the port: the treelet cull and the treelet sweep
// of the BVH mesh path, and the two tree walks (ops/cuda_bvh.py holds their
// plain versions and wrappers).  Plain C launchers, loaded with ctypes by
// ops/_build.py; each returns cudaGetLastError().
//
//   fspt_treelet_cull   treelet_cull_kernel   replaces pallas_bvh.py
//                                              make_culled_traverser.pallas_cull
//   fspt_treelet_sweep  treelet_sweep_kernel  replaces pallas_bvh.py
//                                              make_culled_traverser.sweep
//                                              (parity and ring bodies)
//   fspt_bvh_walk       bvh_walk_kernel       replaces pallas_bvh.py
//                                              make_bvh_traverser
//   fspt_treelet_walk   treelet_walk_kernel   replaces pallas_bvh.py
//                                              make_treelet_traverser
//
// Rays come in blocks of kRays = 64 consecutive rows of the feature matrix
// F [n_pad, 16] = [d, o×d, o, 1, t0, 0...]; the caller has sorted them by
// Morton key, so a block's rays share origin and direction.
//
// Kernel 5, one CTA per ray block, sized to the leaf count: the first warp
// lists the block's live rays (t0 > 0) in shared memory, two float4s a
// ray, (origin, min(t0, 1)) and (guarded reciprocal direction, 0), sorted
// by the octant of the direction; each thread keeps kCullLeaves = 4 leaf
// boxes in registers (leaves tid + q · blockDim) and runs the exact slab
// test of every live ray against all four, keeping each leaf's minimum
// entry t.  One float per (block, leaf) is written.  Bound by operations:
// ~30 per (live ray, leaf), against 64 bytes a ray and 24 a leaf read and
// 4 bytes a (block, leaf) written.  With -fmad=false every operation is an
// instruction, and the fminf / fmaxf and compares set the pace (dropping
// six of them a test cut the time by 29 %, PERF.md §6); what the design
// does about it:
//   - the octant: a loop a direction octant (templated on it; a block's
//     rays, sorted by Morton key over origin and direction, mostly share
//     one) takes each axis's near and far plane by the sign of the
//     direction, dropping the six fminf / fmaxf of the pairs;
//   - one test: max(t_lo, 0) <= min(t_hi, min(t0, 1)) in place of three
//     compares (the same set for a live ray);
//   - loads: a ray's two broadcast LDS.128 serve four tests, and the list
//     holds live rays only (a block with none writes BIG and tests
//     nothing);
//   - the tail: ceil(L / 4) threads rounded up to a warp, at most 256
//     (224 at the mesh bench scene's 778 leaves: one pass); more leaves
//     take more passes of the same CTA.
// Every key equals plain_cull's bit for bit: the same values, rounded alike.

// Kernel 6, one CTA of 256 threads per ray block: each thread holds two of
// the block's 64 rays, and eight threads share a pair.  The block walks its
// front-to-back leaf list; each leaf's 128 triangles (20 floats each: 19
// Möller–Trumbore weights and EPSILON·area) are staged in shared memory,
// and each thread tests every eighth triangle (columns j ≡ slice mod 8:
// the eight slices of a quarter-warp read eight float4 rows that fall in
// distinct banks) against both of its rays.  A ray's eight packed keys
// (bits(t) & ~127) | column are joined by an integer min over
// __shfl_xor_sync, which does not depend on the split, so t, best and
// visits equal the plain version's.  After each group of leaves the
// block's maximum t (warp shuffles, then shared memory over 8 warps)
// decides the early exit, the ring kernel's rule.
//
// Bound by operations: ~51 per (ray, triangle) of a visited leaf.  With
// -fmad=false each is one instruction, plus the loads and the loop, so the
// issue rate of 132 SMs × 128 lanes puts the floor near 2.5× the bound (the
// bound counts an FMA as two operations).  What the design does about the
// rest:
//   - the tail: a block's leaf list is walked in order (the strict < on
//     quantized t lets the first-visited leaf win a tie, so one block's
//     list cannot be split across CTAs); eight threads a ray cut the
//     heaviest block's walk eightfold, and the wrapper hands the kernel its
//     blocks sorted by survivor count, heaviest first, so the long walks
//     start in the first wave instead of ending the kernel;
//   - shared-memory reads: with one ray a thread a test needs five LDS.128
//     of its triangle's row, and a warp's LDS.128 is served a quarter-warp
//     at a time, so those reads and not the arithmetic set the pace (the
//     FMA-contracted build of that form was only 4 % faster on an H100);
//     two rays a thread halve the reads a test;
//   - the staging: two 10 KB leaf buffers; leaf s+1 is copied with 16-byte
//     cp.async (L2 only) while leaf s is tested, one barrier a leaf.  The
//     copy runs ahead of the early-exit test (never past counts[b]): a leaf
//     copied and then not tested does not count as a visit;
//   - occupancy: 8 warps a CTA, launch bounds for three CTAs (24 warps)
//     an SM.
// The TPU kernel's MXU product of [64 × 16] rays by [16 × 512] weights is
// not carried over: an FMA-contracted or TF32 product would change which
// triangle wins a near tie against the plain version.
//
// Kernels 11 and 12, one thread per ray (CTAs of 128), walk a miss-link BVH
// without a stack, in the order of ops/bvh.traverse_bvh: node + 1 on a
// descend, miss[node] after a leaf or a missed box; a node is pruned when its
// slab entry t exceeds the ray's best t.  The TPU kernels walked a block of
// rays in lockstep behind an interval frustum and read node records with
// one-hot lane reductions, because Mosaic has no per-lane gather; Hopper
// gathers, so each ray walks its own path.  Every ray visits the same nodes
// in the same order as the plain walk, with the same prune, so t, the
// winner, and the nodes and triangles each ray tested (kernel 12: the real
// triangles of the leaves it swept, not their pad columns) equal the plain
// version's, and the bound is counted from them.  Bound by operations: ~30
// per node test, ~58 per cross-form triangle test, ~51 per weight-form one;
// by bytes where the rays are many and their walks short.  The one-thread
// form lost most of its warp-cycles to divergence: lanes waiting while
// others tested a leaf (kernel 11: 62-70 % of the cycles in leaf tests at
// 8-10 % lane activity; kernel 12: 96-99 %, one lane sweeping a 128-column
// leaf alone, every row read from L2 once a ray; PERF.md §6).  What
// the design does about it:
//   - packed records (ops/cuda_bvh.walk_nodes / walk_tris, built once a
//     tree): a node is two float4, (bmin, bits(miss)) and (bmax,
//     bits(payload << 8 | count)), read with two 16-byte loads; kernel 11's
//     triangle is three, (v0, area2), (e1, bits(tri_id)), (e2, 0);
//   - leaves postponed (Aila and Laine, "Understanding the efficiency of
//     ray traversal on GPUs", HPG 2009): node steps (node_step) and leaf
//     tests alternate as warp-wide phases.  A lane that takes a leaf stops
//     walking until the warp has tested it, so its best t prunes its next
//     node exactly as in the plain walk;
//   - kernel 11 leaves its node steps once at most 32 - kWalkFree lanes
//     are still walking (measured against 32, the while-while form, and
//     other counts), then tests each taken leaf's few triangles lane by
//     lane with the cross-product Möller–Trumbore of traverse_bvh, term
//     for term.  Its warps are persistent: a grid of resident CTAs, each
//     warp taking its next 32 rays from an atomic counter until none is
//     left (bvh_walk_grid; the launcher zeroes the counter);
//   - kernel 12's lanes walk until each holds a leaf or is done, then the
//     warp tests its taken leaves cooperatively (warp_leaf): the lanes at
//     one leaf form a group (__match_any_sync on the record); lane l holds
//     the weight rows of columns l, l + 32, l + 64, l + 96 below the leaf's
//     count in registers (five coalesced 16-byte loads each, once a group:
//     the pad columns never hit) and tests them against the group's rays
//     two at a time, their features and best t by __shfl_sync; the packed
//     keys (bits(t) & ~127) | column, from tri_key (kernel 6's per-column
//     function), are joined by __reduce_min_sync, the same key as a serial
//     min since the column breaks ties.  A leaf is read once a warp-visit,
//     not once a ray; ops/cuda_bvh.post recovers exact t, u, v.  The rows
//     re-read from L1 for each ray, or staged in shared memory, were
//     slower.
// All four kernels equal their plain versions bit for bit: the same terms
// are added in the same order, built with -fmad=false, and fminf/fmaxf
// match torch.fmin/fmax (and torch.minimum/maximum on finite values).

#include <cstdint>
#include <cuda_runtime.h>

namespace fspt_bvh {

constexpr int kRays = 64;          // rays per block (cuda_bvh.BLOCK_RAYS)
constexpr int kFeat = 16;          // floats per ray feature row
constexpr int kTreelet = 128;      // triangles per leaf
constexpr int kRows = 20;          // floats per triangle
// Kernel 5: leaf boxes a thread holds in registers, and the most threads a
// CTA (cull_threads sizes it to the leaf count).
constexpr int kCullLeaves = 4;
constexpr int kCullMaxThreads = 256;
// Kernel 6: each thread holds kSweepRays rays and tests every
// kSweepSlices-th triangle of a leaf against them; kSweepSlices threads
// share a ray.
constexpr int kSweepRays = 2;
constexpr int kSweepSlices = 8;
constexpr int kSweepThreads = kRays / kSweepRays * kSweepSlices;  // 256
constexpr int kSweepWarps = kSweepThreads / 32;
constexpr int kLeafVec = kTreelet * kRows / 4;       // float4s in a leaf: 640
constexpr int kWalkThreads = 128;
// Kernels 11-12: the low bits of a packed node's last word hold a leaf's
// triangle count (0: internal node), the high bits its first triangle
// (kernel 11) or leaf ordinal (kernel 12); cuda_bvh.COUNT_BITS.
constexpr int kCountBits = 8;
constexpr unsigned kCountMask = (1u << kCountBits) - 1u;
constexpr unsigned kFullMask = 0xffffffffu;
// Kernel 11: a warp leaves its node steps for its leaf tests once at most
// 32 - kWalkFree lanes are still walking (the others hold a leaf or are done).
constexpr int kWalkFree = 24;
constexpr float kBig = 3.0e38f;
constexpr int kNoHit = 0x7FFFFFFF;

// Kernel 5's threads a CTA: one pass over the leaves at kCullLeaves a
// thread (ceil(n_leaves / kCullLeaves), rounded up to a warp), at most
// kCullMaxThreads.
inline int cull_threads(int n_leaves) {
  const int t = ((n_leaves + kCullLeaves - 1) / kCullLeaves + 31) / 32 * 32;
  return t < 32 ? 32 : (t > kCullMaxThreads ? kCullMaxThreads : t);
}

__device__ __forceinline__ float guarded_rcp(float d) {
  const float g = fabsf(d) < 1e-30f ? (d >= 0.0f ? 1e-30f : -1e-30f) : d;
  return 1.0f / g;
}

// One ray's features for the weight form: d, c = o×d and o.
struct RayF {
  float d0, d1, d2, c0, c1, c2, o0, o1, o2;
};

__device__ __forceinline__ RayF load_ray(const float* f) {
  return RayF{f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], f[8]};
}

// One ray against triangle column j of a leaf (wj: its 20 floats), the
// sign-folded Möller–Trumbore of cuda_bvh._leaf_test term for term: the
// packed key (bits(t) & ~127) | j when the triangle is hit closer than tb,
// else kNoHit.
__device__ __forceinline__ int tri_key(const float* __restrict__ wj, const RayF& r, float tb,
                                       int j) {
  const float det = r.d0 * wj[0] + r.d1 * wj[1] + r.d2 * wj[2];
  const float u_num = r.d0 * wj[3] + r.d1 * wj[4] + r.d2 * wj[5] + r.c0 * wj[6] +
                      r.c1 * wj[7] + r.c2 * wj[8];
  const float v_num = r.d0 * wj[9] + r.d1 * wj[10] + r.d2 * wj[11] + r.c0 * wj[12] +
                      r.c1 * wj[13] + r.c2 * wj[14];
  const float t_num = r.o0 * wj[15] + r.o1 * wj[16] + r.o2 * wj[17] + wj[18];
  const float ad = fabsf(det);
  const float sm = det < 0.0f ? -1.0f : 1.0f;
  const float un = u_num * sm, vn = v_num * sm, tn = t_num * sm;
  const float min4 = fminf(fminf(un, vn), fminf(ad - (un + vn), tn));
  if (min4 >= 0.0f && tn < tb * ad && ad >= wj[19]) {
    const float tc = tn / ad;
    return (__float_as_int(tc) & ~(kTreelet - 1)) | j;
  }
  return kNoHit;
}

// Kernel 6's staging: the 640 float4s of leaf `leaf` into dst, 16-byte
// cp.async copies through L2, one commit group per leaf.
__device__ __forceinline__ void stage_leaf(float4* dst, const float* __restrict__ W, int leaf,
                                           int tid) {
  const float4* src = reinterpret_cast<const float4*>(W + (size_t)leaf * kTreelet * kRows);
  for (int q = tid; q < kLeafVec; q += kSweepThreads) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst + q));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src + q)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void staged_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Slab test of the ray (origin o, guarded reciprocal direction r) against
// a packed node's box [lo.xyz, hi.xyz] (ops/bvh._slab_entry): hit, and the
// entry t clamped at 0.
__device__ __forceinline__ bool slab_entry(const float4& lo, const float4& hi, float o0,
                                           float o1, float o2, float r0, float r1, float r2,
                                           float& entry) {
  const float t0x = (lo.x - o0) * r0, t1x = (hi.x - o0) * r0;
  const float t0y = (lo.y - o1) * r1, t1y = (hi.y - o1) * r1;
  const float t0z = (lo.z - o2) * r2, t1z = (hi.z - o2) * r2;
  const float tnear = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
  const float tfar = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
  entry = fmaxf(tnear, 0.0f);
  return tnear <= tfar && tfar >= 0.0f && tnear <= 1.0f;
}

// One node step of a walking lane (node < n_nodes, no leaf held): test the
// node's box, count it, take the node's leaf (its packed word payload <<
// kCountBits | count, with its triangles counted) where the ray enters the
// box no later than tb, and move on: node + 1 into an entered internal
// node, else the miss link, where the walk goes on once a taken leaf is
// tested.
__device__ __forceinline__ void node_step(const float4* __restrict__ nodes, float o0, float o1,
                                          float o2, float r0, float r1, float r2, float tb,
                                          int& node, unsigned& leaf, int& n_visit,
                                          int& n_test) {
  const float4 lo = __ldg(nodes + 2 * node), hi = __ldg(nodes + 2 * node + 1);
  ++n_visit;
  float entry;
  const bool box = slab_entry(lo, hi, o0, o1, o2, r0, r1, r2, entry) && entry <= tb;
  const unsigned meta = __float_as_uint(hi.w);
  const unsigned cnt = meta & kCountMask;
  if (box && cnt > 0) {
    leaf = meta;
    n_test += (int)cnt;
  }
  node = (box && cnt == 0) ? node + 1 : __float_as_int(lo.w);
}

// Lane r's ray, to every lane of the warp.
__device__ __forceinline__ RayF shfl_ray(const RayF& ray, int r) {
  return RayF{__shfl_sync(kFullMask, ray.d0, r), __shfl_sync(kFullMask, ray.d1, r),
              __shfl_sync(kFullMask, ray.d2, r), __shfl_sync(kFullMask, ray.c0, r),
              __shfl_sync(kFullMask, ray.c1, r), __shfl_sync(kFullMask, ray.c2, r),
              __shfl_sync(kFullMask, ray.o0, r), __shfl_sync(kFullMask, ray.o1, r),
              __shfl_sync(kFullMask, ray.o2, r)};
}

// Kernel 12's leaf test: the rays of the lanes in `grp`, all pending at the
// leaf `meta` (ordinal << kCountBits | count), each against the leaf's
// triangles with its own tb.  Lane l holds columns l + 32 q below the count
// and tests them against the rays two at a time (two independent chains);
// the warp's integer min of a ray's packed keys is its key at this leaf,
// taken by the ray's own lane.
__device__ __forceinline__ void warp_leaf(const float* __restrict__ W, unsigned meta,
                                          unsigned grp, int lane, const RayF& ray, float& tb,
                                          int& best) {
  constexpr int kQ = kTreelet / 32;
  const int leaf = (int)(meta >> kCountBits), cnt = (int)(meta & kCountMask);
  const float4* w = reinterpret_cast<const float4*>(W + (size_t)leaf * kTreelet * kRows);
  float wq[kQ][kRows];
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    if (lane + 32 * q < cnt) {
      const float4* p = w + (lane + 32 * q) * (kRows / 4);
#pragma unroll
      for (int c = 0; c < kRows / 4; ++c) {
        const float4 v = __ldg(p + c);
        wq[q][4 * c] = v.x;
        wq[q][4 * c + 1] = v.y;
        wq[q][4 * c + 2] = v.z;
        wq[q][4 * c + 3] = v.w;
      }
    }
  }
  const auto take = [&](int k, int r) {
    if (lane == r && k != kNoHit) {
      best = leaf * kTreelet + (k & (kTreelet - 1));
      tb = __int_as_float(k & ~(kTreelet - 1));
    }
  };
  for (unsigned g = grp; g != 0;) {
    const int ra = __ffs(g) - 1;
    g &= g - 1;
    const int rb = __ffs(g) - 1;  // -1: ra is the group's last ray
    g &= g - 1;
    const RayF a = shfl_ray(ray, ra);
    const float ta = __shfl_sync(kFullMask, tb, ra);
    int ka = kNoHit;
    if (rb >= 0) {
      const RayF b = shfl_ray(ray, rb);
      const float tbb = __shfl_sync(kFullMask, tb, rb);
      int kb = kNoHit;
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        if (lane + 32 * q < cnt) {
          ka = min(ka, tri_key(wq[q], a, ta, lane + 32 * q));
          kb = min(kb, tri_key(wq[q], b, tbb, lane + 32 * q));
        }
      }
      take(__reduce_min_sync(kFullMask, kb), rb);
    } else {
#pragma unroll
      for (int q = 0; q < kQ; ++q)
        if (lane + 32 * q < cnt) ka = min(ka, tri_key(wq[q], a, ta, lane + 32 * q));
    }
    take(__reduce_min_sync(kFullMask, ka), ra);
  }
}

// The live rays j0 .. j1-1 of the block's list, all of direction octant
// Oct (bit a set: component a negative), against the thread's kCullLeaves
// leaf boxes: the slab test of plain_cull with its choices made by the
// octant.  Where a component is positive, (lo - o)·r is the near t and
// (hi - o)·r the far one (rounding is monotone: fminf / fmaxf of the pair
// pick the same values), and where negative the other way round; the
// three overlap tests fold into max(t_lo, 0) <= min(t_hi, min(t0, 1)),
// the same set for a live ray (min(t0, 1) > 0).  Each leaf keeps its
// minimum entry t.
template <int Oct>
__device__ __forceinline__ void cull_octant(const float4* s_ray, int j0, int j1,
                                            const float (&lo)[3][kCullLeaves],
                                            const float (&hi)[3][kCullLeaves],
                                            float (&k)[kCullLeaves]) {
  for (int j = j0; j < j1; ++j) {
    const float4 o = s_ray[2 * j], r = s_ray[2 * j + 1];
#pragma unroll
    for (int q = 0; q < kCullLeaves; ++q) {
      const float nx = ((Oct & 1) ? hi[0][q] : lo[0][q]) - o.x;
      const float fx = ((Oct & 1) ? lo[0][q] : hi[0][q]) - o.x;
      const float ny = ((Oct & 2) ? hi[1][q] : lo[1][q]) - o.y;
      const float fy = ((Oct & 2) ? lo[1][q] : hi[1][q]) - o.y;
      const float nz = ((Oct & 4) ? hi[2][q] : lo[2][q]) - o.z;
      const float fz = ((Oct & 4) ? lo[2][q] : hi[2][q]) - o.z;
      const float t_lo = fmaxf(fmaxf(nx * r.x, ny * r.y), nz * r.z);
      const float t_hi = fminf(fminf(fminf(fx * r.x, fy * r.y), fz * r.z), o.w);
      const float entry = fmaxf(t_lo, 0.0f);
      if (entry <= t_hi) k[q] = fminf(k[q], entry);
    }
  }
}

__global__ void __launch_bounds__(kCullMaxThreads)
treelet_cull_kernel(const float* __restrict__ F, const float* __restrict__ lbmin,
                    const float* __restrict__ lbmax, int n_leaves,
                    float* __restrict__ key) {
  __shared__ float4 s_ray[2 * kRays];  // the live rays: (o, min(t0, 1)), (r, 0)
  __shared__ int s_oct[9];             // where each octant's rays start; [8]: count
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  if (tid < 32) {
    // The first warp lists the live rays (t0 > 0), two rows a thread,
    // sorted by the octant of their direction (8: dead).
    float4 ray[kRays / 32][2];
    int oct[kRays / 32];
#pragma unroll
    for (int h = 0; h < kRays / 32; ++h) {
      const float4* f = reinterpret_cast<const float4*>(
          F + ((size_t)b * kRays + h * 32 + tid) * kFeat);
      const float4 f0 = __ldg(f), f1 = __ldg(f + 1), f2 = __ldg(f + 2);
      // f0 = (d, c0), f1 = (c1, c2, o0, o1), f2 = (o2, 1, t0, 0).
      ray[h][0] = make_float4(f1.z, f1.w, f2.x, fminf(f2.z, 1.0f));
      ray[h][1] = make_float4(guarded_rcp(f0.x), guarded_rcp(f0.y), guarded_rcp(f0.z), 0.0f);
      oct[h] = !(f2.z > 0.0f) ? 8
               : (ray[h][1].x < 0.0f ? 1 : 0) | (ray[h][1].y < 0.0f ? 2 : 0)
                     | (ray[h][1].z < 0.0f ? 4 : 0);
    }
    const unsigned below = (1u << tid) - 1u;
    int at = 0;
    for (int oc = 0; oc < 8; ++oc) {
      if (tid == 0) s_oct[oc] = at;
#pragma unroll
      for (int h = 0; h < kRays / 32; ++h) {
        const unsigned m = __ballot_sync(0xffffffffu, oct[h] == oc);
        if (oct[h] == oc) {
          const int j = at + __popc(m & below);
          s_ray[2 * j] = ray[h][0];
          s_ray[2 * j + 1] = ray[h][1];
        }
        at += __popc(m);
      }
    }
    if (tid == 0) s_oct[8] = at;
  }
  __syncthreads();
  const int live = s_oct[8];
  float* row = key + (size_t)b * n_leaves;
  const int stride = blockDim.x;
  if (live == 0) {
    for (int l = tid; l < n_leaves; l += stride) row[l] = kBig;
    return;
  }
  // Passes of blockDim.x * kCullLeaves leaves (one where n_leaves fits);
  // thread tid holds leaves l0 + tid + q * blockDim.x.
  for (int l0 = 0; l0 < n_leaves; l0 += stride * kCullLeaves) {
    float lo[3][kCullLeaves], hi[3][kCullLeaves], k[kCullLeaves];
#pragma unroll
    for (int q = 0; q < kCullLeaves; ++q) {
      const int l = min(l0 + tid + q * stride, n_leaves - 1);
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        lo[a][q] = __ldg(lbmin + 3 * l + a);
        hi[a][q] = __ldg(lbmax + 3 * l + a);
      }
      k[q] = kBig;
    }
    for (int oc = 0; oc < 8; ++oc) {
      const int j0 = s_oct[oc], j1 = s_oct[oc + 1];
      switch (j0 < j1 ? oc : -1) {
        case 0: cull_octant<0>(s_ray, j0, j1, lo, hi, k); break;
        case 1: cull_octant<1>(s_ray, j0, j1, lo, hi, k); break;
        case 2: cull_octant<2>(s_ray, j0, j1, lo, hi, k); break;
        case 3: cull_octant<3>(s_ray, j0, j1, lo, hi, k); break;
        case 4: cull_octant<4>(s_ray, j0, j1, lo, hi, k); break;
        case 5: cull_octant<5>(s_ray, j0, j1, lo, hi, k); break;
        case 6: cull_octant<6>(s_ray, j0, j1, lo, hi, k); break;
        case 7: cull_octant<7>(s_ray, j0, j1, lo, hi, k); break;
        default: break;
      }
    }
#pragma unroll
    for (int q = 0; q < kCullLeaves; ++q) {
      const int l = l0 + tid + q * stride;
      if (l < n_leaves) row[l] = k[q];
    }
  }
}

__global__ void __launch_bounds__(kSweepThreads, 3)
treelet_sweep_kernel(const int64_t* __restrict__ heavy_first, const int* __restrict__ counts,
                     const int* __restrict__ order, const float* __restrict__ tlo,
                     int n_leaves, int group, const float* __restrict__ F,
                     const float* __restrict__ W, float* __restrict__ t_out,
                     int* __restrict__ best_out, int* __restrict__ visits) {
  constexpr int kStride = kRays / kSweepRays;  // a thread's rays: tid / kSweepSlices + k·kStride
  __shared__ float4 s_w[2][kLeafVec];          // two leaves: 20 KB
  __shared__ float s_max[2][kSweepWarps];      // by group parity
  const int b = (int)heavy_first[blockIdx.x];
  const int tid = threadIdx.x;
  const int slice = tid % kSweepSlices;
  const size_t i0 = (size_t)b * kRays + tid / kSweepSlices;
  RayF ray[kSweepRays];
  float tb[kSweepRays];
  int best[kSweepRays];
#pragma unroll
  for (int k = 0; k < kSweepRays; ++k) {
    const float* f = F + (i0 + k * kStride) * kFeat;
    ray[k] = load_ray(f);
    tb[k] = f[10];
    best[k] = -1;
  }
  const int count = counts[b];
  const int* ord = order + (size_t)b * n_leaves;
  const float* tl = tlo + (size_t)b * n_leaves;

  if (count > 0) stage_leaf(s_w[0], W, ord[0], tid);
  int s = 0;
  for (; s < count; ++s) {
    staged_wait();
    // Leaf s is in s_w[s & 1] for every thread, and every thread is done
    // with leaf s - 1, whose buffer takes leaf s + 1 next.
    __syncthreads();
    if (s > 0 && s % group == 0) {
      // Early exit: the next leaf starts beyond every ray's best hit.
      const float* warp_max = s_max[(s / group) & 1];
      float t_blk = warp_max[0];
#pragma unroll
      for (int w = 1; w < kSweepWarps; ++w) t_blk = fmaxf(t_blk, warp_max[w]);
      if (tl[s] > fminf(t_blk, 1.0f)) break;
    }
    if (s + 1 < count) stage_leaf(s_w[(s + 1) & 1], W, ord[s + 1], tid);
    const float4* w = s_w[s & 1];
    int kmin[kSweepRays];
#pragma unroll
    for (int k = 0; k < kSweepRays; ++k) kmin[k] = kNoHit;
#pragma unroll 2
    for (int m = 0; m < kTreelet / kSweepSlices; ++m) {
      const int j = m * kSweepSlices + slice;
      const float4* q = w + j * (kRows / 4);
      const float4 a = q[0], c = q[1], d = q[2], e = q[3], g = q[4];
      const float wj[kRows] = {a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w, d.x, d.y,
                               d.z, d.w, e.x, e.y, e.z, e.w, g.x, g.y, g.z, g.w};
#pragma unroll
      for (int k = 0; k < kSweepRays; ++k)
        kmin[k] = min(kmin[k], tri_key(wj, ray[k], tb[k], j));
    }
    const int leaf = ord[s];
#pragma unroll
    for (int k = 0; k < kSweepRays; ++k) {
#pragma unroll
      for (int off = 1; off < kSweepSlices; off <<= 1)
        kmin[k] = min(kmin[k], __shfl_xor_sync(0xffffffffu, kmin[k], off));
      if (kmin[k] != kNoHit) {
        best[k] = leaf * kTreelet + (kmin[k] & (kTreelet - 1));
        tb[k] = __int_as_float(kmin[k] & ~(kTreelet - 1));
      }
    }
    if ((s + 1) % group == 0) {
      float m = tb[0];
#pragma unroll
      for (int k = 1; k < kSweepRays; ++k) m = fmaxf(m, tb[k]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      if ((tid & 31) == 0) s_max[((s + 1) / group) & 1][tid >> 5] = m;
    }
  }
  if (slice == 0) {
#pragma unroll
    for (int k = 0; k < kSweepRays; ++k) {
      t_out[i0 + k * kStride] = tb[k];
      best_out[i0 + k * kStride] = best[k];
    }
  }
  if (tid == 0) visits[b] = s;
}

__global__ void __launch_bounds__(kWalkThreads)
bvh_walk_kernel(const float* __restrict__ start, const float* __restrict__ seg,
                const float* __restrict__ t_init, int n, const float4* __restrict__ nodes,
                int n_nodes, const float4* __restrict__ tris, float* __restrict__ t_out,
                int* __restrict__ id_out, float* __restrict__ u_out, float* __restrict__ v_out,
                int* __restrict__ visits, int* __restrict__ tested, int* __restrict__ next) {
  const int lane = threadIdx.x & 31;
  for (;;) {
    // The warp's next 32 rays.
    int base = 0;
    if (lane == 0) base = atomicAdd(next, 32);
    base = __shfl_sync(kFullMask, base, 0);
    if (base >= n) return;
    const int i = base + lane;
    const bool has_ray = i < n;  // lanes past n walk nothing but take part in the votes
    float sx = 0.0f, sy = 0.0f, sz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f, tb = 0.0f;
    if (has_ray) {
      sx = start[3 * i], sy = start[3 * i + 1], sz = start[3 * i + 2];
      dx = seg[3 * i], dy = seg[3 * i + 1], dz = seg[3 * i + 2];
      tb = t_init[i];
    }
    const float rx = guarded_rcp(dx), ry = guarded_rcp(dy), rz = guarded_rcp(dz);
    int best = -1, n_visit = 0, n_test = 0;
    float bu = 0.0f, bv = 0.0f;
    int node = tb > 0.0f ? 0 : n_nodes;  // a dead lane walks nothing
    unsigned leaf = 0;
    while (__any_sync(kFullMask, node < n_nodes)) {
      // Node steps until at most 32 - kWalkFree lanes are still walking.
      for (;;) {
        if (node < n_nodes && leaf == 0)
          node_step(nodes, sx, sy, sz, rx, ry, rz, tb, node, leaf, n_visit, n_test);
        if (__popc(__ballot_sync(kFullMask, node < n_nodes && leaf == 0)) <= 32 - kWalkFree)
          break;
      }
      const int f = (int)(leaf >> kCountBits), cnt = (int)(leaf & kCountMask);
      for (int k = 0; k < cnt; ++k) {
        const float4* q = tris + 3 * (f + k);
        const float4 a = __ldg(q), e1 = __ldg(q + 1), e2 = __ldg(q + 2);
        const float pvx = dy * e2.z - dz * e2.y;
        const float pvy = dz * e2.x - dx * e2.z;
        const float pvz = dx * e2.y - dy * e2.x;
        const float det = e1.x * pvx + e1.y * pvy + e1.z * pvz;
        const bool np = fabsf(det) >= 1e-5f * a.w;
        const float inv = 1.0f / (np ? det : 1.0f);
        const float tx = sx - a.x, ty = sy - a.y, tz = sz - a.z;
        const float u = (tx * pvx + ty * pvy + tz * pvz) * inv;
        const float qvx = ty * e1.z - tz * e1.y;
        const float qvy = tz * e1.x - tx * e1.z;
        const float qvz = tx * e1.y - ty * e1.x;
        const float v = (dx * qvx + dy * qvy + dz * qvz) * inv;
        const float tt = (e2.x * qvx + e2.y * qvy + e2.z * qvz) * inv;
        if (np && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && tt >= 0.0f && tt <= 1.0f &&
            tt < tb) {
          tb = tt;
          best = __float_as_int(e1.w);
          bu = u;
          bv = v;
        }
      }
      leaf = 0;
    }
    if (has_ray) {
      t_out[i] = tb;
      id_out[i] = best;
      u_out[i] = bu;
      v_out[i] = bv;
      visits[i] = n_visit;
      tested[i] = n_test;
    }
  }
}

__global__ void __launch_bounds__(kWalkThreads)
treelet_walk_kernel(const float* __restrict__ F, int n_pad, const float4* __restrict__ nodes,
                    int n_nodes, const float* __restrict__ W, float* __restrict__ t_out,
                    int* __restrict__ best_out, int* __restrict__ visits,
                    int* __restrict__ tested) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWalkThreads + threadIdx.x;
  const bool has_ray = i < n_pad;  // lanes past n_pad take part in the warp's votes
  float4 f0 = make_float4(0.0f, 0.0f, 0.0f, 0.0f), f1 = f0, f2 = f0;
  if (has_ray) {
    const float4* f = reinterpret_cast<const float4*>(F + (size_t)i * kFeat);
    f0 = __ldg(f), f1 = __ldg(f + 1), f2 = __ldg(f + 2);
  }
  // f0 = (d, c0), f1 = (c1, c2, o0, o1), f2 = (o2, 1, t0, 0).
  const RayF ray{f0.x, f0.y, f0.z, f0.w, f1.x, f1.y, f1.z, f1.w, f2.x};
  const float rx = guarded_rcp(ray.d0), ry = guarded_rcp(ray.d1), rz = guarded_rcp(ray.d2);
  float tb = f2.z;
  int best = -1, n_visit = 0, n_test = 0;
  int node = tb > 0.0f ? 0 : n_nodes;  // dead and pad rows walk nothing
  unsigned leaf = 0;
  for (;;) {
    // Each lane walks until it holds a leaf or is done.
    while (node < n_nodes && leaf == 0)
      node_step(nodes, ray.o0, ray.o1, ray.o2, rx, ry, rz, tb, node, leaf, n_visit, n_test);
    unsigned pend = __ballot_sync(kFullMask, leaf != 0);
    if (pend == 0) break;
    const unsigned same = __match_any_sync(kFullMask, leaf);
    do {
      const int lead = __ffs(pend) - 1;
      const unsigned grp = __shfl_sync(kFullMask, same, lead);
      warp_leaf(W, __shfl_sync(kFullMask, leaf, lead), grp, lane, ray, tb, best);
      pend &= ~grp;
    } while (pend != 0);
    leaf = 0;
  }
  if (has_ray) {
    t_out[i] = tb;
    best_out[i] = best;
    visits[i] = n_visit;
    tested[i] = n_test;
  }
}

}  // namespace fspt_bvh

extern "C" {

int fspt_treelet_cull(const float* F, const float* lbmin, const float* lbmax,
                      int n_leaves, int n_blocks, float* key, void* stream) {
  using namespace fspt_bvh;
  if (n_blocks > 0 && n_leaves > 0) {
    treelet_cull_kernel<<<n_blocks, cull_threads(n_leaves), 0, (cudaStream_t)stream>>>(
        F, lbmin, lbmax, n_leaves, key);
  }
  return (int)cudaGetLastError();
}

int fspt_treelet_sweep(const int64_t* heavy_first, const int* counts, const int* order,
                       const float* tlo, int n_leaves, int group, const float* F,
                       const float* W, int n_blocks, float* t, int* best, int* visits,
                       void* stream) {
  using namespace fspt_bvh;
  if (n_blocks > 0) {
    treelet_sweep_kernel<<<n_blocks, kSweepThreads, 0, (cudaStream_t)stream>>>(
        heavy_first, counts, order, tlo, n_leaves, group, F, W, t, best, visits);
  }
  return (int)cudaGetLastError();
}

// Kernel 5's CTA as launched for n_leaves leaves: threads, leaves a thread
// in one pass.
int fspt_cull_shape(int n_leaves, int* shape) {
  using namespace fspt_bvh;
  shape[0] = cull_threads(n_leaves);
  shape[1] = kCullLeaves;
  return 0;
}

// Kernel 6's CTA as launched: threads, rays a thread, threads a ray.
int fspt_sweep_shape(int* shape) {
  using namespace fspt_bvh;
  shape[0] = kSweepThreads;
  shape[1] = kSweepRays;
  shape[2] = kSweepSlices;
  return 0;
}

// Kernel 11's grid: the CTAs resident on the card at once (occupancy times
// the SMs, computed once a device), or fewer where the rays fill fewer; -1
// where CUDA fails.
static int bvh_walk_resident[64];

static int bvh_walk_grid(int n) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return -1;
  int& resident = bvh_walk_resident[dev];
  if (resident == 0) {
    int per_sm = 0, sms = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fspt_bvh::bvh_walk_kernel,
                                                      fspt_bvh::kWalkThreads, 0) != cudaSuccess
        || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess
        || per_sm * sms <= 0)
      return -1;
    resident = per_sm * sms;
  }
  const int wanted = (n + fspt_bvh::kWalkThreads - 1) / fspt_bvh::kWalkThreads;
  return wanted < resident ? wanted : resident;
}

// next: one int of scratch, the warps' batch counter (zeroed here).
int fspt_bvh_walk(const float* start, const float* seg, const float* t_init, int n,
                  const float* nodes, int n_nodes, const float* tris, float* t, int* id,
                  float* u, float* v, int* visits, int* tested, int* next, void* stream) {
  using namespace fspt_bvh;
  if (n > 0) {
    const int grid = bvh_walk_grid(n);
    if (grid < 0) return (int)cudaErrorInvalidValue;
    const cudaError_t err = cudaMemsetAsync(next, 0, sizeof(int), (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
    bvh_walk_kernel<<<grid, kWalkThreads, 0, (cudaStream_t)stream>>>(
        start, seg, t_init, n, reinterpret_cast<const float4*>(nodes), n_nodes,
        reinterpret_cast<const float4*>(tris), t, id, u, v, visits, tested, next);
  }
  return (int)cudaGetLastError();
}

int fspt_treelet_walk(const float* F, int n_pad, const float* nodes, int n_nodes,
                      const float* W, float* t, int* best, int* visits, int* tested,
                      void* stream) {
  using namespace fspt_bvh;
  if (n_pad > 0) {
    treelet_walk_kernel<<<(n_pad + kWalkThreads - 1) / kWalkThreads, kWalkThreads, 0,
                          (cudaStream_t)stream>>>(F, n_pad,
                                                  reinterpret_cast<const float4*>(nodes),
                                                  n_nodes, W, t, best, visits, tested);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
