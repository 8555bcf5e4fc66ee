// The closest hit of kernel 13 (mesh_camera_path_kernel): the staged
// primitive rows of kernels 2-4, then a walk of the scene's BVH in kernel
// 11's packed records, its node steps and leaf tests in warp-wide phases.
//
// MeshRows is the path body's Rows policy for a BVH scene (csrc/
// fspt_kernels.cuh: TableRows, SmemRows).  Its intersect_lanes first walks
// the staged analytic rows exactly as SmemRows does, then walks the tree
// without a stack, in the order of ops/bvh.walk_bvh (node + 1 into an
// entered internal node, else the miss link; a node is pruned when its slab
// entry t exceeds the best t), seeded with the analytic t, so that a
// triangle wins only where it is strictly closer (ops/cuda_bvh.
// make_mesh_intersector's rule).  A triangle winner takes its shading normal
// and material from the shade records, by original triangle id, as
// render/integrator.merge_triangle_hit interpolates them; the path body
// flips the normal to the segment's side as for any other hit
// (render/queue.py's sidedness).  The arithmetic is kernel 11's
// (csrc/fspt_bvh.cu bvh_walk_kernel: slab_entry, the cross-form
// Möller–Trumbore), term for term, so with -fmad=false the winner, t and the
// counts equal the plain walk's.
//
// The walk is kernel 11's plan (leaves postponed: Aila and Laine,
// "Understanding the efficiency of ray traversal on GPUs", HPG 2009).  A
// lane takes node steps until it reaches a leaf whose box it hits, and holds
// the leaf; the warp takes its node steps in runs of kMeshWalkRun, votes
// after each run, and leaves them once no more of its lanes walk than hold a
// leaf.  Then every lane that holds a leaf tests it in one pass (mesh_leaf),
// and the lanes walk on.  A lane tests its leaf before its next node step,
// as the plain walk does, so each segment visits the plain walk's nodes in
// its order, with its prune.  Testing each leaf the moment a lane took it
// left the warp's other lanes waiting in most of its triangle tests (one or
// two lanes a pass); the runs keep the votes off most node steps.  Unlike
// kernel 11's, the warp here is the lanes whose paths are live: a lane whose
// path has ended leaves the path body before its closest hit, and threads
// past n never enter it.  So the votes run over the lanes that entered
// (__activemask()), and the rule counts only the lanes that walk or hold a
// leaf; a lane alone tests each leaf as it takes it.  The rule, the run and
// the occupancy were measured against others on an H100 (PERF.md §6).
//
// Records (ops/cuda_bvh.walk_nodes / walk_tris, ops/cuda_path.mesh_shade):
//   node     (bmin, bits(miss)), (bmax, bits(first << kMeshCountBits | count))
//   triangle (v0, area2), (e1, bits(original id)), (e2, 0)
//   shade    (n0, bits(material)), (n1 - n0, 0), (n2 - n0, 0)
// The tree (~12 MB at the heightfield's 99,458 triangles) sits in the H100's
// L2; each record is read with 16-byte loads through the read-only path.
//
// kCount keeps the thread's node steps and triangle tests over its whole
// path (the counters of kernel 11's visits and tested), and on the lowest
// lane of each walking warp the warp's walks, its leaf phases and the
// leaves tested in them, for the kernel's per-warp totals.
#pragma once

#include "fspt_kernels.cuh"

namespace fspt {

// The low bits of a packed node's last word hold a leaf's triangle count
// (0: internal node), the high bits its first triangle; cuda_bvh.COUNT_BITS.
constexpr int kMeshCountBits = 8;
constexpr unsigned kMeshCountMask = (1u << kMeshCountBits) - 1u;
// Kernel 13's launch bounds: blocks of kPathBlock, kMeshMinBlocks an SM.
constexpr int kMeshMinBlocks = 8;
// The warp takes its node steps in runs of kMeshWalkRun (a lane that takes a
// leaf in a run takes no further step), and after each run leaves them for a
// leaf phase once no more of its lanes walk than hold a leaf.
constexpr int kMeshWalkRun = 4;
// The counting build's totals a launch (ops/cuda_path.MESH_TOTALS): node
// steps, triangle tests, leaf phases, leaves tested in them, warp walks.
constexpr int kMeshTotals = 5;

template <bool kCount>
struct MeshRows : SmemRows {
  const float4* __restrict__ nodes;  // [n_nodes][2]
  const float4* __restrict__ tris;   // [T][3], leaf order
  const float4* __restrict__ shade;  // [T][3], by original id
  int n_nodes;
  mutable unsigned visits;  // node steps (kCount)
  mutable unsigned tests;   // triangle tests (kCount)
  mutable unsigned walks;   // warp walks, on the warp's lowest lane (kCount)
  mutable unsigned phases;  // leaf phases that tested a leaf, on the lowest lane (kCount)
  mutable unsigned leaves;  // leaves tested in them, on the lowest lane (kCount)
};

// 1 / d with |d| below 1e-30 taken as ±1e-30 (ops/bvh._slab_entry; kernel
// 11's guarded_rcp).
__device__ __forceinline__ float mesh_rcp(float d) {
  const float g = fabsf(d) < 1e-30f ? (d >= 0.0f ? 1e-30f : -1e-30f) : d;
  return 1.0f / g;
}

// Slab test of the segment (start o, guarded reciprocal r) against a packed
// node's box (ops/bvh._slab_entry, kernel 11's slab_entry): hit, and the
// entry t clamped at 0.
__device__ __forceinline__ bool mesh_slab(const float4& lo, const float4& hi, float o0,
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

// The leaf `leaf` (first << kMeshCountBits | count; 0: none) against the
// segment: the cross-form Möller–Trumbore of kernel 11, term for term, each
// triangle replacing the best where it is strictly closer.
__device__ __forceinline__ void mesh_leaf(const float4* __restrict__ tris, unsigned leaf,
                                          float sx, float sy, float sz, float dx, float dy,
                                          float dz, float& tb, int& best, float& bu,
                                          float& bv) {
  const int first = (int)(leaf >> kMeshCountBits), cnt = (int)(leaf & kMeshCountMask);
  for (int k = 0; k < cnt; ++k) {
    const float4* q = tris + 3 * (first + k);
    const float4 a = __ldg(q), e1 = __ldg(q + 1), e2 = __ldg(q + 2);
    const float pvx = dy * e2.z - dz * e2.y;
    const float pvy = dz * e2.x - dx * e2.z;
    const float pvz = dx * e2.y - dy * e2.x;
    const float det = e1.x * pvx + e1.y * pvy + e1.z * pvz;
    const bool np = fabsf(det) >= kEps * a.w;
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
}

// The closest hit of the segment over the staged rows and the tree.  Only
// the direct mode (kernel 13) walks a tree: a textured mesh is refused on
// the host.
template <bool kTex, bool kCount>
__device__ __forceinline__ Hit intersect_lanes(const MeshRows<kCount>& rows, int n_prims,
                                               float sx, float sy, float sz, float dx,
                                               float dy, float dz) {
  static_assert(!kTex, "the mesh walk gives no texcoords");
  Hit h = intersect_lanes<kTex, SmemRows>(rows, n_prims, sx, sy, sz, dx, dy, dz);
  // The lanes that entered; the lowest of them counts the warp's walk.
  const unsigned warp = __activemask();
  const bool lead = kCount && (warp & (0u - warp)) == 1u << (threadIdx.x & 31);
  if (lead) ++rows.walks;
  const float rx = mesh_rcp(dx), ry = mesh_rcp(dy), rz = mesh_rcp(dz);
  float tb = h.t;
  int best = -1;
  float bu = 0.0f, bv = 0.0f;
  int node = tb > 0.0f ? 0 : rows.n_nodes;
  unsigned leaf = 0;  // the leaf held, 0: none
  for (;;) {
    unsigned walking, holding;
    do {
#pragma unroll
      for (int k = 0; k < kMeshWalkRun; ++k) {
        if (node < rows.n_nodes && leaf == 0) {
          const float4 lo = __ldg(rows.nodes + 2 * node);
          const float4 hi = __ldg(rows.nodes + 2 * node + 1);
          if (kCount) ++rows.visits;
          float entry;
          const bool box = mesh_slab(lo, hi, sx, sy, sz, rx, ry, rz, entry) && entry <= tb;
          const unsigned meta = (unsigned)__float_as_int(hi.w);
          const unsigned cnt = meta & kMeshCountMask;
          if (box && cnt > 0) {
            leaf = meta;
            if (kCount) rows.tests += cnt;
          }
          node = (box && cnt == 0) ? node + 1 : __float_as_int(lo.w);
        }
      }
      walking = __ballot_sync(warp, node < rows.n_nodes && leaf == 0);
      holding = __ballot_sync(warp, leaf != 0);
    } while (__popc(walking) > __popc(holding));
    if (holding == 0) break;  // and none walks: the walk is over
    if (lead) {
      ++rows.phases;
      rows.leaves += (unsigned)__popc(holding);
    }
    mesh_leaf(rows.tris, leaf, sx, sy, sz, dx, dy, dz, tb, best, bu, bv);
    leaf = 0;
  }
  if (best >= 0) {
    // merge_triangle_hit: n0 + (n1 - n0)·u + (n2 - n0)·v.
    const float4* s = rows.shade + 3 * best;
    const float4 s0 = __ldg(s), s1 = __ldg(s + 1), s2 = __ldg(s + 2);
    h.t = tb;
    h.nx = s0.x + s1.x * bu + s2.x * bv;
    h.ny = s0.y + s1.y * bu + s2.y * bv;
    h.nz = s0.z + s1.z * bu + s2.z * bv;
    h.mat = __float_as_int(s0.w);
    h.kind = TRIANGLE;
    h.prim = n_prims + best;
    finish_hit<kTex>(h, sx, sy, sz, dx, dy, dz);
  }
  return h;
}

}  // namespace fspt
