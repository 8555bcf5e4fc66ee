// The path-body adjoint of the port: kernels 9, 10 and kernel 8's whole
// chain.  Plain C launchers, loaded with ctypes by ops/_build.py; each
// returns cudaGetLastError().
//
//   fspt_grad_forward      kernel 9   replaces pallas_grad.py:216
//                                     make_grad_path_tracer fwd (body :188)
//   fspt_grad_sweep        kernel 10  replaces pallas_grad.py:227
//   fspt_grad_backward                make_grad_path_tracer bwd (body :193):
//                                     the sweep of kernel 9's record, or
//                                     the trace and the sweep (remat)
//   fspt_fused_loss_chain  kernel 8   replaces pallas_grad.py:792
//                                     make_fused_loss_grad_fn, whole chain
//                                     and remat (body :589, :700-753)
//
// The optimized table cells come at run time in a parameter vector pvec
// [P] with a cell map cells[P_mat] (the row * kMatStride + column each
// packed material parameter overwrites; the 9 camera values of kernel 8
// follow the material ones).  Each block copies the material table into
// shared memory and writes the parameters into their cells, so the body
// reads them as it reads any table value.  Kernel 9 traces the float body
// over that table: the plain version (the body with tmats) and it agree bit
// for bit.  It is persistent and regenerating (a thread takes a new lane
// as soon as its path ends), so its warps run full until their chunks of
// the band are spent.
//
// Kernels 10 and 8 are reverse mode: the reference's remat construction
// (pallas_grad.py:700-753), a per-bounce recompute sweep, written by hand.
// Per lane:
//   1. the float body (trace_path_t<kDirect, float>, kernel 9's arithmetic)
//      records each live bounce's segment, throughput and winner row (10
//      words a bounce), a depth-0 fog absorption, and the radiance before
//      the light clamp (the direct mode's sink, csrc/fspt_kernels.cuh);
//   2. the radiance cotangent (kernel 10: the incoming one; kernel 8: B - t
//      into buffer A and A - t into B) goes through the clamp's adjoint;
//   3. the bounces are swept from the last to the first: each is re-run in
//      float from its record (the winner's t and normal recomputed from its
//      row, not searched) and its hand-written adjoint carries the
//      cotangent of (segment, throughput) back one bounce, adding the
//      parameter cotangents of the cells it read;
//   4. kernel 8 with the camera sends the primary segment's cotangent
//      through the adjoint of traced_camera_ray into the 9 camera entries.
// The cost is one forward trace and one sweep whatever P is.  Derivative
// rules: branches read the float values, ties of fmax pass the cotangent
// to its first argument (as torch.clamp does), plane hits and sphere roots
// take the reference's floors (pallas_trace.py _graze_div, _graze_sqrt;
// ops/cuda_trace.py), and a zero cotangent meets no infinite local
// derivative.
//
// Kernel 10 has two routes.  They share every line of steps 2-3 and
// differ only in where step 1's record comes from:
//   * sweep (grad_sweep_kernel): kernel 9 wrote each lane's record as it
//     traced it (grad_forward_kernel<1>) into [depth·3 + 1][n] planes of
//     float4 in device memory (RecordStore: its live bounces and a tail),
//     and kernel 10 only sweeps it.  ops/cuda_grad takes this route where
//     the call wants a gradient and the record, n·(48·depth + 16) bytes
//     (3.3 GB at 1080p×4, depth 8), fits in an eighth of the card's
//     memory.
//   * remat (grad_backward_kernel): kernel 10 traces every lane again to
//     rebuild its record, as the TPU reference does, whose VMEM is small and
//     whose device memory is tight, so it recomputes rather than keeps.  On
//     the H100's 80 GB the trace was over half of the launch (PERF.md §5),
//     and this route stays for a band whose record would not fit and for
//     kernel 10 launched on its own.
// The same bits summed in the same order: both routes give the same
// gradient bit for bit.  Kernel 8's whole chain keeps its in-launch trace:
// its two traces feed its loss in the same launch.
//
// Parameter cotangents go into a per-thread column of shared memory,
// [rows][blockDim] (thread t owns column t), so a lane's non-finite
// entries can be zeroed and the lane counted (the counterpart of the
// reference's _keep_finite); blocks then sum their
// columns in a fixed order (warp shuffles, then the warps in turn) into one
// column per block of a [rows][blocks] partial, and adjoint_reduce sums
// each row of it over the blocks in double, reading it coalesced.  No atomics: the same inputs give the same bits on every run.
// The block is 128 threads, or 64 or 32 when P columns of 128 threads do
// not fit in shared memory.
//
// Where the remat record lives (kLayout): 0, a per-thread array (local
// memory, cached in L1/L2, sized for kMaxAdjDepth bounces), up to
// kMaxAdjDepth bounces; 1, a [depth][10][n] scratch in device memory that
// the wrapper allocates, past it.  Kernel 8 keeps both buffers' records.
// fspt_adjoint_plan gives the wrapper the block and the scratch a launch
// takes; the launchers follow the same plan.
//
// What bounds them on the H100: operations, the forward trace's walk of
// every primitive row per segment (kernel 9's work), then the sweep's
// shading and adjoint without that walk; the sweep route adds kernel 9's
// writes and kernel 10's reads of the record's live bounces and tails,
// about 1.7 GB each at the pool-8 launch.

#include "fspt_adjoint.cuh"

namespace fspt {

constexpr int kMaxAdjDepth = 16;   // bounces a per-thread record holds
constexpr int kStateWords = 10;    // segment (6), throughput (3), winner row

// Kernel 9's schedule (constants, each the fastest of its variants on an
// H100, PERF.md §6).  Seven blocks an SM (launch bounds: 72 registers, a
// few bytes of spill); the grid is the card's resident blocks
// (fspt_grad_forward_plan).  The band's 32-lane chunks are dealt to the W
// warps of the grid in rounds of W, round r rotated by r: warp w takes
// chunk r·W + (w + r) mod W.  So every warp's chunks lie all over the
// band, and its mix of path lengths is the frame's (chunk c ≡ w mod W
// alone would keep a warp in a few image columns).  A path has ended when
// it is dead or at pp.depth; once kFwdRefill threads of a warp are idle
// or ended, each ended one writes its lane and every idle one takes the
// next lane of the warp's chunk.
constexpr int kFwdMinBlocks = 7;
constexpr int kFwdRefill = 4;
// With its record, six blocks an SM (80 registers): 6 % faster than seven
// and 19 % than eight at the pool-8 route's launch (PERF.md §6).
constexpr int kFwdRecordMinBlocks = 6;

// Kernel 10's remat route at five blocks an SM (launch bounds: at most 96
// registers, a few bytes of spill).  Left free, the compiler gives it
// 105-106 and four blocks, slower on an H100 at the pool-8 route's launch
// (PERF.md §6).
constexpr int kBackwardMinBlocks = 5;
// Its sweep route, with no trace inline, at five too: at six to eight the
// compiler spills and the launch runs 2-18 % slower (PERF.md §6).
constexpr int kSweepMinBlocks = 5;

// --- a lane's record of its forward trace ----------------------------------

// Layout 0: a per-thread array.
struct LocalState {
  float w[kMaxAdjDepth][kStateWords];
  __device__ __forceinline__ void bind(float*, size_t) {}
  __device__ __forceinline__ float& at(int d, int k) { return w[d][k]; }
};

// Layout 1: the lane's words of a [depth][kStateWords][n] scratch in device
// memory.
struct ScratchState {
  float* p;  // scratch + lane
  size_t n;
  __device__ __forceinline__ void bind(float* p_, size_t n_) { p = p_; n = n_; }
  __device__ __forceinline__ float& at(int d, int k) {
    return p[(size_t)(d * kStateWords + k) * n];
  }
};

template <int kLayout>
struct StateOf { using type = LocalState; };
template <>
struct StateOf<1> { using type = ScratchState; };

// Kernel 9's record for the sweep route: [depth·3 + 1][n] planes of float4
// in device memory, lane i at record + 4i.  Bounce d takes planes 3d ..
// 3d+2 (its kStateWords words padded to 12), the lane's tail plane
// 3·depth.  A bounce is three 16-byte stores, and three loads in the
// sweep, whose lanes step down one depth together: neighbouring lanes at
// neighbouring addresses.  F is const float where the sweep reads it.
template <class F>
struct RecordStore {
  F* p;  // record + 4·lane
  size_t n;
  __device__ __forceinline__ void bind(F* p_, size_t n_) { p = p_; n = n_; }
  __device__ __forceinline__ F* quad(int q) const { return p + (size_t)q * n * 4; }
  __device__ __forceinline__ F& at(int d, int k) const { return quad(3 * d + k / 4)[k & 3]; }
};
using RecordView = RecordStore<const float>;

// Whether the sweep steps a warp's lanes down together (kernel 9's record).
template <class Store>
constexpr bool kSweepTogether = false;
template <>
constexpr bool kSweepTogether<RecordView> = true;

// A bounce's words into and out of a store, one word at a time ...
template <class Store>
__device__ __forceinline__ void put_bounce(Store& st, int d, const float (&w)[kStateWords]) {
#pragma unroll
  for (int k = 0; k < kStateWords; ++k) st.at(d, k) = w[k];
}

template <class Store>
__device__ __forceinline__ void get_bounce(Store& st, int d, float (&w)[kStateWords]) {
#pragma unroll
  for (int k = 0; k < kStateWords; ++k) w[k] = st.at(d, k);
}

// ... and 16 bytes at a time in kernel 9's record.  Its stores are
// streaming (__stcs, evict first): the sweep reads them in another launch,
// after more than the L2 holds has been written (3-4 % of kernel 9's time,
// PERF.md §6).
__device__ __forceinline__ void put_bounce(RecordStore<float>& st, int d,
                                           const float (&w)[kStateWords]) {
  __stcs(reinterpret_cast<float4*>(st.quad(3 * d)), make_float4(w[0], w[1], w[2], w[3]));
  __stcs(reinterpret_cast<float4*>(st.quad(3 * d + 1)), make_float4(w[4], w[5], w[6], w[7]));
  __stcs(reinterpret_cast<float4*>(st.quad(3 * d + 2)), make_float4(w[8], w[9], 0.0f, 0.0f));
}

__device__ __forceinline__ void get_bounce(RecordView& st, int d, float (&w)[kStateWords]) {
  const float4 a = *reinterpret_cast<const float4*>(st.quad(3 * d));
  const float4 b = *reinterpret_cast<const float4*>(st.quad(3 * d + 1));
  const float4 c = *reinterpret_cast<const float4*>(st.quad(3 * d + 2));
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
  w[8] = c.x; w[9] = c.y;
}

// The direct mode's sink of the reverse kernels (NoSlots' hooks, kept).
template <class Store>
struct Recorder {
  Store st;
  bool absorbed;   // depth-0 fog absorbed the lane at depth 1
  bool alive_end;  // alive after the last bounce (the fast-render terminal)
  float L[3];      // radiance before the light clamp

  __device__ __forceinline__ void bounce(int d, float sx, float sy, float sz, float dx,
                                         float dy, float dz, float Tx, float Ty, float Tz,
                                         int prim) {
    const float w[kStateWords] = {sx, sy, sz, dx, dy, dz, Tx, Ty, Tz, __int_as_float(prim)};
    put_bounce(st, d, w);
  }
  __device__ __forceinline__ void fog_absorbed() { absorbed = true; }
  __device__ __forceinline__ void end(bool alive, float Lx, float Ly, float Lz) {
    alive_end = alive;
    L[0] = Lx; L[1] = Ly; L[2] = Lz;
  }
};

// The tail of a lane's record (plane 3·depth): the radiance before the
// light clamp, then one word of the lane's segments (bits kTailSegShift..)
// and flags.  Everything the sweep reads besides the bounces and the
// lane's sample hash, which it recomputes (camera_ray).
constexpr int kTailAbsorbed = 1, kTailAliveEnd = 2, kTailPLight = 4, kTailSegShift = 3;

__device__ __forceinline__ void put_tail(const Recorder<RecordStore<float>>& rec, int depth,
                                         const PathOut& o) {
  const int flags = (o.segcnt << kTailSegShift) | (rec.absorbed ? kTailAbsorbed : 0)
                    | (rec.alive_end ? kTailAliveEnd : 0) | (o.p_light ? kTailPLight : 0);
  __stcs(reinterpret_cast<float4*>(rec.st.quad(3 * depth)),
         make_float4(rec.L[0], rec.L[1], rec.L[2], __int_as_float(flags)));
}

// rec's tail fields from the record; the segments and light mask as the
// sweep reads them from a PathOut.
__device__ __forceinline__ PathOut get_tail(Recorder<RecordView>& rec, int depth) {
  const float4 t = *reinterpret_cast<const float4*>(rec.st.quad(3 * depth));
  rec.L[0] = t.x;
  rec.L[1] = t.y;
  rec.L[2] = t.z;
  const int flags = __float_as_int(t.w);
  rec.absorbed = flags & kTailAbsorbed;
  rec.alive_end = flags & kTailAliveEnd;
  PathOut o{};
  o.segcnt = flags >> kTailSegShift;
  o.p_light = flags & kTailPLight;
  return o;
}

// Kernel 9's sink: none, or with a record the lane's Recorder over the store.
template <int kRecord>
struct ForwardSink { using type = NoSlots; };
template <>
struct ForwardSink<1> { using type = Recorder<RecordStore<float>>; };

// Kernel 9: the float body over the run-time table; radiance as [3][n]
// planes and the lane's segment count, and with kRecord each lane's record
// (RecordStore: its live bounces, then its tail) for kernel 10's sweep
// route.  Persistent and regenerating: the
// threads of a warp trace the lanes of its chunks in turn, one bounce a
// step (path_bounce); an ended path's radiance and segments are written at
// its lane's own index (path_finish), and a new lane is ranked among the
// warp's idle threads by __ballot_sync and __popc.  A lane's result
// depends only on its index (the RNG is counter-based), so the schedule
// changes no bit, and nothing is summed across lanes: no atomics.  The
// record changes no arithmetic of the body.  Each block copies the table
// once.
template <int kRecord>
__global__ void __launch_bounds__(kAdjBlock, kRecord ? kFwdRecordMinBlocks : kFwdMinBlocks)
grad_forward_kernel(const float* __restrict__ prims, const int* __restrict__ meta,
                    const float* __restrict__ mats, const int* __restrict__ mat_meta,
                    const PathParams pp, const CamParams cp, const float* __restrict__ pvec,
                    const int* __restrict__ cells, int n_cells, uint32_t h0, int sample0,
                    int lane0, int n, float* __restrict__ radiance,
                    int* __restrict__ segcnt, float* __restrict__ record) {
  extern __shared__ float smem[];
  load_table(smem, nullptr, mats, pp.n_mats, pvec, cells, n_cells);
  const SmemMats tab{smem};
  const TableRows rows{prims, meta};
  const unsigned below = (1u << (threadIdx.x & 31)) - 1u;
  const int n_warps = gridDim.x * kAdjWarps;
  const int n_chunks = (n + 31) >> 5;
  const int warp = blockIdx.x * kAdjWarps + (threadIdx.x >> 5);
  int round = 0;  // the warp's chunk of round r: r·n_warps + (warp + r) mod n_warps
  int chunk = warp;
  int taken = 0;  // lanes of the current chunk handed out
  int i = -1;     // this thread's lane, -1 when idle
  int depth = 0;
  PathState<float> st;
  typename ForwardSink<kRecord>::type sink;
  for (;;) {
    const bool ended = i >= 0 && (!st.alive || depth >= pp.depth);
    unsigned idle = __ballot_sync(0xffffffffu, i < 0 || ended);
    if (__popc(idle) >= kFwdRefill) {
      if (ended) {
        const PathOut o = path_finish<kDirect>(st, pp, sink);
        radiance[i] = o.L[0];
        radiance[(size_t)n + i] = o.L[1];
        radiance[2 * (size_t)n + i] = o.L[2];
        segcnt[i] = o.segcnt;
        if constexpr (kRecord) put_tail(sink, pp.depth, o);
        i = -1;
      }
      while (idle != 0u && chunk < n_chunks) {
        const int len = min(32, n - (chunk << 5));
        const int at = taken + __popc(idle & below);
        if (i < 0 && at < len) {
          i = (chunk << 5) + at;
          const CameraRay r = camera_ray(cp, h0, sample0, lane0 + i);
          st = path_init<float>(pp, r.hs, r.sx, r.sy, r.sz, r.dx, r.dy, r.dz);
          depth = 0;
          if constexpr (kRecord) {
            sink.st.bind(record + 4 * (size_t)i, (size_t)n);
            sink.absorbed = false;
          }
        }
        taken += __popc(idle);
        if (taken >= len) {
          ++round;
          chunk = round * n_warps + (warp + round) % n_warps;
          taken = 0;
        }
        idle = __ballot_sync(0xffffffffu, i < 0);
      }
    }
    if (idle == 0xffffffffu) break;  // every lane of the warp's chunks written
    if (i >= 0 && st.alive && depth < pp.depth)
      path_bounce<kDirect>(st, depth++, rows, tab, mat_meta, pp, sink);
  }
}

// This thread's column of parameter cotangents: entry p at col[p * stride].
struct ParamCol {
  float* col;
  const int* seed;  // table cell -> parameter index, or -1
  int stride;       // blockDim.x

  __device__ __forceinline__ void cell(int row, int c, float v) const {
    const int p = seed[row * kMatStride + c];
    if (p >= 0) col[p * stride] += v;
  }
  __device__ __forceinline__ void param(int p, float v) const { col[p * stride] += v; }
};

// --- adjoints of the body's vector helpers ---------------------------------

__device__ __forceinline__ float dot3(const float (&a)[3], const float (&b)[3]) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// a += b × c
__device__ __forceinline__ void add_cross(float (&a)[3], const float (&b)[3],
                                          const float (&c)[3]) {
  a[0] += b[1] * c[2] - b[2] * c[1];
  a[1] += b[2] * c[0] - b[0] * c[2];
  a[2] += b[0] * c[1] - b[1] * c[0];
}

// norm3 of (x, y, z) with what its adjoint needs; the same operations as
// norm3 in csrc/fspt_kernels.cuh.
struct Norm3 {
  float in[3], n2, inv, out[3];
};

__device__ __forceinline__ Norm3 norm3_fwd(float x, float y, float z) {
  Norm3 r;
  r.in[0] = x; r.in[1] = y; r.in[2] = z;
  r.n2 = x * x + y * y + z * z;
  r.inv = r.n2 > 0.0f ? rsqrtf(r.n2) : 0.0f;
  r.out[0] = x * r.inv; r.out[1] = y * r.inv; r.out[2] = z * r.inv;
  return r;
}

// g += (d norm3 / d in)^T c: out = in · inv, inv = rsqrt(n2) (a constant 0
// where n2 = 0), d rsqrt(a) = -rsqrt(a) / (2a).
__device__ __forceinline__ void norm3_adj(const Norm3& r, const float (&c)[3],
                                          float (&g)[3]) {
  g[0] += c[0] * r.inv; g[1] += c[1] * r.inv; g[2] += c[2] * r.inv;
  if (r.n2 > 0.0f) {
    const float cinv = dot3(c, r.in);
    const float cn2 = cinv == 0.0f ? 0.0f : cinv * (-0.5f * r.inv / r.n2);
    g[0] += 2.0f * r.in[0] * cn2;
    g[1] += 2.0f * r.in[1] * cn2;
    g[2] += 2.0f * r.in[2] * cn2;
  }
}

// lerped (csrc/fspt_kernels.cuh): norm3(g·amount + r·(1 - amount)),
// flipped into the normal's side.
struct Lerp {
  Norm3 n;
  float sgn, out[3];
};

__device__ __forceinline__ Lerp lerped_fwd(float amount, const float (&g)[3],
                                           const float (&r)[3], const float (&hn)[3]) {
  const float inv = 1.0f - amount;
  Lerp l;
  l.n = norm3_fwd(g[0] * amount + r[0] * inv, g[1] * amount + r[1] * inv,
                  g[2] * amount + r[2] * inv);
  const float d = l.n.out[0] * hn[0] + l.n.out[1] * hn[1] + l.n.out[2] * hn[2];
  l.sgn = d < 0.0f ? -1.0f : 1.0f;
  for (int k = 0; k < 3; ++k) l.out[k] = d < 0.0f ? -l.n.out[k] : l.n.out[k];
  return l;
}

// Cotangent c of lerped's output: adds to cr, returns the amount's.
__device__ __forceinline__ float lerped_adj(const Lerp& l, float amount, const float (&c)[3],
                                            const float (&g)[3], const float (&r)[3],
                                            float (&cr)[3]) {
  const float cy[3] = {l.sgn * c[0], l.sgn * c[1], l.sgn * c[2]};
  float cl[3] = {0.0f, 0.0f, 0.0f};
  norm3_adj(l.n, cy, cl);
  const float inv = 1.0f - amount;
  for (int k = 0; k < 3; ++k) cr[k] += cl[k] * inv;
  return cl[0] * (g[0] - r[0]) + cl[1] * (g[1] - r[1]) + cl[2] * (g[2] - r[2]);
}

// refract (csrc/fspt_kernels.cuh): total internal reflection gives zero.
struct Refract {
  float ndv, sin2, sq, k;
  bool tir;
  Norm3 n;
};

__device__ __forceinline__ Refract refract_fwd(const float (&v)[3], const float (&n)[3],
                                               float index) {
  Refract f;
  f.ndv = -(v[0] * n[0] + v[1] * n[1] + v[2] * n[2]);
  f.sin2 = (index * index) * (1.0f - f.ndv * f.ndv);
  f.sq = sqrtf(f.sin2 < 1.0f ? 1.0f - f.sin2 : 1.0f);
  f.k = index * f.ndv - f.sq;
  f.n = norm3_fwd(v[0] * index + n[0] * f.k, v[1] * index + n[1] * f.k,
                  v[2] * index + n[2] * f.k);
  f.tir = f.sin2 >= 1.0f;
  return f;
}

__device__ __forceinline__ void refract_out(const Refract& f, float (&o)[3]) {
  for (int k = 0; k < 3; ++k) o[k] = f.tir ? 0.0f : f.n.out[k];
}

// Cotangent c of refract's output: adds to cv and cn, returns the index's.
__device__ __forceinline__ float refract_adj(const Refract& f, float index,
                                             const float (&v)[3], const float (&n)[3],
                                             const float (&c)[3], float (&cv)[3],
                                             float (&cn)[3]) {
  if (f.tir) return 0.0f;
  float co[3] = {0.0f, 0.0f, 0.0f};
  norm3_adj(f.n, c, co);
  for (int k = 0; k < 3; ++k) {
    cv[k] += co[k] * index;
    cn[k] += co[k] * f.k;
  }
  float cindex = dot3(co, v);
  const float ck = dot3(co, n);
  cindex += ck * f.ndv;
  float cndv = ck * index;
  // k = index·ndv - sqrt(1 - sin2)
  const float csq = -ck;
  const float csin2 = csq == 0.0f ? 0.0f : -(csq * 0.5f / f.sq);
  cindex += csin2 * (1.0f - f.ndv * f.ndv) * 2.0f * index;
  cndv += csin2 * (index * index) * (-2.0f * f.ndv);
  // ndv = -(v·n)
  for (int k = 0; k < 3; ++k) {
    cv[k] -= cndv * n[k];
    cn[k] -= cndv * v[k];
  }
  return cindex;
}

// rotate (csrc/fspt_kernels.cuh) of f by angle about the constant axis a:
// o = cos·f + (1 - cos)·a(a·f) + sin·(a × f).  Writes o, adds the
// cotangent of f to cf, returns the angle's.
__device__ __forceinline__ void rotate_fwd(const float (&f)[3], float angle,
                                           const float (&a)[3], float (&o)[3]) {
  const float c = cosf(angle), s = sinf(angle), ic = 1.0f - c;
  const float ax = a[0], ay = a[1], az = a[2];
  o[0] = (c + ic * ax * ax) * f[0] + (ic * ax * ay - az * s) * f[1]
         + (ic * ax * az + ay * s) * f[2];
  o[1] = (ic * ax * ay + az * s) * f[0] + (c + ic * ay * ay) * f[1]
         + (ic * ay * az - ax * s) * f[2];
  o[2] = (ic * ax * az - ay * s) * f[0] + (ic * ay * az + ax * s) * f[1]
         + (c + ic * az * az) * f[2];
}

__device__ __forceinline__ float rotate_adj(const float (&f)[3], float angle,
                                            const float (&a)[3], const float (&co)[3],
                                            float (&cf)[3]) {
  const float c = cosf(angle), s = sinf(angle), ic = 1.0f - c;
  const float adc = dot3(a, co), adf = dot3(a, f);
  float axc[3] = {0.0f, 0.0f, 0.0f}, axf[3] = {0.0f, 0.0f, 0.0f};
  add_cross(axc, a, co);
  add_cross(axf, a, f);
  for (int k = 0; k < 3; ++k) cf[k] += c * co[k] + ic * a[k] * adc - s * axc[k];
  return co[0] * (-s * f[0] + s * a[0] * adf + c * axf[0])
         + co[1] * (-s * f[1] + s * a[1] * adf + c * axf[1])
         + co[2] * (-s * f[2] + s * a[2] * adf + c * axf[2]);
}
// --- the winner's t and normal and their adjoint ---------------------------

// The float values of intersect_lanes for the winning row: the same
// operations, so the same bits.
__device__ __forceinline__ void winner_fwd(const float* __restrict__ prims, int kind, int prim,
                                           const float (&s)[3], const float (&d)[3],
                                           float& t, float (&n)[3]) {
  const float* q = prims + prim * kPrimStride;
  if (kind == SPHERE) {
    const float c0 = __ldg(q), c1 = __ldg(q + 1), c2 = __ldg(q + 2);
    const float r = __ldg(q + 3), inv_r = __ldg(q + 4);
    const float ox = s[0] - c0, oy = s[1] - c1, oz = s[2] - c2;
    const float a = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
    const float b = 2.0f * (ox * d[0] + oy * d[1] + oz * d[2]);
    const float oc2 = ox * ox + oy * oy + oz * oz;
    const float rr = r * r;
    const float cc = oc2 - rr;
    const float disc = b * b - 4.0f * a * cc;
    const float sq = sqrtf(disc);
    t = (oc2 <= rr ? -b + sq : -b - sq) / (2.0f * a);
    const float px = s[0] + d[0] * t, py = s[1] + d[1] * t, pz = s[2] + d[2] * t;
    n[0] = (px - c0) * inv_r;
    n[1] = (py - c1) * inv_r;
    n[2] = (pz - c2) * inv_r;
  } else if (kind == TRIANGLE) {
    const float v0x = __ldg(q), v0y = __ldg(q + 1), v0z = __ldg(q + 2);
    const float e1x = __ldg(q + 3), e1y = __ldg(q + 4), e1z = __ldg(q + 5);
    const float e2x = __ldg(q + 6), e2y = __ldg(q + 7), e2z = __ldg(q + 8);
    const float dx = d[0], dy = d[1], dz = d[2];
    const float pvx = dy * e2z - dz * e2y;
    const float pvy = dz * e2x - dx * e2z;
    const float pvz = dx * e2y - dy * e2x;
    const float det = e1x * pvx + e1y * pvy + e1z * pvz;
    const float inv = 1.0f / det;
    const float tx = s[0] - v0x, ty = s[1] - v0y, tz = s[2] - v0z;
    const float ub = (tx * pvx + ty * pvy + tz * pvz) * inv;
    const float qvx = ty * e1z - tz * e1y;
    const float qvy = tz * e1x - tx * e1z;
    const float qvz = tx * e1y - ty * e1x;
    const float vb = (dx * qvx + dy * qvy + dz * qvz) * inv;
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv;
    n[0] = __ldg(q + 10) + __ldg(q + 13) * ub + __ldg(q + 16) * vb;
    n[1] = __ldg(q + 11) + __ldg(q + 14) * ub + __ldg(q + 17) * vb;
    n[2] = __ldg(q + 12) + __ldg(q + 15) * ub + __ldg(q + 18) * vb;
  } else {
    const float p0 = __ldg(q), p1 = __ldg(q + 1), p2 = __ldg(q + 2);
    const float pw = __ldg(q + 3);
    const float ts = p0 * d[0] + p1 * d[1] + p2 * d[2];
    const float ns = -(p0 * s[0] + p1 * s[1] + p2 * s[2] + pw);
    t = ns / ts;
    n[0] = p0; n[1] = p1; n[2] = p2;
  }
}

// Cotangents ct of t and cn of the normal: adds those of the segment to cs
// and cd.  The sphere root and the plane hit take the reference's
// derivative floors (pallas_trace.py _graze_sqrt, _graze_div).
__device__ __forceinline__ void winner_adj(const float* __restrict__ prims, int kind, int prim,
                                           const float (&s)[3], const float (&d)[3], float ct,
                                           const float (&cn)[3], float (&cs)[3],
                                           float (&cd)[3]) {
  const float* q = prims + prim * kPrimStride;
  if (kind == SPHERE) {
    const float c[3] = {__ldg(q), __ldg(q + 1), __ldg(q + 2)};
    const float r = __ldg(q + 3), inv_r = __ldg(q + 4);
    const float o[3] = {s[0] - c[0], s[1] - c[1], s[2] - c[2]};
    const float a = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
    const float b = 2.0f * (o[0] * d[0] + o[1] * d[1] + o[2] * d[2]);
    const float oc2 = o[0] * o[0] + o[1] * o[1] + o[2] * o[2];
    const float rr = r * r;
    const float cc = oc2 - rr;
    const float disc = b * b - 4.0f * a * cc;
    const float sq = sqrtf(disc);
    const bool inside = oc2 <= rr;
    const float den = 2.0f * a;
    const float t = (inside ? -b + sq : -b - sq) / den;
    // n = (s + d t - c) / r
    for (int k = 0; k < 3; ++k) {
      const float cp = cn[k] * inv_r;
      cs[k] += cp;
      cd[k] += cp * t;
      ct += cp * d[k];
    }
    const float cnum = ct / den;
    float ca = 2.0f * (-(ct * t) / den);
    float cb = -cnum;
    const float csq = inside ? cnum : -cnum;
    const float cdisc = csq / (2.0f * fmaxf(sq, 1e-3f * fabsf(b) + 1e-12f));
    cb += cdisc * 2.0f * b;
    ca += cdisc * (-4.0f * cc);
    const float coc2 = cdisc * (-4.0f * a);
    for (int k = 0; k < 3; ++k) {
      cs[k] += 2.0f * o[k] * coc2 + 2.0f * cb * d[k];
      cd[k] += 2.0f * cb * o[k] + 2.0f * ca * d[k];
    }
  } else if (kind == TRIANGLE) {
    const float v0[3] = {__ldg(q), __ldg(q + 1), __ldg(q + 2)};
    const float e1[3] = {__ldg(q + 3), __ldg(q + 4), __ldg(q + 5)};
    const float e2[3] = {__ldg(q + 6), __ldg(q + 7), __ldg(q + 8)};
    float pv[3] = {0.0f, 0.0f, 0.0f}, qv[3] = {0.0f, 0.0f, 0.0f};
    add_cross(pv, d, e2);
    const float tv[3] = {s[0] - v0[0], s[1] - v0[1], s[2] - v0[2]};
    add_cross(qv, tv, e1);
    const float inv = 1.0f / dot3(e1, pv);
    const float U = dot3(tv, pv), V = dot3(d, qv), W = dot3(e2, qv);
    const float cub = cn[0] * __ldg(q + 13) + cn[1] * __ldg(q + 14) + cn[2] * __ldg(q + 15);
    const float cvb = cn[0] * __ldg(q + 16) + cn[1] * __ldg(q + 17) + cn[2] * __ldg(q + 18);
    const float cU = cub * inv, cV = cvb * inv, cW = ct * inv;
    const float cinv = ct * W + cub * U + cvb * V;
    const float cdet = -cinv * inv * inv;
    float cpv[3], ctv[3], cqv[3];
    for (int k = 0; k < 3; ++k) {
      cpv[k] = cdet * e1[k] + cU * tv[k];
      ctv[k] = cU * pv[k];
      cqv[k] = cV * d[k] + cW * e2[k];
      cd[k] += cV * qv[k];
    }
    add_cross(ctv, e1, cqv);  // qv = tv × e1
    add_cross(cd, e2, cpv);   // pv = d × e2
    for (int k = 0; k < 3; ++k) cs[k] += ctv[k];
  } else {
    const float pn[3] = {__ldg(q), __ldg(q + 1), __ldg(q + 2)};
    const float pw = __ldg(q + 3);
    const float ts = pn[0] * d[0] + pn[1] * d[1] + pn[2] * d[2];
    const float ns = -(pn[0] * s[0] + pn[1] * s[1] + pn[2] * s[2] + pw);
    const float floor = 1e-3f * sqrtf(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]) + 1e-20f;
    const float safe = (ts < 0.0f ? -1.0f : 1.0f) * fmaxf(fabsf(ts), floor);
    const float cns = ct / safe;
    const float cts = -(ct * ns) / (safe * safe);
    for (int k = 0; k < 3; ++k) {
      cd[k] += cts * pn[k];
      cs[k] -= cns * pn[k];
    }
  }
}
// --- one bounce, re-run and swept back -------------------------------------

// Bounce `depth` of a lane re-run in float from its record (segment s, d,
// throughput T, winner row prim) and swept back.  On entry cT, cs, cd are
// the cotangents of the throughput and segment the bounce hands on; on exit
// those of the ones it received.  cL is the radiance's (constant over the
// sweep: each bounce adds to it).  fog_row >= 0: the depth-0 fog of that row
// absorbed the lane here.  The expressions that decide a branch are the
// body's own (trace_path_t), so every branch goes the forward trace's way.
__device__ __forceinline__ void bounce_adjoint(
    const float* __restrict__ prims, const int* __restrict__ meta, const SmemMats& mats,
    const int* __restrict__ mat_meta, const PathParams& pp, uint32_t hs, int depth,
    const float (&s)[3], const float (&d)[3], const float (&T)[3], int prim, int fog_row,
    const float (&cL)[3], float (&cT)[3], float (&cs)[3], float (&cd)[3], const ParamCol& g) {
  if (fog_row >= 0) {
    // L += T ⊙ (the fog row's diffuse); the lane stops with T and its
    // segment unchanged.
    for (int c = 0; c < 3; ++c) {
      g.cell(fog_row, c, cL[c] * T[c]);
      cT[c] += cL[c] * mats.get(fog_row, c);
    }
    return;
  }
  if (prim < 0) {
    // Miss: L += T ⊙ sky, the sky row's emission x3.
    for (int c = 0; c < 3; ++c) {
      g.cell(pp.sky_idx, 3 + c, (cL[c] * T[c]) * 3.0f);
      cT[c] += cL[c] * mats.sky(c, pp);
    }
    return;
  }
  const int kind = __ldg(meta + 2 * prim);
  const int mraw = __ldg(meta + 2 * prim + 1);
  const int row = mraw > 0 ? mraw : 0;
  float t, n0[3];
  winner_fwd(prims, kind, prim, s, d, t, n0);
  const float p[3] = {s[0] + d[0] * t, s[1] + d[1] * t, s[2] + d[2] * t};
  // Backface flip.
  const float side = n0[0] * (s[0] - p[0]) + n0[1] * (s[1] - p[1]) + n0[2] * (s[2] - p[2]);
  const bool flip = side < 0.0f;
  const float hn[3] = {flip ? -n0[0] : n0[0], flip ? -n0[1] : n0[1], flip ? -n0[2] : n0[2]};
  const Norm3 vn = norm3_fwd(p[0] - s[0], p[1] - s[1], p[2] - s[2]);
  const float (&v)[3] = vn.out;
  const uint32_t base = 16u + (uint32_t)(depth * pp.bounce_slots);
  const float u0 = uniform(hs, base + 0u);
  const float u1 = uniform(hs, base + 1u);
  const float u2 = uniform(hs, base + 2u);
  const float u3 = uniform(hs, base + 3u);
  const float ndv = hn[0] * v[0] + hn[1] * v[1] + hn[2] * v[2];
  const float r[3] = {v[0] - 2.0f * ndv * hn[0], v[1] - 2.0f * ndv * hn[1],
                      v[2] - 2.0f * ndv * hn[2]};
  float gv[3];
  {
    const float gz = 1.0f - 2.0f * u1;
    const float gr = sqrtf(fmaxf(1.0f - gz * gz, 0.0f));
    const float phi = kTwoPi * u2;
    const float gx = gr * cosf(phi);
    const float gy = gr * sinf(phi);
    const float gdot = gx * hn[0] + gy * hn[1] + gz * hn[2];
    gv[0] = gdot < 0.0f ? -gx : gx;
    gv[1] = gdot < 0.0f ? -gy : gy;
    gv[2] = gdot < 0.0f ? -gz : gz;
  }

  // The outputs: L += T ⊙ e, T' = T ⊙ c, s' = p + b·offset, d' = b·seg_scale.
  float cp[3], cb[3], cc[3], ce[3];
  for (int k = 0; k < 3; ++k) {
    cp[k] = cs[k];
    cb[k] = cs[k] * pp.ray_offset + cd[k] * pp.seg_scale;
    cc[k] = cT[k] * T[k];
    ce[k] = cL[k] * T[k];
  }
  float coef[3] = {0.0f, 0.0f, 0.0f}, bias[3] = {0.0f, 0.0f, 0.0f};
  float cv[3] = {0.0f, 0.0f, 0.0f}, chn[3] = {0.0f, 0.0f, 0.0f}, cr[3] = {0.0f, 0.0f, 0.0f};
  if (row < pp.n_mats) {
    const int* mm = mat_meta + kMetaStride * row;
    const int mtype = __ldg(mm);
    const int flags = __ldg(mm + 1);
    const float dif[3] = {mats.get(row, 0), mats.get(row, 1), mats.get(row, 2)};
    switch (mtype) {
      case LIGHT:
        for (int k = 0; k < 3; ++k) {
          bias[k] = mats.get(row, 3 + k);
          g.cell(row, 3 + k, ce[k]);
        }
        break;
      case DIFFUSE: {
        const float ndl = gv[0] * hn[0] + gv[1] * hn[1] + gv[2] * hn[2];
        const float nl = fmaxf(ndl, 0.0f);
        for (int k = 0; k < 3; ++k) {
          coef[k] = dif[k] * nl;
          g.cell(row, k, cc[k] * nl);
        }
        const float cndl = ndl >= 0.0f ? dot3(cc, dif) : 0.0f;
        for (int k = 0; k < 3; ++k) chn[k] += gv[k] * cndl;
        break;
      }
      case METAL: {
        const float rough = mats.get(row, 9);
        const Lerp l = lerped_fwd(rough, gv, r, hn);
        const float ndl = l.out[0] * hn[0] + l.out[1] * hn[1] + l.out[2] * hn[2];
        const float nl = fmaxf(ndl, 0.0f);
        const float f = rough * nl + (1.0f - rough);
        for (int k = 0; k < 3; ++k) {
          coef[k] = dif[k] * f;
          g.cell(row, k, cc[k] * f);
        }
        const float cf = dot3(cc, dif);
        float crough = cf * nl - cf;
        const float cndl = ndl >= 0.0f ? cf * rough : 0.0f;
        float co[3];
        for (int k = 0; k < 3; ++k) {
          co[k] = cb[k] + cndl * hn[k];
          chn[k] += cndl * l.out[k];
        }
        crough += lerped_adj(l, rough, co, gv, r, cr);
        g.cell(row, 9, crough);
        break;
      }
      case MIRROR:
        for (int k = 0; k < 3; ++k) {
          coef[k] = dif[k];
          g.cell(row, k, cc[k]);
          cr[k] += cb[k];
        }
        break;
      case CERAMIC:
      case GLOW: {
        const float shin = mats.get(row, 9);
        const bool spike = u0 < 0.1f;
        const float amount = spike ? 0.0f : 1.0f - shin;
        const Lerp l = lerped_fwd(amount, gv, r, hn);
        const float ndl = l.out[0] * hn[0] + l.out[1] * hn[1] + l.out[2] * hn[2];
        const float nl = fmaxf(ndl, 0.0f);
        const Norm3 hv = norm3_fwd(l.out[0] - v[0], l.out[1] - v[1], l.out[2] - v[2]);
        const float hdn = hv.out[0] * hn[0] + hv.out[1] * hn[1] + hv.out[2] * hn[2];
        const float x = hdn * hdn;
        const float spec = pow25(x);
        const float om = 1.0f - spec;
        for (int k = 0; k < 3; ++k) {
          coef[k] = spec + dif[k] * nl * (1.0f - spec);
          g.cell(row, k, cc[k] * nl * om);
        }
        if (mtype == GLOW) {
          for (int k = 0; k < 3; ++k) {
            bias[k] = mats.get(row, 6 + k);
            g.cell(row, 6 + k, ce[k]);
          }
        }
        const float cnl = dot3(cc, dif) * om;
        const float cspec = cc[0] * (1.0f - dif[0] * nl) + cc[1] * (1.0f - dif[1] * nl)
                            + cc[2] * (1.0f - dif[2] * nl);
        const float x2 = x * x, x4 = x2 * x2, x8 = x4 * x4, x16 = x8 * x8;
        const float chdn = cspec * 25.0f * (x16 * x8) * 2.0f * hdn;
        const float chv[3] = {chdn * hn[0], chdn * hn[1], chdn * hn[2]};
        float co[3] = {0.0f, 0.0f, 0.0f};
        norm3_adj(hv, chv, co);  // h = norm3(o - v)
        const float cndl = ndl >= 0.0f ? cnl : 0.0f;
        for (int k = 0; k < 3; ++k) {
          chn[k] += chdn * hv.out[k] + cndl * l.out[k];
          cv[k] -= co[k];
          co[k] += cb[k] + cndl * hn[k];
        }
        const float camount = lerped_adj(l, amount, co, gv, r, cr);
        if (!spike) g.cell(row, 9, -camount);
        break;
      }
      case GLASS: {
        const float index = mats.get(row, 10), refl = mats.get(row, 11);
        const float frost = mats.get(row, 12);
        for (int k = 0; k < 3; ++k) {
          coef[k] = dif[k];
          g.cell(row, k, cc[k]);
        }
        if (u0 < refl) {
          const Lerp l = lerped_fwd(frost, gv, r, hn);
          g.cell(row, 12, lerped_adj(l, frost, cb, gv, r, cr));
        } else {
          const bool straight = flags & kFlagGlassStraight;
          Norm3 sn;
          Refract rf;
          float f0[3];
          if (straight) {
            sn = norm3_fwd(v[0], v[1], v[2]);
            for (int k = 0; k < 3; ++k) f0[k] = sn.out[k];
          } else {
            rf = refract_fwd(v, hn, index);
            refract_out(rf, f0);
          }
          float cf0[3] = {0.0f, 0.0f, 0.0f};
          if (flags & kFlagFrostFull) {
            // The direction is the hemisphere sample: no cotangent.
          } else if (flags & kFlagFrostNone) {
            for (int k = 0; k < 3; ++k) cf0[k] = cb[k];
          } else {
            const float sa = kPi * frost;
            const float delta = (u3 * 2.0f - 1.0f) * (sa * 0.5f);
            const float cdelta = rotate_adj(f0, delta, gv, cb, cf0);
            g.cell(row, 12, cdelta * (u3 * 2.0f - 1.0f) * 0.5f * kPi);
          }
          if (straight) norm3_adj(sn, cf0, cv);
          else g.cell(row, 10, refract_adj(rf, index, v, hn, cf0, cv, chn));
        }
        break;
      }
      case LIQUID: {
        const float index = mats.get(row, 10), refl = mats.get(row, 11);
        for (int k = 0; k < 3; ++k) {
          coef[k] = dif[k];
          g.cell(row, k, cc[k]);
        }
        if (u0 < refl) {
          for (int k = 0; k < 3; ++k) cr[k] += cb[k];
        } else {
          const Refract rf = refract_fwd(v, hn, index);
          g.cell(row, 10, refract_adj(rf, index, v, hn, cb, cv, chn));
        }
        break;
      }
      case FOG:
        // Straight on, coefficient 1; the fog's diffuse reaches L at depth
        // 1 (fog_row).
        for (int k = 0; k < 3; ++k) {
          coef[k] = 1.0f;
          cv[k] += cb[k];
        }
        break;
      default:
        break;
    }
  }
  // The received throughput: L += T ⊙ e and T' = T ⊙ c.
  for (int k = 0; k < 3; ++k) cT[k] = cL[k] * bias[k] + cT[k] * coef[k];
  // r = v - 2 (hn·v) hn, then ndv = hn·v.
  const float cndv = -2.0f * dot3(cr, hn);
  for (int k = 0; k < 3; ++k) {
    cv[k] += cr[k] + cndv * hn[k];
    chn[k] += (-2.0f * ndv) * cr[k] + cndv * v[k];
  }
  // v = norm3(p - s).
  float cw[3] = {0.0f, 0.0f, 0.0f};
  norm3_adj(vn, cv, cw);
  // hn = ±n0; p = s + d t.
  float cn0[3], ct = 0.0f;
  for (int k = 0; k < 3; ++k) {
    cn0[k] = flip ? -chn[k] : chn[k];
    const float cpk = cp[k] + cw[k];
    cs[k] = cpk - cw[k];
    cd[k] = cpk * t;
    ct += cpk * d[k];
  }
  winner_adj(prims, kind, prim, s, d, ct, cn0, cs, cd);
}
// --- the lane's sweep, the camera, the block's columns ---------------------

// The light clamp's adjoint: out = L·s, s = light_clamp / norm where the
// depth-0 hit is a light and norm = sqrt(max(|L|², 1e-20)) exceeds it.
__device__ __forceinline__ void clamp_adj(const PathParams& pp, const float (&L)[3],
                                          bool p_light, const float (&cout)[3],
                                          float (&cL)[3]) {
  const float n2 = L[0] * L[0] + L[1] * L[1] + L[2] * L[2];
  const float norm = sqrtf(fmaxf(n2, 1e-20f));
  if (!(p_light && norm > pp.light_clamp)) {
    for (int k = 0; k < 3; ++k) cL[k] = cout[k];
    return;
  }
  const float s = pp.light_clamp / norm;
  const float cnorm = -(dot3(cout, L) * s) / norm;
  const float cn2 = (n2 >= 1e-20f && cnorm != 0.0f) ? cnorm * (0.5f / norm) : 0.0f;
  for (int k = 0; k < 3; ++k) cL[k] = cout[k] * s + 2.0f * L[k] * cn2;
}

// The whole sweep of one traced buffer: cout is the cotangent of its
// (clamped) radiance; cs, cd come out as that of its primary segment.
template <class Store>
__device__ __forceinline__ void sweep(const float* __restrict__ prims,
                                      const int* __restrict__ meta, const SmemMats& mats,
                                      const int* __restrict__ mat_meta, const PathParams& pp,
                                      uint32_t hs, Recorder<Store>& rec, const PathOut& o,
                                      const float (&cout)[3], const ParamCol& g,
                                      float (&cs)[3], float (&cd)[3]) {
  float cL[3];
  clamp_adj(pp, rec.L, o.p_light, cout, cL);
  const bool term = pp.fast_render && rec.alive_end;
  float cT[3];
  for (int k = 0; k < 3; ++k) {
    cT[k] = term ? cL[k] : 0.0f;  // the fast-render white terminal adds T
    cs[k] = 0.0f;
    cd[k] = 0.0f;
  }
  int fog_row = -1;
  if (rec.absorbed) {
    const int m0 = __ldg(meta + 2 * __float_as_int(rec.st.at(0, 9)) + 1);
    fog_row = m0 > 0 ? m0 : 0;
  }
  // Over kernel 9's record the lanes of a warp step down from its longest
  // path together, each from its own last bounce: at a step they read one
  // depth of it, neighbouring addresses.  A per-thread record's lanes step
  // on their own (together, kernel 8's whole chain lost 12 %, PERF.md §6).
  int top = o.segcnt;
  if constexpr (kSweepTogether<Store>) top = __reduce_max_sync(__activemask(), top);
#pragma unroll 1
  for (int depth = top - 1; depth >= 0; --depth) {
    if (kSweepTogether<Store> && depth >= o.segcnt) continue;
    float w[kStateWords];
    get_bounce(rec.st, depth, w);
    const float s[3] = {w[0], w[1], w[2]};
    const float d[3] = {w[3], w[4], w[5]};
    const float T[3] = {w[6], w[7], w[8]};
    const int prim = __float_as_int(w[9]);
    bounce_adjoint(prims, meta, mats, mat_meta, pp, hs, depth, s, d, T, prim,
                   depth == 1 ? fog_row : -1, cL, cT, cs, cd, g);
  }
}

// The primary segment of a lane: camera_ray's fixed one, or with the camera
// values cv the traced one (traced_camera_ray on float).
__device__ __forceinline__ CameraRayT<float> lane_ray(const CamParams& cp,
                                                      const TracedCamParams& tp,
                                                      const float* cv, uint32_t h0,
                                                      int sample0, int flat) {
  if (cv) return traced_camera_ray<float>(cp, tp, cv, h0, sample0, flat);
  const CameraRay f = camera_ray(cp, h0, sample0, flat);
  CameraRayT<float> r;
  r.sx = f.sx; r.sy = f.sy; r.sz = f.sz;
  r.dx = f.dx; r.dy = f.dy; r.dz = f.dz;
  r.hs = f.hs;
  return r;
}

template <class Store>
__device__ __forceinline__ PathOut trace_recorded(const float* __restrict__ prims,
                                                  const int* __restrict__ meta,
                                                  const SmemMats& mats,
                                                  const int* __restrict__ mat_meta,
                                                  const PathParams& pp,
                                                  const CameraRayT<float>& r,
                                                  Recorder<Store>& rec) {
  rec.absorbed = false;
  return trace_path_t<kDirect, float>(TableRows{prims, meta}, mats, mat_meta, pp, r.hs, r.sx,
                                      r.sy, r.sz, r.dx, r.dy, r.dz, rec);
}

// The adjoint of traced_camera_ray (csrc/fspt_kernels.cuh) for the
// cotangent (cs, cd) of the primary segment, into entries p0 .. p0+8 (origin,
// target, fov_y, aperture, focal depth).  Non-finite components of the
// segment's cotangent are zeroed first, as the reference's _keep_finite
// does at the raygen's output.
__device__ __forceinline__ void camera_adj(const CamParams& cp, const TracedCamParams& tp,
                                           const float* cv, uint32_t h0, int sample0,
                                           int flat, float (&cs)[3], float (&cd)[3],
                                           const ParamCol& g, int p0) {
  for (int k = 0; k < 3; ++k) {
    if (!isfinite(cs[k])) cs[k] = 0.0f;
    if (!isfinite(cd[k])) cd[k] = 0.0f;
  }
  const float o[3] = {cv[0], cv[1], cv[2]};
  const float f0[3] = {cv[3] - o[0], cv[4] - o[1], cv[5] - o[2]};
  const float ff = f0[0] * f0[0] + f0[1] * f0[1] + f0[2] * f0[2];
  const float fin = rsqrtf(ff);
  const float f[3] = {f0[0] * fin, f0[1] * fin, f0[2] * fin};
  const float m = f[0] * f[0] + f[2] * f[2];
  const float rin = rsqrtf(fmaxf(m, 1e-20f));
  const float r[3] = {f[2] * rin, 0.0f, -f[0] * rin};
  const float u[3] = {f[1] * r[2] - f[2] * r[1], f[2] * r[0] - f[0] * r[2],
                      f[0] * r[1] - f[1] * r[0]};
  const float th = tanf(cv[6] * tp.half_deg);
  const float half_h = th * cp.z_far;
  const float half_w = th * tp.aspect * cp.z_far;
  const float po[3] = {o[0] + f[0] * cp.z_far, o[1] + f[1] * cp.z_far,
                       o[2] + f[2] * cp.z_far};
  const int smp_s = flat % cp.spp;
  const int pxy = flat / cp.spp;
  const int x = pxy % cp.width;
  const int y = pxy / cp.width;
  const uint32_t hs = sample_hash(h0, (uint32_t)(y * cp.width + x),
                                  (uint32_t)(smp_s + sample0));
  const float xf = (float)x + (uniform(hs, 0u) - 0.5f);
  const float yf = (float)y + (uniform(hs, 1u) - 0.5f);
  const float kx = (xf * cp.inv_wm1) * 2.0f - 1.0f;
  const float ky = (yf * cp.inv_hm1) * 2.0f - 1.0f;
  const float x_dist = half_w * kx, y_dist = half_h * ky;
  float d0[3];
  for (int k = 0; k < 3; ++k) d0[k] = (po[k] + r[k] * x_dist + u[k] * y_dist) - o[k];

  // Cotangents of the pinhole segment (s0 = o, d0) and of the basis.
  float cs0[3], cd0[3], co[3] = {0.0f, 0.0f, 0.0f}, cf[3] = {0.0f, 0.0f, 0.0f};
  float cr[3] = {0.0f, 0.0f, 0.0f}, cu[3] = {0.0f, 0.0f, 0.0f};
  float c7 = 0.0f, c8 = 0.0f;
  for (int k = 0; k < 3; ++k) {
    cs0[k] = cs[k];
    cd0[k] = cd[k];
  }
  if (cp.dof) {
    const float u2 = uniform(hs, 2u);
    const float u3 = uniform(hs, 3u);
    const float q[3] = {o[0] + f[0] * cv[8], o[1] + f[1] * cv[8], o[2] + f[2] * cv[8]};
    const float fpw = q[0] * f[0] + q[1] * f[1] + q[2] * f[2];
    const float ts = -(f[0] * d0[0] + f[1] * d0[1] + f[2] * d0[2]);
    const float ns = -(-(f[0] * o[0] + f[1] * o[1] + f[2] * o[2]) + fpw);
    const bool not_par = fabsf(ts) >= kEps;
    const float tf = ns / (not_par ? ts : 1.0f);
    if (not_par && tf >= 0.0f && tf <= 1.0f) {
      const float angle = u2 * kTwoPi;
      const float su3 = sqrtf(u3);
      const float mag = su3 * cv[7];
      const float ca = cosf(angle), sa = sinf(angle);
      const float offc = ca * mag, offs = sa * mag;
      float fp[3], nsv[3];
      for (int k = 0; k < 3; ++k) {
        fp[k] = o[k] + d0[k] * tf;
        nsv[k] = o[k] + (r[k] * offc + u[k] * offs);
      }
      const Norm3 nd = norm3_fwd(fp[0] - nsv[0], fp[1] - nsv[1], fp[2] - nsv[2]);
      // s = nsv, d = nd · z_far
      const float cnd[3] = {cd[0] * cp.z_far, cd[1] * cp.z_far, cd[2] * cp.z_far};
      float cw[3] = {0.0f, 0.0f, 0.0f};
      norm3_adj(nd, cnd, cw);
      float cns[3];
      for (int k = 0; k < 3; ++k) cns[k] = cs[k] - cw[k];
      const float coffc = dot3(cns, r), coffs = dot3(cns, u);
      c7 += (coffc * ca + coffs * sa) * su3;
      float ctf = 0.0f;
      for (int k = 0; k < 3; ++k) {
        cr[k] += cns[k] * offc;
        cu[k] += cns[k] * offs;
        cs0[k] = cns[k] + cw[k];  // nsv = o + ..., fp = o + d0 tf
        cd0[k] = cw[k] * tf;
        ctf += cw[k] * d0[k];
      }
      const float cnsc = ctf / ts;
      const float ctsc = -(ctf * tf) / ts;
      // ns = f·o - fpw, ts = -(f·d0), fpw = q·f, q = o + f·focal.
      float cq[3];
      for (int k = 0; k < 3; ++k) {
        cf[k] += cnsc * o[k] - ctsc * d0[k] - cnsc * q[k];
        cs0[k] += cnsc * f[k];
        cd0[k] -= ctsc * f[k];
        cq[k] = -cnsc * f[k];
        co[k] += cq[k];
        cf[k] += cq[k] * cv[8];
      }
      c8 += dot3(cq, f);
    }
  }
  // s0 = o, d0 = (po + r x_dist + u y_dist) - o, po = o + f z_far: the
  // origin's terms of d0 cancel.
  float cxd = 0.0f, cyd = 0.0f;
  for (int k = 0; k < 3; ++k) {
    co[k] += cs0[k];
    cf[k] += cd0[k] * cp.z_far;
    cr[k] += cd0[k] * x_dist;
    cu[k] += cd0[k] * y_dist;
    cxd += cd0[k] * r[k];
    cyd += cd0[k] * u[k];
  }
  const float cth = (cxd * kx) * tp.aspect * cp.z_far + (cyd * ky) * cp.z_far;
  const float c6 = cth * (1.0f + th * th) * tp.half_deg;
  // u = f × r; r = (f_z rin, 0, -f_x rin), rin = rsqrt(max(f_x² + f_z², 1e-20)).
  add_cross(cf, r, cu);
  add_cross(cr, cu, f);
  cf[2] += cr[0] * rin;
  cf[0] -= cr[2] * rin;
  const float crin = cr[0] * f[2] - cr[2] * f[0];
  if (m >= 1e-20f && crin != 0.0f) {
    const float cm = crin * (-0.5f * rin / m);
    cf[0] += 2.0f * f[0] * cm;
    cf[2] += 2.0f * f[2] * cm;
  }
  // f = f0 · fin, fin = rsqrt(f0·f0), f0 = target - o.
  const float cfin = dot3(cf, f0);
  const float cff = cfin == 0.0f ? 0.0f : cfin * (-0.5f * fin / ff);
  for (int k = 0; k < 3; ++k) {
    const float cf0 = cf[k] * fin + 2.0f * f0[k] * cff;
    g.param(p0 + k, co[k] - cf0);
    g.param(p0 + 3 + k, cf0);
  }
  g.param(p0 + 6, c6);
  g.param(p0 + 7, c7);
  g.param(p0 + 8, c8);
}

// Zero this lane's non-finite entries; 1 if there was one.
__device__ __forceinline__ int finish_column(const ParamCol& g, int P) {
  int bad = 0;
  for (int p = 0; p < P; ++p) {
    float& v = g.col[p * g.stride];
    if (!isfinite(v)) {
      v = 0.0f;
      bad = 1;
    }
  }
  return bad;
}

// --- the reverse-mode kernels ----------------------------------------------

// Shared memory of the reverse kernels: table and seed map [M·kMatStride]
// each, then rows columns of block threads.
__host__ __device__ constexpr size_t reverse_smem(int n_mats, int rows, int block) {
  return sizeof(float) * (2 * (size_t)n_mats * kMatStride + (size_t)rows * block);
}

// Kernel 10, remat route: per lane, cot · d(radiance)/d(pvec) by one
// recorded trace and one sweep; partial [n_cells][blocks], int_partial
// [2][blocks] (0, lanes with a zeroed non-finite entry).  scratch: layout
// 1's record.
template <int kLayout>
__global__ void __launch_bounds__(kAdjBlock, kBackwardMinBlocks)
grad_backward_kernel(const float* __restrict__ prims, const int* __restrict__ meta,
                     const float* __restrict__ mats, const int* __restrict__ mat_meta,
                     const PathParams pp, const CamParams cp, const float* __restrict__ pvec,
                     const int* __restrict__ cells, int n_cells, uint32_t h0, int sample0,
                     int lane0, int n, const float* __restrict__ cot,
                     float* __restrict__ scratch, float* __restrict__ partial,
                     int* __restrict__ int_partial) {
  extern __shared__ float smem[];
  __shared__ int warp_int[2 * kAdjWarps];
  const int B = blockDim.x;
  const int cells_total = pp.n_mats * kMatStride;
  float* tab = smem;
  int* seed = reinterpret_cast<int*>(smem + cells_total);
  float* acc = smem + 2 * cells_total;
  load_table(tab, seed, mats, pp.n_mats, pvec, cells, n_cells);
  for (int p = 0; p < n_cells; ++p) acc[p * B + threadIdx.x] = 0.0f;
  const ParamCol g{acc + threadIdx.x, seed, B};
  const SmemMats sm{tab};

  const int i = blockIdx.x * B + threadIdx.x;
  int bad = 0;
  if (i < n) {
    const TracedCamParams unused{0.0f, 0.0f};
    const CameraRayT<float> r = lane_ray(cp, unused, nullptr, h0, sample0, lane0 + i);
    Recorder<typename StateOf<kLayout>::type> rec;
    rec.st.bind(scratch + i, (size_t)n);
    const PathOut o = trace_recorded(prims, meta, sm, mat_meta, pp, r, rec);
    const float c[3] = {cot[i], cot[(size_t)n + i], cot[2 * (size_t)n + i]};
    float cs[3], cd[3];
    sweep(prims, meta, sm, mat_meta, pp, r.hs, rec, o, c, g, cs, cd);
    bad = finish_column(g, n_cells);
  }
  block_columns(acc, n_cells, partial);
  block_ints(bad, 0, warp_int, int_partial);
}

// Kernel 10, sweep route: grad_backward_kernel with the record of each
// lane read from kernel 9's (grad_forward_kernel<1> over the same lanes,
// a RecordStore) instead of traced again.  The same block, grid,
// table, sweep, columns and reduction, so the same gradient bit for bit.
__global__ void __launch_bounds__(kAdjBlock, kSweepMinBlocks)
grad_sweep_kernel(const float* __restrict__ prims, const int* __restrict__ meta,
                  const float* __restrict__ mats, const int* __restrict__ mat_meta,
                  const PathParams pp, const CamParams cp, const float* __restrict__ pvec,
                  const int* __restrict__ cells, int n_cells, uint32_t h0, int sample0,
                  int lane0, int n, const float* __restrict__ cot,
                  const float* __restrict__ record, float* __restrict__ partial,
                  int* __restrict__ int_partial) {
  extern __shared__ float smem[];
  __shared__ int warp_int[2 * kAdjWarps];
  const int B = blockDim.x;
  const int cells_total = pp.n_mats * kMatStride;
  float* tab = smem;
  int* seed = reinterpret_cast<int*>(smem + cells_total);
  float* acc = smem + 2 * cells_total;
  load_table(tab, seed, mats, pp.n_mats, pvec, cells, n_cells);
  for (int p = 0; p < n_cells; ++p) acc[p * B + threadIdx.x] = 0.0f;
  const ParamCol g{acc + threadIdx.x, seed, B};
  const SmemMats sm{tab};

  const int i = blockIdx.x * B + threadIdx.x;
  int bad = 0;
  if (i < n) {
    Recorder<RecordView> rec;
    rec.st.bind(record + 4 * (size_t)i, (size_t)n);
    const PathOut o = get_tail(rec, pp.depth);
    const uint32_t hs = camera_ray(cp, h0, sample0, lane0 + i).hs;
    const float c[3] = {cot[i], cot[(size_t)n + i], cot[2 * (size_t)n + i]};
    float cs[3], cd[3];
    sweep(prims, meta, sm, mat_meta, pp, hs, rec, o, c, g, cs, cd);
    bad = finish_column(g, n_cells);
  }
  block_columns(acc, n_cells, partial);
  block_ints(bad, 0, warp_int, int_partial);
}

// Kernel 8, whole chain: per lane the two buffers, the lane loss
// sum_c (a_c - t_c)(b_c - t_c) and the adjoint of both (cotangent b - t
// into A, a - t into B; with use_camera, through the traced raygen too);
// partial [1 + P][blocks] (loss, gradient), int_partial [2][blocks]
// (segments of both buffers, bad lanes).  A's and B's records are both
// kept (layout 1: scratch holds [2][depth][10][n]).
template <int kLayout>
__global__ void __launch_bounds__(kAdjBlock)
fused_loss_chain_kernel(const float* __restrict__ prims, const int* __restrict__ meta,
                        const float* __restrict__ mats, const int* __restrict__ mat_meta,
                        const PathParams pp, const CamParams cp, const TracedCamParams tp,
                        const float* __restrict__ pvec, const int* __restrict__ cells,
                        int n_cells, int P, int use_camera, uint32_t h0, int sample0_a,
                        int sample0_b, int lane0, int n, const float* __restrict__ target,
                        float* __restrict__ scratch, float* __restrict__ partial,
                        int* __restrict__ int_partial) {
  using Store = typename StateOf<kLayout>::type;
  extern __shared__ float smem[];
  __shared__ int warp_int[2 * kAdjWarps];
  const int B = blockDim.x;
  const int Q = 1 + P;
  const int cells_total = pp.n_mats * kMatStride;
  float* tab = smem;
  int* seed = reinterpret_cast<int*>(smem + cells_total);
  float* acc = smem + 2 * cells_total;  // row 0: the lane loss; rows 1..P: gradient
  load_table(tab, seed, mats, pp.n_mats, pvec, cells, n_cells);
  for (int q = 0; q < Q; ++q) acc[q * B + threadIdx.x] = 0.0f;
  const ParamCol g{acc + B + threadIdx.x, seed, B};
  const SmemMats sm{tab};

  const int i = blockIdx.x * B + threadIdx.x;
  int segs = 0, bad = 0;
  if (i < n) {
    // The target pixel of this lane (band-local lane order pixel-major).
    const float* tgt = target + 3 * (i / cp.spp);
    const float* cv = use_camera ? pvec + n_cells : nullptr;
    const int flat = lane0 + i;
    const CameraRayT<float> ray_a = lane_ray(cp, tp, cv, h0, sample0_a, flat);
    const CameraRayT<float> ray_b = lane_ray(cp, tp, cv, h0, sample0_b, flat);
    const size_t plane = (size_t)pp.depth * kStateWords * n;
    float ra[3], rb[3], cs[3], cd[3];
    Recorder<Store> rec_a, rec_b;
    rec_a.st.bind(scratch + i, (size_t)n);
    rec_b.st.bind(scratch + plane + i, (size_t)n);
    const PathOut oa = trace_recorded(prims, meta, sm, mat_meta, pp, ray_a, rec_a);
    const PathOut ob = trace_recorded(prims, meta, sm, mat_meta, pp, ray_b, rec_b);
    for (int k = 0; k < 3; ++k) {
      ra[k] = oa.L[k] - tgt[k];
      rb[k] = ob.L[k] - tgt[k];
    }
    segs = oa.segcnt + ob.segcnt;
    sweep(prims, meta, sm, mat_meta, pp, ray_a.hs, rec_a, oa, rb, g, cs, cd);
    if (cv) camera_adj(cp, tp, cv, h0, sample0_a, flat, cs, cd, g, n_cells);
    sweep(prims, meta, sm, mat_meta, pp, ray_b.hs, rec_b, ob, ra, g, cs, cd);
    if (cv) camera_adj(cp, tp, cv, h0, sample0_b, flat, cs, cd, g, n_cells);
    acc[threadIdx.x] = ra[0] * rb[0] + ra[1] * rb[1] + ra[2] * rb[2];
    bad = finish_column(g, P);
  }
  block_columns(acc, Q, partial);
  block_ints(segs, bad, warp_int, int_partial);
}

// A launch of the reverse kernels: its block (128 threads, or 64 or 32
// where rows columns of 128 do not fit beside the table) and the floats of
// device scratch a lane's record takes per buffer (0: the per-thread
// record holds the depth).  False where no block fits.
struct ReversePlan {
  int block;
  int scratch_words;
};

inline bool plan_reverse(int n_mats, int rows, int depth, ReversePlan& plan) {
  if (n_mats > kMaxAdjMats || rows < 0 || depth < 0) return false;
  plan.scratch_words = depth <= kMaxAdjDepth ? 0 : depth * kStateWords;
  plan.block = column_block(reverse_smem(n_mats, 0, 0), reverse_smem(0, rows, 1));
  return plan.block > 0;
}

// Kernel 9's resident blocks a variant (record or not), device and table
// size: 0 not yet computed.
static int resident_blocks[2][64][kMaxAdjMats + 1];

// The grid of a kernel-9 launch over n lanes with a table of n_mats rows:
// the card's resident blocks (occupancy at the table's shared memory times
// the SMs, computed once a variant, device and table size), or fewer where
// the band has fewer chunks than the grid has warps; -1 where CUDA fails.
int forward_grid(int n_mats, int n, bool record) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return -1;
  int& resident = resident_blocks[record][dev][n_mats];
  if (resident == 0) {
    int per_sm = 0, sms = 0;
    const size_t smem = sizeof(float) * n_mats * kMatStride;
    auto* kernel = record ? grad_forward_kernel<1> : grad_forward_kernel<0>;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kAdjBlock, smem)
            != cudaSuccess
        || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess
        || per_sm * sms <= 0)
      return -1;
    resident = per_sm * sms;
  }
  const int wanted = blocks_for((n + 31) / 32, kAdjWarps);
  return wanted < resident ? wanted : resident;
}

}  // namespace fspt

extern "C" {

// radiance: [3, n] float; segcnt: [n] int; record: [pp.depth·3 + 1, n, 4]
// float for kernel 10's sweep route (fspt_grad_sweep), or null.
int fspt_grad_forward(const float* prims, const int* meta, const float* mats,
                      const int* mat_meta, fspt::PathParams pp, fspt::CamParams cp,
                      const float* pvec, const int* cells, int n_cells, unsigned int h0,
                      int sample0, int lane0, int n, float* radiance, int* segcnt,
                      float* record, void* stream) {
  using namespace fspt;
  if (int err = check_mats(pp)) return err;
  if (n <= 0) return 0;
  const int grid = forward_grid(pp.n_mats, n, record != nullptr);
  if (grid <= 0) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = sizeof(float) * pp.n_mats * kMatStride;
  auto* kernel = record ? grad_forward_kernel<1> : grad_forward_kernel<0>;
  kernel<<<grid, kAdjBlock, smem, (cudaStream_t)stream>>>(
      prims, meta, mats, mat_meta, pp, cp, pvec, cells, n_cells, h0, sample0, lane0, n,
      radiance, segcnt, record);
  return (int)cudaGetLastError();
}

// Kernel 9's launch for n lanes over n_mats table rows (the launcher's):
// *grid blocks of 128 threads, and *refill, the idle threads of a warp at
// which it takes new lanes.  Returns cudaErrorInvalidValue past
// kMaxAdjMats rows.
int fspt_grad_forward_plan(int n_mats, int n, int* grid, int* refill) {
  using namespace fspt;
  if (n_mats > kMaxAdjMats || n_mats < 0) return (int)cudaErrorInvalidValue;
  *grid = n > 0 ? forward_grid(n_mats, n, false) : 0;
  *refill = kFwdRefill;
  return *grid < 0 ? (int)cudaErrorInvalidConfiguration : 0;
}

// The launch plan of the reverse kernels for n_mats table rows, rows
// gradient rows (fspt_grad_backward: n_cells; fspt_fused_loss_chain:
// 1 + P) and depth bounces: *block, the threads of a block, and
// *scratch_words, the floats of device scratch a lane's record takes per
// buffer (0: none).  Returns cudaErrorInvalidValue where the table or the
// gradient rows do not fit in shared memory.
int fspt_adjoint_plan(int n_mats, int rows, int depth, int* block, int* scratch_words) {
  fspt::ReversePlan plan;
  if (!fspt::plan_reverse(n_mats, rows, depth, plan)) return (int)cudaErrorInvalidValue;
  *block = plan.block;
  *scratch_words = plan.scratch_words;
  return 0;
}

// cot: [3, n] float; scratch: [scratch_words, n] float where the plan asks
// for it, else null; partial: [n_cells, blocks] float and int_partial
// [2, blocks] int scratch, blocks = ceil(n / block) (fspt_adjoint_plan);
// out: [n_cells] double; int_out: [2] int64 (0, lanes with a zeroed
// non-finite entry).
int fspt_grad_backward(const float* prims, const int* meta, const float* mats,
                       const int* mat_meta, fspt::PathParams pp, fspt::CamParams cp,
                       const float* pvec, const int* cells, int n_cells, unsigned int h0,
                       int sample0, int lane0, int n, const float* cot, float* scratch,
                       float* partial, int* int_partial, double* out, long long* int_out,
                       void* stream) {
  using namespace fspt;
  ReversePlan plan;
  if (!plan_reverse(pp.n_mats, n_cells, pp.depth, plan)
      || (plan.scratch_words > 0 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n <= 0 || n_cells <= 0) return 0;
  const int blocks = blocks_for(n, plan.block);
  const size_t smem = reverse_smem(pp.n_mats, n_cells, plan.block);
  cudaStream_t st = (cudaStream_t)stream;
  auto* kernel = plan.scratch_words == 0 ? grad_backward_kernel<0> : grad_backward_kernel<1>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, plan.block, smem, st>>>(prims, meta, mats, mat_meta, pp, cp, pvec, cells,
                                           n_cells, h0, sample0, lane0, n, cot, scratch,
                                           partial, int_partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  adjoint_reduce<<<n_cells + 2, kReduceBlock, 0, st>>>(partial, int_partial, blocks,
                                                       n_cells, out, int_out);
  return (int)cudaGetLastError();
}

// Kernel 10's sweep route: as fspt_grad_backward, with record, kernel 9's
// record of the same lanes ([pp.depth·3 + 1, n, 4] float, fspt_grad_forward),
// in place of scratch.
int fspt_grad_sweep(const float* prims, const int* meta, const float* mats,
                    const int* mat_meta, fspt::PathParams pp, fspt::CamParams cp,
                    const float* pvec, const int* cells, int n_cells, unsigned int h0,
                    int sample0, int lane0, int n, const float* cot, const float* record,
                    float* partial, int* int_partial, double* out, long long* int_out,
                    void* stream) {
  using namespace fspt;
  ReversePlan plan;
  if (!plan_reverse(pp.n_mats, n_cells, pp.depth, plan) || record == nullptr)
    return (int)cudaErrorInvalidValue;
  if (n <= 0 || n_cells <= 0) return 0;
  const int blocks = blocks_for(n, plan.block);
  const size_t smem = reverse_smem(pp.n_mats, n_cells, plan.block);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = allow_smem(grad_sweep_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  grad_sweep_kernel<<<blocks, plan.block, smem, st>>>(prims, meta, mats, mat_meta, pp, cp,
                                                      pvec, cells, n_cells, h0, sample0,
                                                      lane0, n, cot, record, partial,
                                                      int_partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  adjoint_reduce<<<n_cells + 2, kReduceBlock, 0, st>>>(partial, int_partial, blocks,
                                                       n_cells, out, int_out);
  return (int)cudaGetLastError();
}

// n_cells material parameters, then (use_camera) the 9 camera values:
// P = n_cells + 9·use_camera.  target: [n / spp, 3]; scratch: [2,
// scratch_words, n] float where the plan asks for it, else null; partial
// [1 + P, blocks] float and int_partial [2, blocks] int scratch, blocks as
// fspt_grad_backward; out: [1 + P] double (loss, gradient); int_out: [2]
// int64 (segments, bad lanes).
int fspt_fused_loss_chain(const float* prims, const int* meta, const float* mats,
                          const int* mat_meta, fspt::PathParams pp, fspt::CamParams cp,
                          fspt::TracedCamParams tp, const float* pvec, const int* cells,
                          int n_cells, int use_camera, unsigned int h0, int sample0_a,
                          int sample0_b, int lane0, int n, const float* target, float* scratch,
                          float* partial, int* int_partial, double* out, long long* int_out,
                          void* stream) {
  using namespace fspt;
  const int P = n_cells + (use_camera ? 9 : 0);
  ReversePlan plan;
  if (!plan_reverse(pp.n_mats, 1 + P, pp.depth, plan)
      || (plan.scratch_words > 0 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n <= 0 || P <= 0) return 0;
  const int blocks = blocks_for(n, plan.block);
  const size_t smem = reverse_smem(pp.n_mats, 1 + P, plan.block);
  cudaStream_t st = (cudaStream_t)stream;
  auto* kernel = plan.scratch_words == 0 ? fused_loss_chain_kernel<0>
                                         : fused_loss_chain_kernel<1>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, plan.block, smem, st>>>(prims, meta, mats, mat_meta, pp, cp, tp, pvec,
                                           cells, n_cells, P, use_camera, h0, sample0_a,
                                           sample0_b, lane0, n, target, scratch, partial,
                                           int_partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  adjoint_reduce<<<1 + P + 2, kReduceBlock, 0, st>>>(partial, int_partial, blocks, 1 + P,
                                                     out, int_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
