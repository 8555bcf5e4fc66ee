// Number types of the path body (csrc/fspt_kernels.cuh): float, and the
// forward-mode tangent Tangent<K> of the witnesses (csrc/fspt_fwdmode.cu).
//
// A Tangent<K> is a value and its derivatives with respect to K parameters.
// Every operation computes the value part exactly as the float operation
// does (same operation, same operands, compiled with -fmad=false), so a body
// instantiated on Tangent<K> takes the same branches and reaches the same
// values as the float body, bit for bit; comparisons and branches read
// val(x) only.  The derivative parts follow the chain rule.  Where an input
// has a zero tangent the output's stays zero even where the local derivative
// is infinite (sqrt or rsqrt at 0), as reverse mode gives no gradient to a
// quantity that does not depend on the parameters.  Ties of fmax_/fmin_ pass
// the derivative of the first argument, as torch.clamp does.
#pragma once

#include <cuda_runtime.h>

namespace fspt {

// --- float: the operations of the plain kernels ----------------------------

__device__ __forceinline__ float val(float x) { return x; }
__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
__device__ __forceinline__ float rsqrt_(float x) { return rsqrtf(x); }
__device__ __forceinline__ float sin_(float x) { return sinf(x); }
__device__ __forceinline__ float cos_(float x) { return cosf(x); }
__device__ __forceinline__ float tan_(float x) { return tanf(x); }
__device__ __forceinline__ float fmax_(float x, float c) { return fmaxf(x, c); }
__device__ __forceinline__ float fmin_(float x, float c) { return fminf(x, c); }

// --- Tangent<K> -------------------------------------------------------------

template <int K>
struct Tangent {
  float v;
  float d[K];

  __device__ __forceinline__ Tangent() {}
  __device__ __forceinline__ Tangent(float x) : v(x) {
#pragma unroll
    for (int k = 0; k < K; ++k) d[k] = 0.0f;
  }
};

// The value x with derivative 1 in component k - p0 (no component when that
// is outside 0..K-1): parameter k of the pass that starts at parameter p0.
template <int K>
__device__ __forceinline__ Tangent<K> seeded(float x, int p, int p0) {
  Tangent<K> r;
  r.v = x;
  const int j = p - p0;
#pragma unroll
  for (int k = 0; k < K; ++k) r.d[k] = (k == j) ? 1.0f : 0.0f;
  return r;
}

template <int K>
__device__ __forceinline__ float val(const Tangent<K>& a) { return a.v; }

template <int K>
__device__ __forceinline__ Tangent<K> operator-(const Tangent<K>& a) {
  Tangent<K> r;
  r.v = -a.v;
#pragma unroll
  for (int k = 0; k < K; ++k) r.d[k] = -a.d[k];
  return r;
}

template <int K>
__device__ __forceinline__ Tangent<K> operator+(const Tangent<K>& a, const Tangent<K>& b) {
  Tangent<K> r;
  r.v = a.v + b.v;
#pragma unroll
  for (int k = 0; k < K; ++k) r.d[k] = a.d[k] + b.d[k];
  return r;
}

template <int K>
__device__ __forceinline__ Tangent<K> operator+(const Tangent<K>& a, float b) {
  Tangent<K> r = a;
  r.v = a.v + b;
  return r;
}

template <int K>
__device__ __forceinline__ Tangent<K> operator+(float a, const Tangent<K>& b) {
  Tangent<K> r = b;
  r.v = a + b.v;
  return r;
}

template <int K>
__device__ __forceinline__ Tangent<K> operator-(const Tangent<K>& a, const Tangent<K>& b) {
  Tangent<K> r;
  r.v = a.v - b.v;
#pragma unroll
  for (int k = 0; k < K; ++k) r.d[k] = a.d[k] - b.d[k];
  return r;
}

template <int K>
__device__ __forceinline__ Tangent<K> operator-(const Tangent<K>& a, float b) {
  Tangent<K> r = a;
  r.v = a.v - b;
  return r;
}

template <int K>
__device__ __forceinline__ Tangent<K> operator-(float a, const Tangent<K>& b) {
  Tangent<K> r;
  r.v = a - b.v;
#pragma unroll
  for (int k = 0; k < K; ++k) r.d[k] = -b.d[k];
  return r;
}

template <int K>
__device__ __forceinline__ Tangent<K> operator*(const Tangent<K>& a, const Tangent<K>& b) {
  Tangent<K> r;
  r.v = a.v * b.v;
#pragma unroll
  for (int k = 0; k < K; ++k) r.d[k] = a.d[k] * b.v + a.v * b.d[k];
  return r;
}

template <int K>
__device__ __forceinline__ Tangent<K> operator*(const Tangent<K>& a, float b) {
  Tangent<K> r;
  r.v = a.v * b;
#pragma unroll
  for (int k = 0; k < K; ++k) r.d[k] = a.d[k] * b;
  return r;
}

template <int K>
__device__ __forceinline__ Tangent<K> operator*(float a, const Tangent<K>& b) {
  Tangent<K> r;
  r.v = a * b.v;
#pragma unroll
  for (int k = 0; k < K; ++k) r.d[k] = a * b.d[k];
  return r;
}

template <int K>
__device__ __forceinline__ Tangent<K> operator/(const Tangent<K>& a, const Tangent<K>& b) {
  Tangent<K> r;
  r.v = a.v / b.v;
#pragma unroll
  for (int k = 0; k < K; ++k) r.d[k] = (a.d[k] - r.v * b.d[k]) / b.v;
  return r;
}

template <int K>
__device__ __forceinline__ Tangent<K> operator/(const Tangent<K>& a, float b) {
  Tangent<K> r;
  r.v = a.v / b;
#pragma unroll
  for (int k = 0; k < K; ++k) r.d[k] = a.d[k] / b;
  return r;
}

template <int K>
__device__ __forceinline__ Tangent<K> operator/(float a, const Tangent<K>& b) {
  Tangent<K> r;
  r.v = a / b.v;
#pragma unroll
  for (int k = 0; k < K; ++k) r.d[k] = -(r.v * b.d[k]) / b.v;
  return r;
}

// Applies the local derivative g to the tangent of a; a zero tangent stays
// zero whatever g is (inf at a root of 0, say).
template <int K>
__device__ __forceinline__ void chain(Tangent<K>& r, const Tangent<K>& a, float g) {
#pragma unroll
  for (int k = 0; k < K; ++k) r.d[k] = a.d[k] == 0.0f ? 0.0f : a.d[k] * g;
}

template <int K>
__device__ __forceinline__ Tangent<K> sqrt_(const Tangent<K>& a) {
  Tangent<K> r;
  r.v = sqrtf(a.v);
  chain(r, a, 0.5f / r.v);
  return r;
}

template <int K>
__device__ __forceinline__ Tangent<K> rsqrt_(const Tangent<K>& a) {
  Tangent<K> r;
  r.v = rsqrtf(a.v);
  chain(r, a, -0.5f * r.v / a.v);
  return r;
}

template <int K>
__device__ __forceinline__ Tangent<K> sin_(const Tangent<K>& a) {
  Tangent<K> r;
  r.v = sinf(a.v);
  chain(r, a, cosf(a.v));
  return r;
}

template <int K>
__device__ __forceinline__ Tangent<K> cos_(const Tangent<K>& a) {
  Tangent<K> r;
  r.v = cosf(a.v);
  chain(r, a, -sinf(a.v));
  return r;
}

template <int K>
__device__ __forceinline__ Tangent<K> tan_(const Tangent<K>& a) {
  Tangent<K> r;
  r.v = tanf(a.v);
  chain(r, a, 1.0f + r.v * r.v);
  return r;
}

template <int K>
__device__ __forceinline__ Tangent<K> fmax_(const Tangent<K>& a, float c) {
  return a.v >= c ? a : Tangent<K>(fmaxf(a.v, c));
}

template <int K>
__device__ __forceinline__ Tangent<K> fmin_(const Tangent<K>& a, float c) {
  return a.v <= c ? a : Tangent<K>(fminf(a.v, c));
}

// ns / ts with the derivative of ts floored at |ts| >= floor: the forward
// mode of the reference's _graze_div (pallas_trace.py:137-163) and of
// ops/cuda_trace.py _GrazeDiv.
template <int K>
__device__ __forceinline__ Tangent<K> graze_div(const Tangent<K>& ns, const Tangent<K>& ts,
                                                float floor) {
  Tangent<K> r;
  r.v = ns.v / ts.v;
  const float safe = (ts.v < 0.0f ? -1.0f : 1.0f) * fmaxf(fabsf(ts.v), floor);
#pragma unroll
  for (int k = 0; k < K; ++k) r.d[k] = ns.d[k] / safe - ns.v * ts.d[k] / (safe * safe);
  return r;
}

// sqrt(x) with the derivative's root floored at floor: the reference's
// _graze_sqrt (pallas_trace.py:166-183), ops/cuda_trace.py _GrazeSqrt.
template <int K>
__device__ __forceinline__ Tangent<K> graze_sqrt(const Tangent<K>& x, float floor) {
  Tangent<K> r;
  r.v = sqrtf(x.v);
  const float twice = 2.0f * fmaxf(r.v, floor);
#pragma unroll
  for (int k = 0; k < K; ++k) r.d[k] = x.d[k] / twice;
  return r;
}

}  // namespace fspt
