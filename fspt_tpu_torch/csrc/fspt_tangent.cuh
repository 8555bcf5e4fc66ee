// Number-type hooks of the path body (csrc/fspt_kernels.cuh), on float:
// val(x) is the value a comparison or a branch reads, and the math calls go
// through these names so that the body is written once for its number
// type T (float on every kernel).
#pragma once

#include <cuda_runtime.h>

namespace fspt {

__device__ __forceinline__ float val(float x) { return x; }
__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
__device__ __forceinline__ float rsqrt_(float x) { return rsqrtf(x); }
__device__ __forceinline__ float sin_(float x) { return sinf(x); }
__device__ __forceinline__ float cos_(float x) { return cosf(x); }
__device__ __forceinline__ float tan_(float x) { return tanf(x); }
__device__ __forceinline__ float fmax_(float x, float c) { return fmaxf(x, c); }
__device__ __forceinline__ float fmin_(float x, float c) { return fminf(x, c); }

}  // namespace fspt
