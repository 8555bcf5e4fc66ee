// A host stand-in for the CUDA runtime header, for
// tests/test_torch_host_kernels.py: it
// lets g++ compile the port's kernel sources as host code, so that their
// arithmetic and control flow can be run on the CPU beside the plain
// versions.  A launch runs every thread of the grid in turn, twice (a
// block's shared staging is complete on the second pass: there are no
// real barriers); warp intrinsics are single-thread stand-ins.
#pragma once
#include <cmath>
#include <cstdint>
#include <cstddef>
#include <algorithm>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __shared__
#define __constant__ static
#define __grid_constant__
#define __launch_bounds__(...)
#define __restrict__ __restrict
struct float4 { float x, y, z, w; };
struct float2 { float x, y; };
struct int2 { int x, y; };
struct int4 { int x, y, z, w; };
struct uint3 { unsigned x, y, z; };
struct dim3 { unsigned x = 1, y = 1, z = 1; };
extern uint3 threadIdx, blockIdx; extern dim3 blockDim, gridDim;
typedef int cudaError_t; typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidConfiguration = 9,
       cudaDevAttrMultiProcessorCount = 16, cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
typedef int cudaDeviceAttr; typedef int cudaFuncAttribute;
inline cudaError_t cudaGetLastError() { return 0; }
inline cudaError_t cudaGetDevice(int*) { return 0; }
inline cudaError_t cudaDeviceGetAttribute(int*, int, int) { return 0; }
template <class F> cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int*, F, int, size_t) { return 0; }
template <class F> cudaError_t cudaFuncSetAttribute(F, int, int) { return 0; }
template <class T> T __ldg(const T* p) { return *p; }
inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }
inline float __fdividef(float a, float b) { return a / b; }
inline unsigned __ballot_sync(unsigned, bool b) { return b; }
inline unsigned __activemask() { return 1; }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(int x) { return __builtin_ffs(x); }
inline unsigned __match_any_sync(unsigned, int) { return 1; }
template <class T> T __shfl_sync(unsigned, T v, int, int = 32) { return v; }
template <class T> T __shfl_down_sync(unsigned, T v, int, int = 32) { return v; }
template <class T> T __shfl_xor_sync(unsigned, T v, int, int = 32) { return v; }
inline void __syncthreads() {}
inline void __syncwarp(unsigned = 0xffffffffu) {}
inline long long clock64() { return 0; }
inline int atomicAdd(int* p, int v) { int o = *p; *p += v; return o; }
inline unsigned long long atomicAdd(unsigned long long* p, unsigned long long v) { auto o = *p; *p += v; return o; }
inline double atomicAdd(double* p, double v) { double o = *p; *p += v; return o; }
inline float atomicAdd(float* p, float v) { float o = *p; *p += v; return o; }
using std::min; using std::max;
inline float fminf(float a, float b) { return std::fmin(a, b); }
inline float fmaxf(float a, float b) { return std::fmax(a, b); }
template <class S> cudaError_t cudaMemcpyFromSymbol(void*, const S&, size_t, size_t = 0, int = 0) { return 0; }
template <class S> cudaError_t cudaMemcpyToSymbol(const S&, const void*, size_t, size_t = 0, int = 0) { return 0; }
inline float __int_as_float(int i) { float f; __builtin_memcpy(&f, &i, 4); return f; }
inline int __float_as_int(float f) { int i; __builtin_memcpy(&i, &f, 4); return i; }
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline int2 make_int2(int a, int b) { return {a, b}; }
inline size_t __cvta_generic_to_shared(const void*) { return 0; }
using std::isfinite;
inline cudaError_t cudaMemsetAsync(void*, int, size_t, cudaStream_t = 0) { return 0; }
inline cudaError_t cudaDeviceSynchronize() { return 0; }
void shim_reset();  // clears the emulated shared memory (host_build.py)
// Host emulation of a launch: every block and thread of the grid in turn
// (no __syncthreads semantics: only for kernels without block barriers).
template <class K>
auto host_launch(K k, int grid, int block, size_t = 0, void* = nullptr) {
  return [=](auto... args) {
    gridDim.x = grid; blockDim.x = block;
    shim_reset();
    // Twice: a block's shared staging is complete on the second pass.
    for (int pass = 0; pass < 2; ++pass)
    for (int b = 0; b < grid; ++b)
      for (int t = 0; t < block; ++t) { blockIdx.x = b; threadIdx.x = t; k(args...); }
  };
}
