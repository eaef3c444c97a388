// Shared helpers of the port's Hopper kernels: storage <-> compute type
// conversion (bf16 storage computes in f32, f32 in f32, f64 in f64, as the
// JAX kernels' promote(dtype, f32)), wrap-around indexing, a deterministic
// block sum, and the C entry point that names a CUDA error code.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pyapes {

template <typename T> struct Compute { using type = T; };
template <> struct Compute<__nv_bfloat16> { using type = float; };

__device__ __forceinline__ float to_c(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_c(float v) { return v; }
__device__ __forceinline__ double to_c(double v) { return v; }

// Round once, on store (round-to-nearest-even, as torch's cast).
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(double* p, double v) { *p = v; }

// i mod n for any i (torus wrap of a halo or window index).
__device__ __forceinline__ int wrap(int i, int n) {
  i %= n;
  return i < 0 ? i + n : i;
}

// Sum of `v` over the NT threads of a 1-D block; the result is valid in
// thread 0. The order is fixed (shuffle tree, then warps in order), so a
// launch gives the same bits every run: no atomics.
template <int NT, typename C>
__device__ __forceinline__ C block_sum(C v) {
  static_assert(NT % 32 == 0, "block size must be a multiple of 32");
  __shared__ C warp_sums[NT / 32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  C s = C(0);
  if (threadIdx.x == 0) {
    for (int w = 0; w < NT / 32; ++w) s += warp_sums[w];
  }
  return s;
}

}  // namespace pyapes

// Weak: a library linked from several units, each including this header,
// keeps one.
extern "C" __attribute__((weak)) const char* pyapes_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
