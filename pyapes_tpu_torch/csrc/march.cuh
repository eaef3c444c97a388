// Shared helpers of the port's 2.5-D plane-march kernels (csrc/jacobi3d.cu,
// csrc/diff_march.cu): asynchronous 16/8/4-byte global -> shared copies
// (cp.async), pair loads and stores, the staging of one plane's window
// into shared memory, and the host-side launch helpers (dynamic shared
// memory opt-in, argument checks).
#pragma once

#include "common.cuh"

namespace pyapes {

template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(gmem), "n"(BYTES));
  }
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Two adjacent values as one load / store (p aligned to the pair).
__device__ __forceinline__ void load2(const __nv_bfloat16* p, float& a, float& b) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
  a = __low2float(v);
  b = __high2float(v);
}
__device__ __forceinline__ void load2(const float* p, float& a, float& b) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  a = v.x;
  b = v.y;
}
__device__ __forceinline__ void load2(const double* p, double& a, double& b) {
  const double2 v = *reinterpret_cast<const double2*>(p);
  a = v.x;
  b = v.y;
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(double* p, double a, double b) {
  *reinterpret_cast<double2*>(p) = make_double2(a, b);
}

// Stage `rows` x `nch` copies of V elements (window row r0 + r, window
// columns from 0 in steps of V) of one plane (`src`: its first element)
// into dst, a window of W columns whose column h is global column kcol[h],
// in steps of the NT threads of a block: cp.async copies of V elements, or
// element loads where an element is less than the 4 bytes a copy takes
// (bf16 rows of odd length).
template <int V, int W, int NT, typename T>
__device__ __forceinline__ void stage_window(T* dst, const T* src, const int* rowoff,
                                             const int* kcol, int rows, int nch, int r0, int t) {
  const int n = rows * nch;
  for (int c = t; c < n; c += NT) {
    const int r = c / nch, h = c - r * nch;
    const T* s = src + rowoff[r0 + r] + kcol[h * V];
    T* d = dst + r * W + h * V;
    if constexpr (V * sizeof(T) >= 4) {
      cp_async<V * int(sizeof(T))>(d, s);
    } else {
      *d = *s;
    }
  }
}

// Opt `kernel` in to `smem` bytes of dynamic shared memory where that
// exceeds 48 KB, once per device (`done`: its bit per device).
template <typename K>
cudaError_t opt_in_smem(K* kernel, size_t smem, unsigned& done) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 32 && (done >> dev & 1u)) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess && dev < 32) done |= 1u << dev;
  return e;
}

// The plane-march launches' common argument checks: ci planes per block,
// a plane's offsets in an int, cw bytes per staging copy.
template <typename T>
bool march_args_ok(const int* n, int ci, int cw) {
  return ci >= 1 && (int64_t)n[1] * n[2] <= INT32_MAX &&
         (cw == 0 || ((cw == 4 || cw == 8 || cw == 16) && cw >= (int)sizeof(T)));
}

}  // namespace pyapes
