// The per-axis 3-point stencil apply on 2-D grids as a row march on Hopper
// (sm_90a), the 2-D counterpart of csrc/axis_march.cu's plane march
// (ops/axis_stencil.py takes it for the radius-1 apply on 2-D grids of at
// least ROW_MIN_POINTS points per component, the per-point kernel of
// csrc/axis_stencil.cu below that):
//
//   out[d, i, k] = ap0[i] x[d, i+1, k] + ac0[i] x[d, i, k] + am0[i] x[d, i-1, k]
//                + ap1[k] x[d, i, k+1] + ac1[k] x[d, i, k] + am1[k] x[d, i, k-1]
//
// (indices mod n0, n1) for x of shape (vdim, n0, n1), C-contiguous, bf16,
// f32 or f64 (bf16 computes in f32 and rounds once on store). Replaces the
// 2-D call of pallas_stencil.py::pallas_axis_stencil (its pl.pallas_call of
// _stencil2d_kernel).
//
// What bounds it: 6 multiply-adds per point against 2 grids of compulsory
// traffic (read x, write out) would make it bytes-bound, but at the grids
// the paths run (the rz cell's 512 x 1024 f32, the 2D-2 channel's 441 x 83
// f64 and their MG levels, 0.1-4 MB, resident in the 50 MB L2) a call is
// the latency of the launch and of one round of dependent loads: the
// kernel has to issue all its loads at once and do little else.
//
// The design: a thread owns V consecutive columns of a chunk of CI rows (1,
// 2, 4 or 8; the wrapper picks CI so that the blocks still fill the SMs)
// of one component, and marches down them. V is 16 bytes of columns (4
// f32, 2 f64, 8 bf16) where the row length and x's and out's alignment
// allow 16-byte loads and stores, else one column. It loads the CI + 2 rows
// x(i0-1) .. x(i0+CI) of its columns, the wrapped column to the left and
// to the right of each of its CI rows and the coefficients (axis 1's as
// 16-byte loads where aligned), all before the first use, so they are in
// flight together; then each point takes x(i-1), x(i), x(i+1) and its
// axis-1 neighbours from registers. x is read once per chunk plus its two
// halo rows, the coefficients once per thread (axis 1 per column, axis 0
// per row), and the wraps are computed once per thread and row: no % per
// point. Threads run along a row's column groups, then the row chunks,
// then the components, in blocks of RM_THREADS.
//
// No shared memory: staging rows through a ring with one barrier per row
// (one column per thread) was slower than the per-point kernel at these
// grids (PERF.md §6, PR 20). Below ROW_MIN_POINTS (257^2 f32, the 441 x 83
// f64 channel and smaller) this kernel is too: there a call is one round
// of loads, and one point per thread has the shorter path.
//
// A point is the per-point kernel's arithmetic, rounding for rounding: per
// axis fma(am, x(-1), fma(ap, x(+1), ac * x)), then (0 + axis 0) + axis 1,
// the contraction nvcc gives stencil_at at NDIM = 2 in csrc/axis_stencil.cu
// (its sm_90a SASS), written here with explicit round-to-nearest
// intrinsics so that no contraction of this code can differ: the two
// kernels give the same bits (checked on the card), whatever the chunk.

#include "axis_march.cuh"

namespace pyapes {
namespace {

constexpr int RM_THREADS = 128;  // threads per block

__device__ __forceinline__ float rm_axis(float ap, float xp, float ac, float xc, float am,
                                         float xm) {
  return __fmaf_rn(am, xm, __fmaf_rn(ap, xp, __fmul_rn(ac, xc)));
}
__device__ __forceinline__ double rm_axis(double ap, double xp, double ac, double xc, double am,
                                          double xm) {
  return __fma_rn(am, xm, __fma_rn(ap, xp, __dmul_rn(ac, xc)));
}
__device__ __forceinline__ float rm_add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double rm_add(double a, double b) { return __dadd_rn(a, b); }

// V consecutive values: one 16-byte load or store when V > 1 (16 bytes,
// aligned), else one element
template <int V, typename T>
__device__ __forceinline__ void rm_load(T (&v)[V], const T* p) {
  if constexpr (V > 1) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    memcpy(v, &u, 16);
  } else {
    v[0] = *p;
  }
}
template <int V, typename T>
__device__ __forceinline__ void rm_store(T* p, const T (&v)[V]) {
  if constexpr (V > 1) {
    uint4 u;
    memcpy(&u, v, 16);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
    *p = v[0];
  }
}

template <typename T, int CI, int V>
__global__ void __launch_bounds__(RM_THREADS)
axis_row_march_kernel(const T* __restrict__ x, T* __restrict__ out, RowMarchParams<T> q) {
  using C = typename Compute<T>::type;
  const int n0 = q.n0, n1 = q.n1;
  const int groups = n1 / V, nch = (n0 + CI - 1) / CI;  // V divides n1
  const int item = blockIdx.x * RM_THREADS + threadIdx.x;  // 32-bit: the launch checks
  if (item >= q.vdim * nch * groups) return;
  const int rest = item / groups, g = item - rest * groups;
  const int d = rest / nch, c = rest - d * nch;
  const int k0 = g * V, i0 = c * CI, rows = min(CI, n0 - i0);
  const int kl = k0 == 0 ? n1 - 1 : k0 - 1;  // the wrapped columns beside this thread's
  const int kr = k0 + V == n1 ? 0 : k0 + V;
  const int64_t vol = (int64_t)n0 * n1;
  const T* xd = x + d * vol;
  T* od = out + d * vol;

  // every load first: rows i0-1 .. i0+rows of the columns (j = row - i0 + 1),
  // the halo columns of rows i0 .. i0+rows-1, the coefficients
  T xr[CI + 2][V], hl[CI], hr[CI];
#pragma unroll
  for (int j = 0; j < CI + 2; ++j) {
    if (j > rows + 1) break;
    const int p = i0 - 1 + j;
    const T* src = xd + (int64_t)(p < 0 ? p + n0 : (p >= n0 ? p - n0 : p)) * n1;
    rm_load<V>(xr[j], src + k0);
    if (j >= 1 && j <= rows) {
      hl[j - 1] = src[kl];
      hr[j - 1] = src[kr];
    }
  }
  T c1[3][V];  // axis 1 at this thread's columns: 16-byte loads where aligned
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    if (V > 1 && q.vc) {
      rm_load<V>(c1[m], q.c[1][m] + k0);
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) c1[m][k] = q.c[1][m][k0 + k];
    }
  }
  C c0[CI][3];  // axis 0 per row
#pragma unroll
  for (int j = 0; j < CI; ++j) {
#pragma unroll
    for (int m = 0; m < 3; ++m) c0[j][m] = j < rows ? to_c(q.c[0][m][i0 + j]) : C(0);
  }

  // the march down the chunk: row i0+j-1 from x(-1), x, x(+1) in registers
#pragma unroll
  for (int j = 1; j <= CI; ++j) {
    if (j > rows) break;
    T o[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const C xc = to_c(xr[j][k]);
      const C xl = to_c(k == 0 ? hl[j - 1] : xr[j][k - 1]);
      const C xrt = to_c(k + 1 < V ? xr[j][k + 1] : hr[j - 1]);
      const C a0 = rm_axis(c0[j - 1][0], to_c(xr[j + 1][k]), c0[j - 1][1], xc, c0[j - 1][2],
                           to_c(xr[j - 1][k]));
      const C a1 = rm_axis(to_c(c1[0][k]), xrt, to_c(c1[1][k]), xc, to_c(c1[2][k]), xl);
      store(&o[k], rm_add(rm_add(C(0), a0), a1));
    }
    rm_store<V>(od + (int64_t)(i0 + j - 1) * n1 + k0, o);
  }
}

template <typename T, int CI, int V>
cudaError_t rm_launch(const RowMarchParams<T>& q, const void* x, void* out, cudaStream_t s) {
  const int64_t items = (int64_t)q.vdim * ((q.n0 + CI - 1) / CI) * (q.n1 / V);
  const int64_t blocks = (items + RM_THREADS - 1) / RM_THREADS;
  if (blocks * RM_THREADS > INT32_MAX) return cudaErrorInvalidValue;  // a thread's index is an int
  axis_row_march_kernel<T, CI, V><<<unsigned(blocks), RM_THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(out), q);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t rm_dispatch(const RowMarchParams<T>& q, const void* x, void* out, cudaStream_t s) {
  switch (q.ci) {
    case 1: return rm_launch<T, 1, V>(q, x, out, s);
    case 2: return rm_launch<T, 2, V>(q, x, out, s);
    case 4: return rm_launch<T, 4, V>(q, x, out, s);
    case 8: return rm_launch<T, 8, V>(q, x, out, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

template <typename T>
cudaError_t axis_row_march_launch(const RowMarchParams<T>& q, const void* x, void* out,
                                  cudaStream_t s) {
  constexpr int V16 = 16 / int(sizeof(T));
  if (q.vdim < 1 || q.n0 < 3 || q.n1 < 3) return cudaErrorInvalidValue;
  if (q.v16 && q.n1 % V16 == 0) return rm_dispatch<T, V16>(q, x, out, s);
  return rm_dispatch<T, 1>(q, x, out, s);
}

template cudaError_t axis_row_march_launch<float>(const RowMarchParams<float>&, const void*,
                                                  void*, cudaStream_t);
template cudaError_t axis_row_march_launch<double>(const RowMarchParams<double>&, const void*,
                                                   void*, cudaStream_t);
template cudaError_t axis_row_march_launch<__nv_bfloat16>(const RowMarchParams<__nv_bfloat16>&,
                                                          const void*, void*, cudaStream_t);

}  // namespace pyapes
