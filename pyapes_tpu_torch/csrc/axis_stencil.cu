// Per-axis 3-point stencil apply for Hopper (sm_90a), summed over mesh axes:
//
//   out[d, i, j, k] = sum_a  ap_a[i_a] * x[.., i_a + 1 mod n_a, ..]
//                          + ac_a[i_a] * x[.., i_a, ..]
//                          + am_a[i_a] * x[.., i_a - 1 mod n_a, ..]
//
// for x of shape (vdim, n_0[, n_1[, n_2]]), C-contiguous, bf16, f32 or f64
// (bf16 storage computes in f32 and rounds once on store). Replaces the
// Pallas TPU kernels pallas_stencil.py::pallas_axis_stencil,
// pallas_stencil_db.py::pallas_axis_stencil_db and
// pallas_stencil_v3.py::pallas_axis_stencil_v3 (one function, three TPU
// tilings).
//
// axis_stencil_dot_kernel (3-D, the CG alpha-dot) also writes one partial
// sum(x * A x) per block, from the unrounded A x; the wrapper sums the
// partials in a fixed order. Replaces pallas_stencil_db.py::
// pallas_axis_stencil_dot and pallas_stencil_v3.py::pallas_axis_stencil_dot_v3.
//
// The Python wrapper and the design note are in ops/axis_stencil.py.
// Plain C interface, loaded with ctypes.

#include "common.cuh"

namespace {

using pyapes::Compute;
using pyapes::store;
using pyapes::to_c;

constexpr int kThreads = 128;

template <typename T>
struct AxisCoeffs {
  const T* ap[3];
  const T* ac[3];
  const T* am[3];
};

// The stencil at one point of the grid viewed as (vdim * N0, N1, N2) with
// the mesh axes the LAST ndim of (N0, N1, N2); a missing leading axis has
// extent 1 and no stencil. Mesh axes summed in order 0, 1, 2 — the
// summation order of the plain version. Neighbour rows and planes are
// re-read through L1/L2; the torus wrap is index arithmetic.
template <typename T, int NDIM>
__device__ __forceinline__ typename Compute<T>::type stencil_at(
    const T* __restrict__ x, const AxisCoeffs<T>& c, int N0, int N1, int N2,
    int slab, int j, int k, int64_t p) {
  using C = typename Compute<T>::type;
  const int64_t plane = (int64_t)N1 * N2;
  const C xc = to_c(x[p]);
  C acc = C(0);
  if constexpr (NDIM == 3) {
    const int i = slab % N0;
    const int ip = (i + 1 == N0) ? 0 : i + 1;
    const int im = (i == 0) ? N0 - 1 : i - 1;
    acc = to_c(c.ap[0][i]) * to_c(x[p + (int64_t)(ip - i) * plane]) + to_c(c.ac[0][i]) * xc +
          to_c(c.am[0][i]) * to_c(x[p + (int64_t)(im - i) * plane]);
  }
  if constexpr (NDIM >= 2) {
    constexpr int a = NDIM - 2;
    const int jp = (j + 1 == N1) ? 0 : j + 1;
    const int jm = (j == 0) ? N1 - 1 : j - 1;
    acc += to_c(c.ap[a][j]) * to_c(x[p + (int64_t)(jp - j) * N2]) + to_c(c.ac[a][j]) * xc +
           to_c(c.am[a][j]) * to_c(x[p + (int64_t)(jm - j) * N2]);
  }
  {
    constexpr int a = NDIM - 1;
    const int kp = (k + 1 == N2) ? 0 : k + 1;
    const int km = (k == 0) ? N2 - 1 : k - 1;
    acc += to_c(c.ap[a][k]) * to_c(x[p + (kp - k)]) + to_c(c.ac[a][k]) * xc +
           to_c(c.am[a][k]) * to_c(x[p + (km - k)]);
  }
  return acc;
}

// One thread per output point, the last axis along threadIdx.x so that
// neighbouring threads touch neighbouring addresses.
template <typename T, int NDIM>
__global__ void __launch_bounds__(kThreads)
axis_stencil_kernel(const T* __restrict__ x, T* __restrict__ out,
                    AxisCoeffs<T> c, int N0, int N1, int N2) {
  const int k = blockIdx.x * kThreads + threadIdx.x;
  if (k >= N2) return;
  const int j = blockIdx.y;
  const int slab = blockIdx.z;  // component * N0 + i
  const int64_t p = ((int64_t)slab * N1 + j) * N2 + k;
  store(&out[p], stencil_at<T, NDIM>(x, c, N0, N1, N2, slab, j, k, p));
}

// As axis_stencil_kernel (3-D) plus one partial sum(x * A x) per block at
// partial[(blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x]:
// the partials of component d are contiguous.
template <typename T>
__global__ void __launch_bounds__(kThreads)
axis_stencil_dot_kernel(const T* __restrict__ x, T* __restrict__ out,
                        typename Compute<T>::type* __restrict__ partial,
                        AxisCoeffs<T> c, int N0, int N1, int N2) {
  using C = typename Compute<T>::type;
  const int k = blockIdx.x * kThreads + threadIdx.x;
  const int j = blockIdx.y;
  const int slab = blockIdx.z;
  C prod = C(0);
  if (k < N2) {
    const int64_t p = ((int64_t)slab * N1 + j) * N2 + k;
    const C acc = stencil_at<T, 3>(x, c, N0, N1, N2, slab, j, k, p);
    store(&out[p], acc);
    prod = to_c(x[p]) * acc;
  }
  const C s = pyapes::block_sum<kThreads>(prod);
  if (threadIdx.x == 0) {
    partial[((int64_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] = s;
  }
}

template <typename T>
AxisCoeffs<T> make_coeffs(const void* const* coeffs) {
  AxisCoeffs<T> c;
  for (int a = 0; a < 3; ++a) {
    c.ap[a] = static_cast<const T*>(coeffs[3 * a + 0]);
    c.ac[a] = static_cast<const T*>(coeffs[3 * a + 1]);
    c.am[a] = static_cast<const T*>(coeffs[3 * a + 2]);
  }
  return c;
}

template <int NDIM>
dim3 grid_of(int vdim, const int* n, int* N) {
  N[0] = NDIM == 3 ? n[0] : 1;
  N[1] = NDIM >= 2 ? n[NDIM - 2] : 1;
  N[2] = n[NDIM - 1];
  return dim3((N[2] + kThreads - 1) / kThreads, N[1], vdim * N[0]);
}

template <typename T, int NDIM>
cudaError_t launch(const void* x, void* out, void* partial,
                   const void* const* coeffs, int vdim, const int* n,
                   cudaStream_t stream) {
  int N[3];
  const dim3 grid = grid_of<NDIM>(vdim, n, N);
  const AxisCoeffs<T> c = make_coeffs<T>(coeffs);
  if (partial != nullptr) {
    if constexpr (NDIM == 3) {
      axis_stencil_dot_kernel<T><<<grid, kThreads, 0, stream>>>(
          static_cast<const T*>(x), static_cast<T*>(out),
          static_cast<typename Compute<T>::type*>(partial), c, N[0], N[1], N[2]);
    } else {
      return cudaErrorInvalidValue;
    }
  } else {
    axis_stencil_kernel<T, NDIM><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(out), c, N[0], N[1], N[2]);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int ndim, const void* x, void* out, void* partial,
                     const void* const* coeffs, int vdim, const int* n,
                     cudaStream_t stream) {
  switch (ndim) {
    case 1: return launch<T, 1>(x, out, partial, coeffs, vdim, n, stream);
    case 2: return launch<T, 2>(x, out, partial, coeffs, vdim, n, stream);
    case 3: return launch<T, 3>(x, out, partial, coeffs, vdim, n, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t run(int dtype, int ndim, int vdim, const int* n, const void* x,
                void* out, void* partial, const void* const* coeffs,
                cudaStream_t s) {
  if (dtype == 0) return dispatch<float>(ndim, x, out, partial, coeffs, vdim, n, s);
  if (dtype == 1) return dispatch<double>(ndim, x, out, partial, coeffs, vdim, n, s);
  if (dtype == 2) return dispatch<__nv_bfloat16>(ndim, x, out, partial, coeffs, vdim, n, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = float64, 2 = bfloat16. n0..n2: mesh extents
// (unused trailing ones ignored). coeffs: 9 device pointers (ap, ac, am)
// per mesh axis, in x's dtype. Returns cudaGetLastError() after the launch
// (0 on success). Launches on `stream`; does not synchronise and
// allocates nothing.
int pyapes_axis_stencil(int dtype, int ndim, int vdim, int n0, int n1, int n2,
                        const void* x, void* out, const void* const* coeffs,
                        void* stream) {
  const int n[3] = {n0, n1, n2};
  return run(dtype, ndim, vdim, n, x, out, nullptr, coeffs,
             static_cast<cudaStream_t>(stream));
}

// 3-D only. partial: one compute-dtype value (f32 for bf16/f32, f64 for
// f64) per block, (vdim * n0 * n1 * ceil(n2 / 128)) of them, component-major.
int pyapes_axis_stencil_dot(int dtype, int vdim, int n0, int n1, int n2,
                            const void* x, void* out, void* partial,
                            const void* const* coeffs, void* stream) {
  const int n[3] = {n0, n1, n2};
  return run(dtype, 3, vdim, n, x, out, partial, coeffs,
             static_cast<cudaStream_t>(stream));
}

}  // extern "C"
