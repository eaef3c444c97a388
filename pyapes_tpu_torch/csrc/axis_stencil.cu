// Per-axis 3-point stencil apply for Hopper (sm_90a), summed over mesh axes
// (this file: the per-point kernels and the C entries; the plane march that
// takes 3-D grids from the wrappers' threshold up, for the apply, the
// alpha-dot and the halo-extended apply, is csrc/axis_march.cu, the row
// march of the 2-D apply csrc/axis_march2d.cu):
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
// pallas_axis_stencil_dot and pallas_stencil_v3.py::pallas_axis_stencil_dot_v3
// on the grids the march does not take.
//
// axis_stencil5_kernel (1-3-D) adds the offsets +-2 of the 5-point (QUICK)
// axes: app_a x(+2) + ... + amm_a x(-2), a 3-point axis passed with null
// app/amm; replaces pallas_stencil_v3.py::pallas_axis_stencil_v5.
//
// axis_stencil_ext_kernel (3-D) is the apply on one block of a domain
// decomposition, extended by one ghost row on each side of axis 0 and/or 1
// (e0, e1 in {0, 1}; the last axis is never extended): on an extended axis
// the neighbour is the next row of the extended block (no wrap), on an
// unextended axis it wraps; the output (the unextended block) is written
// through strides, so a block lands straight in its view of the global
// result. Replaces pallas_stencil_v3.py::pallas_axis_stencil_ext on the
// blocks the march does not take.
//
// The apply, the 5-point apply and the alpha-dot launch through one entry,
// pyapes_axis_plan_launch, from a launch plan (AxisPlan) that the wrapper
// builds and checks once per operator: per call only x, out, the dot's
// partials and the stream cross the C interface.
//
// The Python wrapper and the design note are in ops/axis_stencil.py.
// Plain C interface, loaded with ctypes.

#include "axis_march.cuh"

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

// Per mesh axis (app, ap, ac, am, amm); app/amm null on a 3-point axis.
template <typename T>
struct AxisCoeffs5 {
  const T* c[3][5];
};

// The 5-point stencil: the grid viewed as in axis_stencil_kernel, mesh
// axis m on padded axis m + 3 - NDIM, offsets wrapped on the torus (any
// n >= 3: one correction reaches +-2).
template <typename T, int NDIM>
__global__ void __launch_bounds__(kThreads)
axis_stencil5_kernel(const T* __restrict__ x, T* __restrict__ out,
                     AxisCoeffs5<T> cf, int N0, int N1, int N2) {
  using C = typename Compute<T>::type;
  const int k = blockIdx.x * kThreads + threadIdx.x;
  if (k >= N2) return;
  const int j = blockIdx.y;
  const int slab = blockIdx.z;  // component * N0 + i
  const int64_t p = ((int64_t)slab * N1 + j) * N2 + k;
  const int idx[3] = {slab % N0, j, k};
  const int nn[3] = {N0, N1, N2};
  const int64_t stride[3] = {(int64_t)N1 * N2, (int64_t)N2, 1};
  const C xc = to_c(x[p]);
  C acc = C(0);
#pragma unroll
  for (int m = 0; m < NDIM; ++m) {
    const int a = m + 3 - NDIM;
    const int n = nn[a], i = idx[a];
    const int64_t s = stride[a];
    const int ip = (i + 1 == n) ? 0 : i + 1;
    const int im = (i == 0) ? n - 1 : i - 1;
    acc += to_c(cf.c[m][1][i]) * to_c(x[p + (int64_t)(ip - i) * s]) + to_c(cf.c[m][2][i]) * xc +
           to_c(cf.c[m][3][i]) * to_c(x[p + (int64_t)(im - i) * s]);
    if (cf.c[m][0] != nullptr) {
      const int ipp = (i + 2 >= n) ? i + 2 - n : i + 2;
      const int imm = (i < 2) ? i - 2 + n : i - 2;
      acc += to_c(cf.c[m][0][i]) * to_c(x[p + (int64_t)(ipp - i) * s]) +
             to_c(cf.c[m][4][i]) * to_c(x[p + (int64_t)(imm - i) * s]);
    }
  }
  store(&out[p], acc);
}

// The 3-point apply on a halo-extended block: x is (vdim, N0 + 2 e0,
// N1 + 2 e1, N2), C-contiguous; out element (d, i, j, k) sits at
// d * os_v + i * os0 + j * os1 + k. One thread per output point, the last
// axis along threadIdx.x; summed in the order of axis_stencil_kernel.
template <typename T>
__global__ void __launch_bounds__(kThreads)
axis_stencil_ext_kernel(const T* __restrict__ x, T* __restrict__ out, AxisCoeffs<T> c,
                        int N0, int N1, int N2, int e0, int e1,
                        int64_t os_v, int64_t os0, int64_t os1) {
  using C = typename Compute<T>::type;
  const int k = blockIdx.x * kThreads + threadIdx.x;
  if (k >= N2) return;
  const int j = blockIdx.y;
  const int d = blockIdx.z / N0;
  const int i = blockIdx.z - d * N0;
  const int E0 = N0 + 2 * e0, E1 = N1 + 2 * e1;
  const int64_t plane = (int64_t)E1 * N2;
  const int64_t p = ((int64_t)(d * E0 + i + e0) * E1 + j + e1) * N2 + k;
  const C xc = to_c(x[p]);
  // axis 0: the rows above and below in extended coordinates, or the wrap
  const int64_t up0 = (e0 || i + 1 < N0) ? plane : -(int64_t)(N0 - 1) * plane;
  const int64_t dn0 = (e0 || i > 0) ? -plane : (int64_t)(N0 - 1) * plane;
  C acc = to_c(c.ap[0][i]) * to_c(x[p + up0]) + to_c(c.ac[0][i]) * xc +
          to_c(c.am[0][i]) * to_c(x[p + dn0]);
  const int64_t up1 = (e1 || j + 1 < N1) ? N2 : -(int64_t)(N1 - 1) * N2;
  const int64_t dn1 = (e1 || j > 0) ? -(int64_t)N2 : (int64_t)(N1 - 1) * N2;
  acc += to_c(c.ap[1][j]) * to_c(x[p + up1]) + to_c(c.ac[1][j]) * xc +
         to_c(c.am[1][j]) * to_c(x[p + dn1]);
  const int kp = (k + 1 == N2) ? 0 : k + 1;
  const int km = (k == 0) ? N2 - 1 : k - 1;
  acc += to_c(c.ap[2][k]) * to_c(x[p + (kp - k)]) + to_c(c.ac[2][k]) * xc +
         to_c(c.am[2][k]) * to_c(x[p + (km - k)]);
  store(&out[d * os_v + i * os0 + (int64_t)j * os1 + k], acc);
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
cudaError_t dispatch(int ndim, const void* x, void* out, const void* const* coeffs, int vdim,
                     const int* n, cudaStream_t stream) {
  switch (ndim) {
    case 1: return launch<T, 1>(x, out, nullptr, coeffs, vdim, n, stream);
    case 2: return launch<T, 2>(x, out, nullptr, coeffs, vdim, n, stream);
    case 3: return launch<T, 3>(x, out, nullptr, coeffs, vdim, n, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int NDIM>
cudaError_t launch5(const void* x, void* out, const void* const* coeffs, int vdim,
                    const int* n, cudaStream_t stream) {
  int N[3];
  const dim3 grid = grid_of<NDIM>(vdim, n, N);
  AxisCoeffs5<T> c;
  for (int m = 0; m < 3; ++m)
    for (int t = 0; t < 5; ++t) c.c[m][t] = static_cast<const T*>(coeffs[5 * m + t]);
  axis_stencil5_kernel<T, NDIM><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), c, N[0], N[1], N[2]);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch5(int ndim, const void* x, void* out, const void* const* coeffs, int vdim,
                      const int* n, cudaStream_t s) {
  switch (ndim) {
    case 1: return launch5<T, 1>(x, out, coeffs, vdim, n, s);
    case 2: return launch5<T, 2>(x, out, coeffs, vdim, n, s);
    case 3: return launch5<T, 3>(x, out, coeffs, vdim, n, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_ext(const void* x, void* out, const void* const* coeffs, int vdim,
                       const int* n, int e0, int e1, int64_t os_v, int64_t os0, int64_t os1,
                       cudaStream_t stream) {
  const dim3 grid((n[2] + kThreads - 1) / kThreads, n[1], vdim * n[0]);
  axis_stencil_ext_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), make_coeffs<T>(coeffs), n[0], n[1], n[2],
      e0, e1, os_v, os0, os1);
  return cudaGetLastError();
}

template <typename T>
cudaError_t march_occupancy(int radius, int full, int kind, int* blocks) {
  if (kind == 1 && radius == 1) return pyapes::axis_march_dot_occupancy<T>(full != 0, blocks);
  if (kind == 2 && radius == 1) return pyapes::axis_march_ext_occupancy<T>(full != 0, blocks);
  if (kind != 0) return cudaErrorInvalidValue;
  if (radius == 1) return pyapes::axis_march_occupancy<T, 1>(full != 0, blocks);
  if (radius == 2) return pyapes::axis_march_occupancy<T, 2>(full != 0, blocks);
  return cudaErrorInvalidValue;
}

template <typename T>
pyapes::AxisMarchParams<T> march_params(const int* n, const void* const* coeffs, int five) {
  pyapes::AxisMarchParams<T> q;
  for (int a = 0; a < 3; ++a) {
    q.n[a] = n[a];
    for (int t = 0; t < 5; ++t) q.c[a][t] = static_cast<const T*>(coeffs[5 * a + t]);
  }
  q.five = five;
  return q;
}

template <typename T>
cudaError_t launch_march(int radius, int vdim, const int* n, const void* x, void* out,
                         const void* const* coeffs, int five, int ci, int cw, cudaStream_t s) {
  const pyapes::AxisMarchParams<T> q = march_params<T>(n, coeffs, five);
  if (radius == 1) return pyapes::axis_march_launch<T, 1>(vdim, q, x, out, ci, cw, s);
  if (radius == 2) return pyapes::axis_march_launch<T, 2>(vdim, q, x, out, ci, cw, s);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_march_dot(int vdim, const int* n, const void* x, void* out, void* partial,
                             const void* const* coeffs, int ci, int cw, cudaStream_t s) {
  return pyapes::axis_march_dot_launch<T>(vdim, march_params<T>(n, coeffs, 0), x, out, partial,
                                          ci, cw, s);
}

template <typename T>
cudaError_t launch_march_ext(int vdim, const int* n, const pyapes::AxisMarchExt& e,
                             const void* x, void* out, const void* const* coeffs, int ci, int cw,
                             cudaStream_t s) {
  return pyapes::axis_march_ext_launch<T>(vdim, march_params<T>(n, coeffs, 0), e, x, out, ci,
                                          cw, s);
}

// A launch plan, field for field ops/axis_stencil.py's _PlanArgs: built and
// checked by the wrapper once per operator (coefficient tuple), shape, dtype
// and device; a call passes only x, out, the dot's partials and the stream.
struct AxisPlan {
  // the kind's coefficient layout: 9 pointers (ap, ac, am) per mesh axis for
  // PLAN_POINT, PLAN_POINT_DOT and PLAN_ROW; 15 (app, ap, ac, am, amm), null
  // app/amm on a 3-point axis, for PLAN_POINT5, PLAN_MARCH, PLAN_MARCH_DOT
  const void* coeffs[15];
  int kind;     // PLAN_* below
  int dtype;    // 0 float32, 1 float64, 2 bfloat16
  int ndim;     // mesh axes, 1-3
  int vdim;     // components
  int n[3];     // mesh extents (1 past ndim)
  int radius;   // the plane march's radius, 1 or 2
  int five;     // the plane march's 5-point axes (bit a: axis a)
  int ci;       // planes per block of the plane march; rows per thread of the row march
  int cw;       // bytes per copy that the row length allows (16, 8, 4; 0)
};

// the per-point apply (1-3-D), its 5-point form, the per-point alpha-dot
// (3-D), the plane march (3-D, radius 1 or 2), its alpha-dot, the row march
// (2-D)
enum : int { PLAN_POINT, PLAN_POINT5, PLAN_POINT_DOT, PLAN_MARCH, PLAN_MARCH_DOT, PLAN_ROW };

// The widest staging copy of at most cw bytes, at least 4 and an element,
// that x's base address allows; 0 (element loads) where none does.
int copy_width(int cw, const void* x, int size) {
  while (cw >= 4 && cw >= size && reinterpret_cast<uintptr_t>(x) % cw != 0) cw /= 2;
  return cw >= 4 && cw >= size ? cw : 0;
}

template <typename T>
cudaError_t plan_launch(const AxisPlan& p, const void* x, void* out, void* partial,
                        cudaStream_t s) {
  const int cw = copy_width(p.cw, x, int(sizeof(T)));
  switch (p.kind) {
    case PLAN_POINT:
      return dispatch<T>(p.ndim, x, out, p.coeffs, p.vdim, p.n, s);
    case PLAN_POINT5:
      return dispatch5<T>(p.ndim, x, out, p.coeffs, p.vdim, p.n, s);
    case PLAN_POINT_DOT:
      if (p.ndim != 3 || partial == nullptr) return cudaErrorInvalidValue;
      return launch<T, 3>(x, out, partial, p.coeffs, p.vdim, p.n, s);
    case PLAN_MARCH:
      if (p.ndim != 3) return cudaErrorInvalidValue;
      return launch_march<T>(p.radius, p.vdim, p.n, x, out, p.coeffs, p.five, p.ci, cw, s);
    case PLAN_MARCH_DOT:
      if (p.ndim != 3 || partial == nullptr) return cudaErrorInvalidValue;
      return launch_march_dot<T>(p.vdim, p.n, x, out, partial, p.coeffs, p.ci, cw, s);
    case PLAN_ROW: {
      if (p.ndim != 2) return cudaErrorInvalidValue;
      pyapes::RowMarchParams<T> q;
      for (int a = 0; a < 2; ++a)
        for (int t = 0; t < 3; ++t) q.c[a][t] = static_cast<const T*>(p.coeffs[3 * a + t]);
      q.vdim = p.vdim;
      q.n0 = p.n[0];
      q.n1 = p.n[1];
      q.ci = p.ci;
      q.v16 = cw == 16 && copy_width(p.cw, out, int(sizeof(T))) == 16;
      q.vc = 1;
      for (int t = 0; t < 3; ++t) q.vc &= reinterpret_cast<uintptr_t>(q.c[1][t]) % 16 == 0;
      return pyapes::axis_row_march_launch<T>(q, x, out, s);
    }
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launch the plan at `plan` (an AxisPlan) on x -> out, (vdim, *n)
// C-contiguous on the device; partial: the alpha-dot's one compute-dtype
// value (f32 for bf16/f32, f64 for f64) per block, component-major (the
// per-point kernel's vdim * n0 * n1 * ceil(n2 / 128), the plane march's
// vdim * ceil(n0 / ci) * ceil(n1 / 16) * ceil(n2 / 128)), else ignored.
// A march's staging copies (the row march's loads and stores) narrow to
// x's (out's) alignment. Returns
// cudaGetLastError() after the launch (0 on success); launches on `stream`,
// does not synchronise and allocates nothing.
int pyapes_axis_plan_launch(const void* plan, const void* x, void* out, void* partial,
                            void* stream) {
  const AxisPlan& p = *static_cast<const AxisPlan*>(plan);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.dtype == 0) return plan_launch<float>(p, x, out, partial, s);
  if (p.dtype == 1) return plan_launch<double>(p, x, out, partial, s);
  if (p.dtype == 2) return plan_launch<__nv_bfloat16>(p, x, out, partial, s);
  return cudaErrorInvalidValue;
}

// Blocks of the plane march of `radius` (dtype: 0 float32, 1 float64, 2
// bfloat16; full: the kernel of
// grids whose every tile lies inside, n1 % 16 == 0 and n2 % 128 == 0; kind:
// 0 the apply, 1 the alpha-dot, 2 the halo-extended apply, the last two of
// radius 1) that one SM of the current device holds at once, into *blocks.
// Returns a CUDA error code (0 on success).
int pyapes_axis_march_blocks_per_sm(int dtype, int radius, int full, int kind, int* blocks) {
  if (dtype == 0) return march_occupancy<float>(radius, full, kind, blocks);
  if (dtype == 1) return march_occupancy<double>(radius, full, kind, blocks);
  if (dtype == 2) return march_occupancy<__nv_bfloat16>(radius, full, kind, blocks);
  return cudaErrorInvalidValue;
}

// The plane march of radius 1 on a halo-extended block: n0..n2, e0, e1, x,
// out and its strides as for pyapes_axis_stencil_ext; coeffs: 15 pointers
// (app, ap, ac, am, amm) per axis, app = amm = NULL; pair: 1 when out's base
// and os_v, os0, os1 are even in elements (pair stores), else 0; ci: planes
// per block along axis 0; cw: bytes per staging copy, 16, 8 or 4 (at least
// the dtype's size; x's rows and base pointer multiples of it), or 0 for
// element loads ((n1 + 2 e1) * n2 must fit an int).
int pyapes_axis_march_ext(int dtype, int vdim, int n0, int n1, int n2, int e0, int e1,
                          const void* x, void* out, long long os_v, long long os0, long long os1,
                          int pair, const void* const* coeffs, int ci, int cw, void* stream) {
  const int n[3] = {n0, n1, n2};
  const pyapes::AxisMarchExt e{e0, e1, os_v, os0, os1, pair};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_march_ext<float>(vdim, n, e, x, out, coeffs, ci, cw, s);
  if (dtype == 1) return launch_march_ext<double>(vdim, n, e, x, out, coeffs, ci, cw, s);
  if (dtype == 2) return launch_march_ext<__nv_bfloat16>(vdim, n, e, x, out, coeffs, ci, cw, s);
  return cudaErrorInvalidValue;
}

// 3-D halo-extended block. n0..n2: the UNEXTENDED block extents; e0, e1:
// 0/1 ghost rows per side on axes 0 and 1; x: (vdim, n0 + 2 e0, n1 + 2 e1,
// n2), C-contiguous; out: element strides os_v, os0, os1 of the
// (vdim, n0, n1, n2) output, last-axis stride 1; coeffs: 9 device pointers
// (ap, ac, am) per axis, sized to the unextended extents.
int pyapes_axis_stencil_ext(int dtype, int vdim, int n0, int n1, int n2, int e0, int e1,
                            const void* x, void* out, long long os_v, long long os0,
                            long long os1, const void* const* coeffs, void* stream) {
  const int n[3] = {n0, n1, n2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_ext<float>(x, out, coeffs, vdim, n, e0, e1, os_v, os0, os1, s);
  if (dtype == 1) return launch_ext<double>(x, out, coeffs, vdim, n, e0, e1, os_v, os0, os1, s);
  if (dtype == 2)
    return launch_ext<__nv_bfloat16>(x, out, coeffs, vdim, n, e0, e1, os_v, os0, os1, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
