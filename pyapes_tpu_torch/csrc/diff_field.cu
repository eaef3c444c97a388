// Variable-coefficient (heterogeneous-diffusivity) diffusion on Hopper
// (sm_90a): the conservative Laplacian in flux form,
//
//   A(G) x = sum_a inv_dx2[a] (F(+1/2) - F(-1/2))   along each mesh axis a,
//   F(+1/2) = face(G, G(+1)) (x(+1) - x),  F(-1/2) = face(G(-1), G) (x - x(-1)),
//
// with face() the arithmetic (G_i + G_j) / 2 or the harmonic
// 2 G_i G_j / (G_i + G_j) mean, the Neumann boundary-node elimination on
// row 1 (lower face) or row n-2 (upper face) of a surgered axis as ADDITIVE
// edits from the pre-surgery coefficient c0 (the row gains
// c0 (4/3 x - 1/3 x(far) - x(boundary)), its diagonal 4/3 c0), and every
// neighbour index of x and G wrapped (torus), as torch.roll in the plain
// versions, so kernel and plain version agree on every row. G is one
// pointer per axis: an isotropic G passes one field three times, a
// stacked (dim, *nx) G its slices. bf16 storage computes in f32, f32 in
// f32, f64 in f64; one rounding, on store.
//
//   diff_field           out = A(G) x
//     replaces pallas_advect.py::pallas_diff_field (_diff_kernel).
//   diff_jacobi (MODE)   SMOOTH:  out = x + omega mask (b - A x) / diag
//                        SMOOTH0: out = omega mask b / diag  (x unread)
//                        RESID:   out = mask (b - A x)
//     diag = sum_a -(inv_dx2[a] (face(-1/2) + face(+1/2))) (+ 4/3 c0 on a
//     surgered row), rebuilt in registers from the same face values, so no
//     diagonal field is read; replaces pallas_advect.py::
//     pallas_diff_jacobi (_diff_jac_kernel).
//
// Both are bound by memory: ~35 flops per point (harmonic faces add ~4
// divisions) against 3 grids of compulsory traffic for diff_field (read x
// and G, write out) and 4 for diff_jacobi (x, G, b, out). Two kernels
// compute them, chosen by the wrapper (ops/diff_field.py) from the shape
// alone:
//
//   * the plane march of csrc/diff_march.cu (diff_jacobi_march_kernel,
//     diff_field_march_kernel; design note there): jacobi3d.cu's
//     single-sweep design with G staged beside x, for 3-D grids from the
//     wrapper's threshold up;
//   * diff_field_kernel / diff_jacobi_kernel<MODE> here: one thread per
//     point, neighbours re-read through L1/L2; small grids (a launch there
//     is latency, which this kernel has least of) and 2-D grids, run as
//     (1, nx, ny) with first = 1 (axis 0 skipped).
//
// Plain C interface, loaded with ctypes.

#include "diff_field.cuh"

namespace {

using pyapes::APPLY;
using pyapes::Compute;
using pyapes::DiffParams;
using pyapes::RESID;
using pyapes::SMOOTH;
using pyapes::SMOOTH0;
using pyapes::store;
using pyapes::to_c;

constexpr int kThreads = 128;  // per-point kernel: one thread per point, along the last axis

template <typename C>
__device__ __forceinline__ C face(C a, C b, int harmonic) {
  return harmonic ? (C(2) * a) * b / (a + b) : C(0.5) * (a + b);
}

// Accumulate A x (when NEED_X) and the diagonal at spatial index p, grid
// coordinates c, of one component block xd.
template <typename T, bool NEED_X>
__device__ __forceinline__ void diff_point(const T* __restrict__ xd, const DiffParams<T>& q,
                                           const int* c, int64_t p,
                                           typename Compute<T>::type xc,
                                           typename Compute<T>::type& ax,
                                           typename Compute<T>::type& diag) {
  using C = typename Compute<T>::type;
  const int64_t stride[3] = {(int64_t)q.n[1] * q.n[2], (int64_t)q.n[2], 1};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    if (a < q.first) continue;
    const int n = q.n[a];
    const int64_t s = stride[a];
    const int64_t pp = (c[a] + 1 == n) ? p - (int64_t)(n - 1) * s : p + s;
    const int64_t pm = (c[a] == 0) ? p + (int64_t)(n - 1) * s : p - s;
    const T* __restrict__ g = q.g[a];
    const C gc = to_c(g[p]);
    C cp = face(gc, to_c(g[pp]), q.harmonic) * q.inv[a];
    C cm = face(gc, to_c(g[pm]), q.harmonic) * q.inv[a];
    C cc = -(cp + cm);
    const C cp0 = cp, cm0 = cm;
    if (((q.lo >> a) & 1) && c[a] == 1) {
      cc += C(4.0 / 3.0) * cm0;
      cp += C(-1.0 / 3.0) * cm0;
      cm -= cm0;
    }
    if (((q.up >> a) & 1) && c[a] == n - 2) {
      cc += C(4.0 / 3.0) * cp0;
      cm += C(-1.0 / 3.0) * cp0;
      cp -= cp0;
    }
    diag += cc;
    if constexpr (NEED_X) ax += cp * to_c(xd[pp]) + cc * xc + cm * to_c(xd[pm]);
  }
}

template <typename T>
__device__ __forceinline__ bool on_mask(const DiffParams<T>& q, const int* c) {
  bool m = false;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    if (a >= q.first && ((q.mask >> a) & 1) && (c[a] == 0 || c[a] == q.n[a] - 1)) m = true;
  }
  return m;
}

// Grid (ceil(n2 / 128), n1, vdim * n0): the last axis along threadIdx.x
// (coalesced), neighbour rows and planes re-read through L1/L2.
template <typename T>
__global__ void __launch_bounds__(kThreads)
diff_field_kernel(const T* __restrict__ x, T* __restrict__ out, DiffParams<T> q) {
  using C = typename Compute<T>::type;
  const int k = blockIdx.x * kThreads + threadIdx.x;
  if (k >= q.n[2]) return;
  const int c[3] = {(int)(blockIdx.z % q.n[0]), (int)blockIdx.y, k};
  const int d = blockIdx.z / q.n[0];
  const int64_t vol = (int64_t)q.n[0] * q.n[1] * q.n[2];
  const int64_t p = ((int64_t)c[0] * q.n[1] + c[1]) * q.n[2] + k;
  const T* xd = x + d * vol;
  C ax = C(0), diag = C(0);
  diff_point<T, true>(xd, q, c, p, to_c(xd[p]), ax, diag);
  store(&out[d * vol + p], ax);
}

template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
diff_jacobi_kernel(const T* __restrict__ x, const T* __restrict__ b, T* __restrict__ out,
                   DiffParams<T> q) {
  using C = typename Compute<T>::type;
  constexpr bool NEED_X = MODE != SMOOTH0;
  const int k = blockIdx.x * kThreads + threadIdx.x;
  if (k >= q.n[2]) return;
  const int c[3] = {(int)(blockIdx.z % q.n[0]), (int)blockIdx.y, k};
  const int d = blockIdx.z / q.n[0];
  const int64_t vol = (int64_t)q.n[0] * q.n[1] * q.n[2];
  const int64_t p = ((int64_t)c[0] * q.n[1] + c[1]) * q.n[2] + k;
  const T* xd = NEED_X ? x + d * vol : nullptr;
  const C xc = NEED_X ? to_c(xd[p]) : C(0);
  C ax = C(0), diag = C(0);
  diff_point<T, NEED_X>(xd, q, c, p, xc, ax, diag);
  C r = to_c(b[d * vol + p]);
  if constexpr (NEED_X) r = r - ax;
  if (on_mask(q, c)) r = C(0);
  C o;
  if constexpr (MODE == RESID) {
    o = r;
  } else if constexpr (MODE == SMOOTH) {
    o = xc + q.omega * r / diag;
  } else {
    o = q.omega * r / diag;
  }
  store(&out[d * vol + p], o);
}

// ---------------------------------------------------------------------------
// Launches.

template <typename T>
DiffParams<T> make_params(const int* n, int first, const void* const* g, const double* inv,
                          double omega, int lo, int up, int mask, int harmonic) {
  using C = typename Compute<T>::type;
  DiffParams<T> q;
  for (int a = 0; a < 3; ++a) {
    q.g[a] = static_cast<const T*>(g[a]);
    q.inv[a] = C(inv[a]);
    q.n[a] = n[a];
  }
  q.omega = C(omega);
  q.first = first;
  q.lo = lo;
  q.up = up;
  q.mask = mask;
  q.harmonic = harmonic;
  return q;
}

// The per-point kernels. mode < 0: diff_field; else diff_jacobi in that mode.
template <typename T>
cudaError_t launch_point(int mode, int vdim, const DiffParams<T>& q, const void* x,
                         const void* b, void* out, cudaStream_t s) {
  const dim3 grid((q.n[2] + kThreads - 1) / kThreads, q.n[1], vdim * q.n[0]);
  const T* xp = static_cast<const T*>(x);
  const T* bp = static_cast<const T*>(b);
  T* op = static_cast<T*>(out);
  if (mode < 0) {
    diff_field_kernel<T><<<grid, kThreads, 0, s>>>(xp, op, q);
  } else if (mode == SMOOTH) {
    diff_jacobi_kernel<T, SMOOTH><<<grid, kThreads, 0, s>>>(xp, bp, op, q);
  } else if (mode == SMOOTH0) {
    diff_jacobi_kernel<T, SMOOTH0><<<grid, kThreads, 0, s>>>(xp, bp, op, q);
  } else if (mode == RESID) {
    diff_jacobi_kernel<T, RESID><<<grid, kThreads, 0, s>>>(xp, bp, op, q);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// mode: SMOOTH, SMOOTH0, RESID or APPLY (diff_field). ci: planes per block
// of the march, 0 for the per-point kernel.
template <typename T>
cudaError_t launch(int mode, int vdim, const int* n, int first, const void* x, const void* b,
                   const void* const* g, void* out, const double* inv, double omega, int lo,
                   int up, int mask, int harmonic, int ci, int cw, cudaStream_t s) {
  if (ci == 0) {
    const auto q = make_params<T>(n, first, g, inv, omega, lo, up, mask, harmonic);
    return launch_point<T>(mode == APPLY ? -1 : mode, vdim, q, x, b, out, s);
  }
  const double inv_m[3] = {first ? 0.0 : inv[0], inv[1], inv[2]};  // 2-D: axis 0 adds nothing
  const auto q = make_params<T>(n, first, g, inv_m, omega, lo, up, mask, harmonic);
  if (g[0] == g[1] && g[1] == g[2]) {  // isotropic
    return pyapes::march_launch<T, true>(mode, vdim, q, x, b, out, ci, cw, s);
  }
  return pyapes::march_launch<T, false>(mode, vdim, q, x, b, out, ci, cw, s);
}

cudaError_t dispatch(int dtype, int mode, int vdim, const int* n, int first, const void* x,
                     const void* b, const void* const* g, void* out, const double* inv,
                     double omega, int lo, int up, int mask, int harmonic, int ci, int cw,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(mode, vdim, n, first, x, b, g, out, inv, omega, lo, up, mask, harmonic,
                         ci, cw, s);
  if (dtype == 1)
    return launch<double>(mode, vdim, n, first, x, b, g, out, inv, omega, lo, up, mask, harmonic,
                          ci, cw, s);
  if (dtype == 2)
    return launch<__nv_bfloat16>(mode, vdim, n, first, x, b, g, out, inv, omega, lo, up, mask,
                                 harmonic, ci, cw, s);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t occupancy(int mode, int iso, int full, int harmonic, int* blocks) {
  if (iso) return pyapes::march_occupancy<T, true>(mode, full != 0, harmonic != 0, blocks);
  return pyapes::march_occupancy<T, false>(mode, full != 0, harmonic != 0, blocks);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = float64, 2 = bfloat16. x, out: (vdim, n0, n1, n2)
// C-contiguous on the device; g0, g1, g2: (n0, n1, n2) C-contiguous, G of
// axes 0, 1, 2 (one pointer three times: isotropic; a 2-D grid: n0 = 1,
// first = 1, axis 0 adds nothing). lo, up: bit a set = Neumann elimination
// at that face of axis a. harmonic: 0/1 face rule. ci: planes per block of
// the plane march, or 0 for the per-point kernel. cw (the march): bytes per
// staging copy, 16, 8 or 4 (at least the dtype's size; n2 * sizeof(dtype)
// and the base pointers of x, b and each G multiples of it), or 0 for
// element loads; n1 * n2 must fit an int. Returns cudaGetLastError() after
// the launch (0 on success); launches on `stream`, does not synchronise and
// allocates nothing.
int pyapes_diff_field(int dtype, int vdim, int n0, int n1, int n2, int first, const void* x,
                      const void* g0, const void* g1, const void* g2, void* out, double inv0,
                      double inv1, double inv2, int lo, int up, int harmonic, int ci, int cw,
                      void* stream) {
  const int n[3] = {n0, n1, n2};
  const double inv[3] = {inv0, inv1, inv2};
  const void* g[3] = {g0, g1, g2};
  return dispatch(dtype, APPLY, vdim, n, first, x, nullptr, g, out, inv, 0.0, lo, up, 0,
                  harmonic, ci, cw, stream);
}

// As pyapes_diff_field for the Jacobi pass; mode: 0 smooth, 1 smooth0 (x
// unread, may be NULL), 2 resid; b: (vdim, n0, n1, n2); mask: bit a set =
// zero the update on rows 0 and n-1 of axis a.
int pyapes_diff_jacobi(int dtype, int mode, int vdim, int n0, int n1, int n2, int first,
                       const void* x, const void* b, const void* g0, const void* g1,
                       const void* g2, void* out, double inv0, double inv1, double inv2,
                       double omega, int lo, int up, int mask, int harmonic, int ci, int cw,
                       void* stream) {
  if (mode < 0 || mode > RESID) return cudaErrorInvalidValue;
  const int n[3] = {n0, n1, n2};
  const double inv[3] = {inv0, inv1, inv2};
  const void* g[3] = {g0, g1, g2};
  return dispatch(dtype, mode, vdim, n, first, x, b, g, out, inv, omega, lo, up, mask, harmonic,
                  ci, cw, stream);
}

// Blocks of the plane march (dtype as above; mode 0-2 the Jacobi pass, 3
// diff_field; iso: one G for all axes; full: the instance of grids whose
// every tile lies inside, n1 % tile rows == 0 and n2 % 128 == 0; harmonic
// faces) that one SM of the current device holds at once, into *blocks.
// Returns a CUDA error code (0 on success).
int pyapes_diff_jacobi_blocks_per_sm(int dtype, int mode, int iso, int full, int harmonic,
                                     int* blocks) {
  if (dtype == 0) return occupancy<float>(mode, iso, full, harmonic, blocks);
  if (dtype == 1) return occupancy<double>(mode, iso, full, harmonic, blocks);
  if (dtype == 2) return occupancy<__nv_bfloat16>(mode, iso, full, harmonic, blocks);
  return cudaErrorInvalidValue;
}

}  // extern "C"
