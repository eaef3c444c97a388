// Fused damped-Jacobi smoother / residual for the multigrid V-cycle on
// Hopper (sm_90a): the 3-D central Laplacian with scalar per-axis
// coefficients and torus wrap on every axis,
//
//   A x = sum_a inv_dx2[a] * (x[+1] + x[-1] - 2 x),
//
// and an interior mask that zeroes the update on the global first and last
// rows of each masked axis. bf16 storage computes in f32, f32 in f32, f64 in
// f64, and rounds once on store.
//
//   jacobi3d_kernel      out = alpha x + beta mask (b - A x)
//                        [+ one partial sum(b * out) per block]
//     replaces pallas_stencil.py::pallas_jacobi3d, pallas_stencil_db.py::
//     pallas_jacobi3d_db, pallas_stencil_v3.py::pallas_jacobi3d_v3 and (with
//     the dot) pallas_stencil_db.py::pallas_jacobi3d_dot_db.
//   jacobi3d_x2_kernel   two sweeps in one pass,
//                          y = x + beta mask (b - A x)   (from_zero: beta mask b)
//                          z = y + beta mask (b - A y)
//                        [+ one partial sum(b * z) per block]
//     replaces pallas_stencil_v3.py::pallas_jacobi3d_x2.
//
// The Python wrappers and the design note are in ops/jacobi.py. Plain C
// interface, loaded with ctypes.

#include "common.cuh"

namespace {

using pyapes::Compute;
using pyapes::store;
using pyapes::to_c;
using pyapes::wrap;

constexpr int kThreads = 128;  // single sweep: one thread per point

// x2 tile: TI x TJ x TK outputs per block; y lives on the tile plus a +-1
// halo in shared memory (in the compute dtype: y is never rounded).
constexpr int TI = 8, TJ = 8, TK = 32;
constexpr int YI = TI + 2, YJ = TJ + 2, YK = TK + 2;
constexpr int kX2Threads = 256;

template <typename C>
struct Params {
  C inv0, inv1, inv2, alpha, beta;
  int mask;  // bit a set: zero the update on the first/last row of axis a
  int N0, N1, N2;
};

template <typename C>
__device__ __forceinline__ bool on_mask(const Params<C>& q, int i, int j, int k) {
  return ((q.mask & 1) && (i == 0 || i == q.N0 - 1)) ||
         ((q.mask & 2) && (j == 0 || j == q.N1 - 1)) ||
         ((q.mask & 4) && (k == 0 || k == q.N2 - 1));
}

// A x at (i, j, k) of one component block `xd`, axes summed 0, 1, 2.
template <typename T, typename C>
__device__ __forceinline__ C lap_at(const T* __restrict__ xd, const Params<C>& q,
                                    int i, int j, int k, C xc) {
  const int64_t N2 = q.N2, plane = (int64_t)q.N1 * q.N2;
  const int ip = (i + 1 == q.N0) ? 0 : i + 1, im = (i == 0) ? q.N0 - 1 : i - 1;
  const int jp = (j + 1 == q.N1) ? 0 : j + 1, jm = (j == 0) ? q.N1 - 1 : j - 1;
  const int kp = (k + 1 == q.N2) ? 0 : k + 1, km = (k == 0) ? q.N2 - 1 : k - 1;
  const int64_t row = (int64_t)i * plane + (int64_t)j * N2;
  C ax = q.inv0 * (to_c(xd[(int64_t)ip * plane + (int64_t)j * N2 + k]) +
                   to_c(xd[(int64_t)im * plane + (int64_t)j * N2 + k]) - C(2) * xc);
  ax += q.inv1 * (to_c(xd[(int64_t)i * plane + (int64_t)jp * N2 + k]) +
                  to_c(xd[(int64_t)i * plane + (int64_t)jm * N2 + k]) - C(2) * xc);
  ax += q.inv2 * (to_c(xd[row + kp]) + to_c(xd[row + km]) - C(2) * xc);
  return ax;
}

// One thread per point, grid (ceil(N2 / 128), N1, vdim * N0); the last
// axis along threadIdx.x (coalesced), neighbour rows and planes re-read
// through L1/L2.
template <typename T, bool DOT>
__global__ void __launch_bounds__(kThreads)
jacobi3d_kernel(const T* __restrict__ x, const T* __restrict__ b,
                T* __restrict__ out, typename Compute<T>::type* __restrict__ partial,
                Params<typename Compute<T>::type> q) {
  using C = typename Compute<T>::type;
  const int k = blockIdx.x * kThreads + threadIdx.x;
  const int j = blockIdx.y;
  const int d = blockIdx.z / q.N0, i = blockIdx.z % q.N0;
  const int64_t vol = (int64_t)q.N0 * q.N1 * q.N2;
  C prod = C(0);
  if (k < q.N2) {
    const T* xd = x + d * vol;
    const int64_t p = d * vol + ((int64_t)i * q.N1 + j) * q.N2 + k;
    const C xc = to_c(x[p]);
    const C bv = to_c(b[p]);
    C upd = bv - lap_at<T, C>(xd, q, i, j, k, xc);
    if (on_mask(q, i, j, k)) upd = C(0);
    const C o = q.alpha * xc + q.beta * upd;
    store(&out[p], o);
    prod = bv * o;
  }
  if constexpr (DOT) {
    const C s = pyapes::block_sum<kThreads>(prod);
    if (threadIdx.x == 0) {
      partial[((int64_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] = s;
    }
  }
}

// Two sweeps per memory pass. Each block owns a TI x TJ x TK output tile.
// Sweep 1 computes y on the tile plus a +-1 halo in ALL three axes (global
// indices wrapped) into shared memory, reading x on a +-2 halo through
// L1/L2; sweep 2 computes z on the tile from shared y. The wrap and the mask
// hold on each sweep, so this equals two jacobi3d_kernel calls except that y
// is not rounded to the storage dtype.
template <typename T, bool FROM_ZERO, bool DOT>
__global__ void __launch_bounds__(kX2Threads)
jacobi3d_x2_kernel(const T* __restrict__ x, const T* __restrict__ b,
                   T* __restrict__ out, typename Compute<T>::type* __restrict__ partial,
                   Params<typename Compute<T>::type> q) {
  using C = typename Compute<T>::type;
  __shared__ C ys[YI * YJ * YK];
  const int gi_tiles = (q.N0 + TI - 1) / TI;
  const int d = blockIdx.z / gi_tiles;
  const int i0 = (blockIdx.z % gi_tiles) * TI, j0 = blockIdx.y * TJ, k0 = blockIdx.x * TK;
  const int64_t plane = (int64_t)q.N1 * q.N2;
  const int64_t vol = (int64_t)q.N0 * plane;
  const T* xd = FROM_ZERO ? nullptr : x + d * vol;
  const T* bd = b + d * vol;

  // sweep 1: y at global (i0 - 1 + li, j0 - 1 + lj, k0 - 1 + lk), wrapped
  for (int t = threadIdx.x; t < YI * YJ * YK; t += kX2Threads) {
    const int li = t / (YJ * YK), lj = (t / YK) % YJ, lk = t % YK;
    const int gi = wrap(i0 - 1 + li, q.N0), gj = wrap(j0 - 1 + lj, q.N1),
              gk = wrap(k0 - 1 + lk, q.N2);
    const int64_t p = (int64_t)gi * plane + (int64_t)gj * q.N2 + gk;
    const bool m = on_mask(q, gi, gj, gk);
    const C bv = to_c(bd[p]);
    C y;
    if constexpr (FROM_ZERO) {
      y = q.beta * (m ? C(0) : bv);
    } else {
      const C xc = to_c(xd[p]);
      const C upd = m ? C(0) : bv - lap_at<T, C>(xd, q, gi, gj, gk, xc);
      y = xc + q.beta * upd;
    }
    ys[t] = y;
  }
  __syncthreads();

  // sweep 2: z on the tile from the shared y
  C prod = C(0);
  for (int t = threadIdx.x; t < TI * TJ * TK; t += kX2Threads) {
    const int li = t / (TJ * TK), lj = (t / TK) % TJ, lk = t % TK;
    const int gi = i0 + li, gj = j0 + lj, gk = k0 + lk;
    if (gi >= q.N0 || gj >= q.N1 || gk >= q.N2) continue;
    const int s = ((li + 1) * YJ + (lj + 1)) * YK + (lk + 1);
    const C yc = ys[s];
    C ay = q.inv0 * (ys[s + YJ * YK] + ys[s - YJ * YK] - C(2) * yc);
    ay += q.inv1 * (ys[s + YK] + ys[s - YK] - C(2) * yc);
    ay += q.inv2 * (ys[s + 1] + ys[s - 1] - C(2) * yc);
    const int64_t p = (int64_t)gi * plane + (int64_t)gj * q.N2 + gk;
    const C bv = to_c(bd[p]);
    const C upd = on_mask(q, gi, gj, gk) ? C(0) : bv - ay;
    const C z = yc + q.beta * upd;
    store(&out[d * vol + p], z);
    prod += bv * z;
  }
  if constexpr (DOT) {
    const C s = pyapes::block_sum<kX2Threads>(prod);
    if (threadIdx.x == 0) {
      partial[((int64_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] = s;
    }
  }
}

template <typename T>
Params<typename Compute<T>::type> make_params(const int* n, const double* inv,
                                              double alpha, double beta, int mask) {
  using C = typename Compute<T>::type;
  return Params<C>{C(inv[0]), C(inv[1]), C(inv[2]), C(alpha), C(beta), mask, n[0], n[1], n[2]};
}

template <typename T>
cudaError_t launch_jacobi(int vdim, const int* n, const void* x, const void* b,
                          void* out, void* partial, const double* inv,
                          double alpha, double beta, int mask, cudaStream_t s) {
  using C = typename Compute<T>::type;
  const auto q = make_params<T>(n, inv, alpha, beta, mask);
  const dim3 grid((n[2] + kThreads - 1) / kThreads, n[1], vdim * n[0]);
  const T* xp = static_cast<const T*>(x);
  const T* bp = static_cast<const T*>(b);
  T* op = static_cast<T*>(out);
  C* pp = static_cast<C*>(partial);
  if (partial != nullptr) {
    jacobi3d_kernel<T, true><<<grid, kThreads, 0, s>>>(xp, bp, op, pp, q);
  } else {
    jacobi3d_kernel<T, false><<<grid, kThreads, 0, s>>>(xp, bp, op, pp, q);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_x2(int vdim, const int* n, const void* x, const void* b,
                      void* out, void* partial, const double* inv, double beta,
                      int mask, int from_zero, cudaStream_t s) {
  using C = typename Compute<T>::type;
  const auto q = make_params<T>(n, inv, 1.0, beta, mask);
  const dim3 grid((n[2] + TK - 1) / TK, (n[1] + TJ - 1) / TJ, vdim * ((n[0] + TI - 1) / TI));
  const T* xp = static_cast<const T*>(x);
  const T* bp = static_cast<const T*>(b);
  T* op = static_cast<T*>(out);
  C* pp = static_cast<C*>(partial);
  const bool dot = partial != nullptr;
  if (from_zero) {
    if (dot) jacobi3d_x2_kernel<T, true, true><<<grid, kX2Threads, 0, s>>>(xp, bp, op, pp, q);
    else jacobi3d_x2_kernel<T, true, false><<<grid, kX2Threads, 0, s>>>(xp, bp, op, pp, q);
  } else {
    if (dot) jacobi3d_x2_kernel<T, false, true><<<grid, kX2Threads, 0, s>>>(xp, bp, op, pp, q);
    else jacobi3d_x2_kernel<T, false, false><<<grid, kX2Threads, 0, s>>>(xp, bp, op, pp, q);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = float64, 2 = bfloat16. x, b, out: (vdim, n0, n1,
// n2) C-contiguous on the device. partial: NULL, or one compute-dtype value
// (f32 for bf16/f32, f64 for f64) per block, (vdim * n0 * n1 * ceil(n2 /
// 128)) of them, component-major. mask: bit a set masks axis a. Returns
// cudaGetLastError() after the launch (0 on success); launches on `stream`,
// does not synchronise and allocates nothing.
int pyapes_jacobi3d(int dtype, int vdim, int n0, int n1, int n2, const void* x,
                    const void* b, void* out, void* partial, double inv0,
                    double inv1, double inv2, double alpha, double beta,
                    int mask, void* stream) {
  const int n[3] = {n0, n1, n2};
  const double inv[3] = {inv0, inv1, inv2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_jacobi<float>(vdim, n, x, b, out, partial, inv, alpha, beta, mask, s);
  if (dtype == 1) return launch_jacobi<double>(vdim, n, x, b, out, partial, inv, alpha, beta, mask, s);
  if (dtype == 2) return launch_jacobi<__nv_bfloat16>(vdim, n, x, b, out, partial, inv, alpha, beta, mask, s);
  return cudaErrorInvalidValue;
}

// As pyapes_jacobi3d for the double sweep; x is not read (may be NULL) when
// from_zero. partial: NULL, or vdim * ceil(n0/8) * ceil(n1/8) * ceil(n2/32)
// values, component-major.
int pyapes_jacobi3d_x2(int dtype, int vdim, int n0, int n1, int n2, const void* x,
                       const void* b, void* out, void* partial, double inv0,
                       double inv1, double inv2, double beta, int mask,
                       int from_zero, void* stream) {
  const int n[3] = {n0, n1, n2};
  const double inv[3] = {inv0, inv1, inv2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_x2<float>(vdim, n, x, b, out, partial, inv, beta, mask, from_zero, s);
  if (dtype == 1) return launch_x2<double>(vdim, n, x, b, out, partial, inv, beta, mask, from_zero, s);
  if (dtype == 2) return launch_x2<__nv_bfloat16>(vdim, n, x, b, out, partial, inv, beta, mask, from_zero, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
