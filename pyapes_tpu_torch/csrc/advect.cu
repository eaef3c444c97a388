// Per-point (spatially varying) advection on Hopper (sm_90a): for every
// active mesh axis a, the coefficients are built in registers from the
// axis' geometry-only base vectors (bp, bc, bm) = div_axis_coeffs(mesh,
// None, 1, "none") and the advecting component u = adv_a,
//
//   central, conservative:  cp = bp u(+1),  cc = bc u,  cm = bm u(-1)
//   central, advective:     cp = bp u,      cc = bc u,  cm = bm u
//   upwind:                 cp = 2|bp| min(u,0),  cm = -2|bp| max(u,0),
//                           cc = 2|bp| (max(u,0) - min(u,0)) + bc u
//   QUICK:                  the 5-point upwind-biased banks (cpp, cmm at
//                           offsets +-2), first-order upwind on rows 1
//                           and n-2,
//
// the boundary-row surgery of each axis side applied IN SEQUENCE (lower
// face first, the upper face reading what it left, as the plain version):
// "neumann" eliminates the boundary node of row 1 / n-2 (cc += 4/3 c0, the
// far neighbour -1/3 c0, the boundary neighbour 0), "periodic" zeroes the
// seam coupling; then
//
//   out[d] = sum_a  cpp x_a(+2) + cp x_a(+1) + cc x_a + cm x_a(-1) + cmm x_a(-2)
//
// with x_a = the target component read along axis a (offset by d * xstride
// for output component d). Every neighbour index of x and u wraps (torus),
// as torch.roll in the plain versions, so kernel and plain version agree
// on every row. bf16 storage computes in f32, f32 in f32, f64 in f64; one
// rounding, on store.
//
//   Div  (advect_pair):    one output component; axis a reads target
//        component a (a scalar target: component 0 on every axis) and its
//        advector. Replaces pallas_advect.py::pallas_advect_pair
//        (_advect_kernel), summed over the axes and the (axis, component)
//        pairs in ONE launch.
//   Conv (conv_component): vdim output components, each read along every
//        axis, advective form, axis a advected by adv[a]. Replaces
//        pallas_advect.py::pallas_conv_component (_conv_kernel), all
//        components in one launch.
//
// A 1-D or 2-D grid runs as (1, 1, n) / (1, nx, ny) with the leading axes
// left out of `axes`. The Python wrappers and the design note are in
// ops/advect.py. Plain C interface, loaded with ctypes. The plane march of
// 3-D grids (central and upwind) is csrc/advect_march.cu; its C entries
// are here.

#include "advect_march.cuh"
#include "common.cuh"

namespace {

using pyapes::Compute;
using pyapes::store;
using pyapes::to_c;

constexpr int kThreads = 128;  // one thread per point, along the last axis
enum Limiter { CENTRAL = 0, UPWIND = 1, QUICK = 2 };
enum Side { NONE = 0, NEUMANN = 1, PERIODIC = 2 };

template <typename T>
struct AdvParams {
  const T* x[3];    // target read along axis a (output component 0)
  const T* u[3];    // advecting component of axis a
  const T* bp[3];   // geometry-only base vectors of axis a (length n[a])
  const T* bc[3];
  const T* bm[3];
  int64_t xstride;  // elements between the targets of output components d and d+1
  int n[3];         // (n0, n1, n2)
  int axes;         // bit a: axis a contributes
  int lo[3], up[3]; // Side of the lower / upper face of axis a
  int limiter;
  int conservative; // central flux form: neighbour advection
};

__device__ __forceinline__ int wrap_up(int i, int n) { return i >= n ? i - n : i; }
__device__ __forceinline__ int wrap_dn(int i, int n) { return i < 0 ? i + n : i; }

template <typename T>
__global__ void __launch_bounds__(kThreads)
advect_kernel(T* __restrict__ out, AdvParams<T> q) {
  using C = typename Compute<T>::type;
  const int k = blockIdx.x * kThreads + threadIdx.x;
  if (k >= q.n[2]) return;
  const int c[3] = {(int)(blockIdx.z % q.n[0]), (int)blockIdx.y, k};
  const int d = blockIdx.z / q.n[0];
  const int64_t vol = (int64_t)q.n[0] * q.n[1] * q.n[2];
  const int64_t p = ((int64_t)c[0] * q.n[1] + c[1]) * q.n[2] + k;
  const int64_t stride[3] = {(int64_t)q.n[1] * q.n[2], (int64_t)q.n[2], 1};
  C acc = C(0);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    if (!((q.axes >> a) & 1)) continue;
    const int n = q.n[a];
    const int i = c[a];
    const int64_t s = stride[a];
    const int64_t pp = p + (int64_t)(wrap_up(i + 1, n) - i) * s;
    const int64_t pm = p + (int64_t)(wrap_dn(i - 1, n) - i) * s;
    const T* __restrict__ u = q.u[a];
    const T* __restrict__ xa = q.x[a] + d * q.xstride;
    const C ua = to_c(u[p]);
    const C bp = to_c(q.bp[a][i]), bc = to_c(q.bc[a][i]), bm = to_c(q.bm[a][i]);
    C cpp = C(0), cp, cc, cm, cmm = C(0);
    if (q.limiter == CENTRAL) {
      if (q.conservative) {
        cp = bp * to_c(u[pp]);
        cm = bm * to_c(u[pm]);
      } else {
        cp = bp * ua;
        cm = bm * ua;
      }
      cc = bc * ua;
    } else {
      const C inv2 = bp < C(0) ? -bp : bp;  // |bp| == 1/(2 dx)
      const C g_min = ua < C(0) ? ua : C(0);
      const C g_max = ua > C(0) ? ua : C(0);
      if (q.limiter == UPWIND || i == 1 || i == n - 2) {
        cp = C(2) * inv2 * g_min;
        cc = C(2) * inv2 * (g_max - g_min) + bc * ua;
        cm = C(-2) * inv2 * g_max;
      } else {
        const C sc = C(2) * inv2;  // 1/dx
        cpp = -sc * g_min / C(8);
        cp = sc * (C(3) * g_max + C(7) * g_min) / C(8);
        cc = sc * C(3) * (g_max - g_min) / C(8) + bc * ua;
        cm = -sc * (C(7) * g_max + C(3) * g_min) / C(8);
        cmm = sc * g_max / C(8);
      }
    }
    if (i == 1) {
      if (q.lo[a] == NEUMANN) {
        const C c0 = cm;
        cc += C(4.0 / 3.0) * c0;
        cp += C(-1.0 / 3.0) * c0;
        cm = C(0);
      } else if (q.lo[a] == PERIODIC) {
        cm = C(0);
      }
    }
    if (i == n - 2) {
      if (q.up[a] == NEUMANN) {
        const C c0 = cp;
        cc += C(4.0 / 3.0) * c0;
        cm += C(-1.0 / 3.0) * c0;
        cp = C(0);
      } else if (q.up[a] == PERIODIC) {
        cp = C(0);
      }
    }
    C t = cp * to_c(xa[pp]) + cc * to_c(xa[p]) + cm * to_c(xa[pm]);
    if (q.limiter == QUICK) {
      const int64_t ppp = p + (int64_t)(wrap_up(i + 2, n) - i) * s;
      const int64_t pmm = p + (int64_t)(wrap_dn(i - 2, n) - i) * s;
      t += cpp * to_c(xa[ppp]) + cmm * to_c(xa[pmm]);
    }
    acc += t;
  }
  store(&out[d * vol + p], acc);
}

template <typename T>
cudaError_t launch(int ncomp, const void* const* ptrs, const int* ints, long long xstride,
                   void* out, cudaStream_t s) {
  AdvParams<T> q;
  for (int a = 0; a < 3; ++a) {
    q.x[a] = static_cast<const T*>(ptrs[a]);
    q.u[a] = static_cast<const T*>(ptrs[3 + a]);
    q.bp[a] = static_cast<const T*>(ptrs[6 + a]);
    q.bc[a] = static_cast<const T*>(ptrs[9 + a]);
    q.bm[a] = static_cast<const T*>(ptrs[12 + a]);
    q.n[a] = ints[a];
    q.lo[a] = ints[4 + a];
    q.up[a] = ints[7 + a];
  }
  q.axes = ints[3];
  q.limiter = ints[10];
  q.conservative = ints[11];
  q.xstride = xstride;
  const dim3 grid((q.n[2] + kThreads - 1) / kThreads, q.n[1], ncomp * q.n[0]);
  advect_kernel<T><<<grid, kThreads, 0, s>>>(static_cast<T*>(out), q);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_march(int kind, int form, int ncomp, const void* const* ptrs, const int* ints,
                         int pairs, int ci, int cw, void* out, cudaStream_t s) {
  pyapes::AdvMarchParams<T> q;
  for (int a = 0; a < 3; ++a) {
    q.x[a] = static_cast<const T*>(ptrs[a]);
    q.u[a] = static_cast<const T*>(ptrs[3 + a]);
    for (int m = 0; m < 3; ++m) q.b[a][m] = static_cast<const T*>(ptrs[6 + 3 * m + a]);
    q.n[a] = ints[a];
    q.lo[a] = ints[4 + a];
    q.up[a] = ints[7 + a];
  }
  q.pairs = pairs;
  return pyapes::advect_march_launch<T>(kind, form, ncomp, q, out, ci, cw, s);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = float64, 2 = bfloat16. ncomp: output components
// (out: (ncomp, n0, n1, n2) C-contiguous). ptrs: 15 device pointers in
// x's dtype, per padded axis a = 0..2: x[a] (target read along a), u[a]
// (advector), bp[a], bc[a], bm[a] (grouped: x0 x1 x2 u0 u1 u2 bp0 ...);
// axes left out of `axes` may repeat any valid pointer. ints: n0 n1 n2,
// axes (bit mask), lo0 lo1 lo2, up0 up1 up2 (0 none, 1 neumann, 2
// periodic), limiter (0 central, 1 upwind, 2 quick), conservative (0/1).
// xstride: elements between consecutive output components' targets.
// Returns cudaGetLastError() after the launch (0 on success); launches on
// `stream`, does not synchronise and allocates nothing.
int pyapes_advect(int dtype, int ncomp, const void* const* ptrs, const int* ints,
                  long long xstride, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(ncomp, ptrs, ints, xstride, out, s);
  if (dtype == 1) return launch<double>(ncomp, ptrs, ints, xstride, out, s);
  if (dtype == 2) return launch<__nv_bfloat16>(ncomp, ptrs, ints, xstride, out, s);
  return cudaErrorInvalidValue;
}

// The plane march of a 3-D grid (all three axes), ptrs and ints as above
// (limiter and conservative ignored): kind 0 Conv (ncomp output
// components, the target component d at x[0] + d * n0 n1 n2), 1 the Div of
// a scalar target, 2 of a vector target (ncomp 1); form 0 central
// advective, 1 upwind, 2 central conservative (Div only); pairs: 1 when n2
// is even and every target and advector pointer is aligned to two
// elements; ci planes per block, cw bytes per staging copy (16, 8, 4; 0:
// element loads). Returns cudaGetLastError() after the launch.
int pyapes_advect_march(int dtype, int kind, int form, int ncomp, const void* const* ptrs,
                        const int* ints, int pairs, int ci, int cw, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_march<float>(kind, form, ncomp, ptrs, ints, pairs, ci, cw, out, s);
  if (dtype == 1)
    return launch_march<double>(kind, form, ncomp, ptrs, ints, pairs, ci, cw, out, s);
  if (dtype == 2)
    return launch_march<__nv_bfloat16>(kind, form, ncomp, ptrs, ints, pairs, ci, cw, out, s);
  return cudaErrorInvalidValue;
}

// Blocks of the march of (kind, form) (dtype as above; full: the instance
// of grids whose every tile lies inside) that one SM of the current device
// holds at once, into *blocks. Returns a CUDA error code (0 on success).
int pyapes_advect_march_blocks_per_sm(int dtype, int kind, int form, int full, int* blocks) {
  if (dtype == 0) return pyapes::advect_march_occupancy<float>(kind, form, full != 0, blocks);
  if (dtype == 1) return pyapes::advect_march_occupancy<double>(kind, form, full != 0, blocks);
  if (dtype == 2)
    return pyapes::advect_march_occupancy<__nv_bfloat16>(kind, form, full != 0, blocks);
  return cudaErrorInvalidValue;
}

}  // extern "C"
