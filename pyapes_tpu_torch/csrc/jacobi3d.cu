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
// Both are bound by memory: ~16 (x2: ~32) flops per point against 3 grids
// of compulsory traffic (read x and b, write out). Both are 2.5-D plane
// marches along axis 0 (design notes above each kernel): a block owns a
// (j, k) column tile and a chunk of planes; x and b are staged plane by
// plane into shared-memory rings with 16-byte cp.async copies, planes
// ahead of use; each thread keeps its points' axis-0 neighbours in
// registers; the wrap and the mask are resolved once per block. The Python
// wrappers are in ops/jacobi.py. Plain C interface, loaded with ctypes.

#include "march.cuh"

namespace {

using pyapes::Compute;
using pyapes::cp_async;
using pyapes::cp_async_commit;
using pyapes::cp_async_wait;
using pyapes::load2;
using pyapes::march_args_ok;
using pyapes::opt_in_smem;
using pyapes::stage_window;
using pyapes::store;
using pyapes::store2;
using pyapes::to_c;
using pyapes::wrap;

template <typename C>
struct Params {
  C inv0, inv1, inv2, alpha, beta;
  int mask;  // bit a set: zero the update on the first/last row of axis a
  int N0, N1, N2;
};

// ---------------------------------------------------------------------------
// Single sweep: a 2.5-D plane march along axis 0 (the outermost, stride
// n1 n2; k is contiguous).
//
// Each block owns a J1_TJ x J1_TK = 16 x 128 column tile of outputs in
// (j, k) and a chunk of `ci` consecutive planes i0 .. i1-1 along i, and
// computes out(p) on the tile at step p = i0 .. i1-1 from x(p-1..p+1) and
// b(p). A single sweep needs x on rows +-1 only, so the x window is rows
// j0-1 .. j0+J1_TJ and columns k0-HK .. k0+J1_TK+HK-1, HK = 16 bytes of
// elements, so every row segment starts on a 16-byte boundary; b is
// staged on the tile alone; where the grid ends inside the tile, only the
// rows and columns of its points (+-1) are staged, so a small MG level's
// plane, a few cache lines, is not copied over and over into the window.
// Both go through cp.async copies of 16 bytes
// where the rows allow (8 or 4 where they do not, as on the 4^3 MG level
// in bf16; element loads, all issued before the first is stored, for bf16
// rows of odd length) into 4-slot rings (slot = plane & 3), issued up to
// three planes ahead of use (x(p+3), b(p+2) at step p), so the loads
// overlap the arithmetic of the steps before them. One barrier per step.
//
// A thread owns two adjacent columns in J1_R = 4 consecutive rows (8
// points; 2 warps side by side along k, 4 along j): it reads x and b and
// writes out as pairs (bf16x2, float2, double2) and keeps x(p-1) and x(p)
// of its points in registers along the march, so the i neighbours, the j
// neighbours inside its rows and the k neighbour inside its pair come
// from registers; the rest are a pair above, a pair below and one value
// each side of every row pair from the x slot. The window's wrapped row
// offsets and columns are one table per block; the axis-0 mask is one
// uniform scalar per step; the j/k mask bits and the bounds are a register
// per thread: no % and no 64-bit index product in the per-point loop.
//
// A grid whose every tile lies inside it (n1 % 16 == 0, n2 % 128 == 0: the
// MG levels from 128^3 up) takes the FULL instance, whose window bounds
// are compile-time constants; with the bounds computed per block the
// compiler schedules the 512^3 march measurably slower.
//
// A point is computed once, by one expression (jacobi_point(), explicit
// fma in a fixed order), whatever the chunk. With alpha = 1 it is the
// double sweep's sweep() to the bit.
constexpr int J1_WK = 2, J1_WJ = 4;               // warps along k, along j
constexpr int J1_THREADS = 32 * J1_WK * J1_WJ;    // 256
constexpr int J1_R = 4;                           // rows per thread
constexpr int J1_TJ = J1_WJ * J1_R, J1_TK = 64 * J1_WK;  // output tile (16 x 128)
constexpr int J1_XJ = J1_TJ + 2;                  // x window rows
constexpr int J1_SLOTS = 4;

template <typename T>
__host__ __device__ constexpr int j1_hk() {  // k halo of the x window: 16 bytes
  return 16 / int(sizeof(T));
}
template <typename T>
__host__ __device__ constexpr int j1_w() {  // x window row
  return J1_TK + 2 * j1_hk<T>();
}
template <typename T>
constexpr size_t j1_smem_bytes() {
  return J1_SLOTS * (J1_XJ * j1_w<T>() + J1_TJ * J1_TK) * sizeof(T) +
         (J1_XJ + j1_w<T>()) * sizeof(int);
}

// alpha c + beta (b - A c) at a point from its centre value and the sums of
// its two neighbours along each axis; alpha c on a masked point.
template <typename C>
__device__ __forceinline__ C jacobi_point(const Params<C>& q, C c, C s0, C s1, C s2, C bv,
                                          bool masked) {
  C ax = q.inv0 * fma(C(-2), c, s0);
  ax = fma(q.inv1, fma(C(-2), c, s1), ax);
  ax = fma(q.inv2, fma(C(-2), c, s2), ax);
  return fma(q.beta, masked ? C(0) : bv - ax, q.alpha * c);
}

template <typename T, bool DOT, bool FULL>
__global__ void __launch_bounds__(J1_THREADS)
jacobi3d_kernel(const T* __restrict__ x, const T* __restrict__ b, T* __restrict__ out,
                typename Compute<T>::type* __restrict__ partial,
                Params<typename Compute<T>::type> q, int ci, int cw) {
  using C = typename Compute<T>::type;
  constexpr int NT = J1_THREADS, HK = j1_hk<T>(), W = j1_w<T>();
  constexpr int XPL = J1_XJ * W, BPL = J1_TJ * J1_TK;
  constexpr int R2 = 2 * J1_R;  // a thread's points (pairs of R rows)
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);
  T* bs = xs + J1_SLOTS * XPL;
  int* rowoff = reinterpret_cast<int*>(bs + J1_SLOTS * BPL);  // window row -> j * n2
  int* kcol = rowoff + J1_XJ;                                  // window column -> k

  const int t = threadIdx.x;
  const int nch = (q.N0 + ci - 1) / ci;
  const int d = blockIdx.z / nch;
  const int i0 = (blockIdx.z - d * nch) * ci, i1 = min(i0 + ci, q.N0);
  const int j0 = blockIdx.y * J1_TJ, k0 = blockIdx.x * J1_TK;
  const int64_t plane = (int64_t)q.N1 * q.N2, vol = q.N0 * plane;
  const T* xd = x + d * vol;
  const T* bd = b + d * vol;
  T* od = out + d * vol;

  for (int e = t; e < J1_XJ + W; e += NT) {
    if (e < J1_XJ) rowoff[e] = wrap(j0 - 1 + e, q.N1) * q.N2;
    else kcol[e - J1_XJ] = wrap(k0 - HK + e - J1_XJ, q.N2);
  }
  __syncthreads();

  auto wrap_i = [&](int p) { return p < 0 ? p + q.N0 : (p >= q.N0 ? p - q.N0 : p); };
  // the window the block's points need: its rows inside the grid (+-1)
  // and its columns inside the grid (+-1), in copies of V elements; on a
  // grid smaller than the tile (the small MG levels, a plane of a few cache
  // lines) the rest of the window is not staged, and not read for a point
  // that is stored. FULL (every tile inside the grid): the whole window,
  // bounds known to the compiler
  const int tr = FULL ? J1_TJ : min(J1_TJ, q.N1 - j0);
  const int tc = FULL ? J1_TK : min(J1_TK, q.N2 - k0);
  auto chunks = [&](int v) { return (HK + tc + 1 + v - 1) / v; };  // x window copies per row
  // 16-byte copies (the aligned grids): this thread's copies of an x and
  // of a b plane, resolved once (copy c lands at element c * V16 of its slot)
  constexpr int V16 = 16 / int(sizeof(T));
  constexpr int NXC = XPL / V16, NBC = BPL / V16;
  constexpr int NX16 = (NXC + NT - 1) / NT, NB16 = (NBC + NT - 1) / NT;
  int gx16[NX16], gb16[NB16];
  unsigned okx = 0, okb = 0;  // bit u: copy u is in the needed window
  {
    const int cx = chunks(V16), cb = (tc + V16 - 1) / V16;
#pragma unroll
    for (int u = 0; u < NX16; ++u) {
      const int c = t + u * NT, r = c / (W / V16), h = c - r * (W / V16);
      gx16[u] = c < NXC ? rowoff[r] + kcol[h * V16] : 0;
      if (c < NXC && r < tr + 2 && h < cx) okx |= 1u << u;
    }
#pragma unroll
    for (int u = 0; u < NB16; ++u) {
      const int c = t + u * NT, r = c / (J1_TK / V16), h = c - r * (J1_TK / V16);
      gb16[u] = c < NBC ? rowoff[1 + r] + kcol[HK + h * V16] : 0;
      if (c < NBC && r < tr && h < cb) okb |= 1u << u;
    }
  }
  // stage plane p of x (window) / b (tile), cw bytes per copy (16, 8, 4;
  // 0: element loads)
  auto stage_x = [&](int p) {
    T* dst = xs + (p & 3) * XPL;
    const T* src = xd + wrap_i(p) * plane;
    if (cw == 16) {
#pragma unroll
      for (int u = 0; u < NX16; ++u) {
        if (okx >> u & 1u) cp_async<16>(dst + (t + u * NT) * V16, src + gx16[u]);
      }
    } else if (cw == 8) {
      constexpr int V = 8 / int(sizeof(T));
      stage_window<V, W, NT>(dst, src, rowoff, kcol, tr + 2, chunks(V), 0, t);
    } else if (cw == 4) {
      if constexpr (sizeof(T) <= 4) {
        constexpr int V = 4 / int(sizeof(T));
        stage_window<V, W, NT>(dst, src, rowoff, kcol, tr + 2, chunks(V), 0, t);
      }
    } else {
      stage_window<1, W, NT>(dst, src, rowoff, kcol, tr + 2, chunks(1), 0, t);
    }
  };
  auto stage_b = [&](int p) {
    T* dst = bs + (p & 3) * BPL;
    const T* src = bd + wrap_i(p) * plane;
    if (cw == 16) {
#pragma unroll
      for (int u = 0; u < NB16; ++u) {
        if (okb >> u & 1u) cp_async<16>(dst + (t + u * NT) * V16, src + gb16[u]);
      }
    } else if (cw == 8) {
      constexpr int V = 8 / int(sizeof(T));
      stage_window<V, J1_TK, NT>(dst, src, rowoff, kcol + HK, tr, (tc + V - 1) / V, 1, t);
    } else if (cw == 4) {
      if constexpr (sizeof(T) <= 4) {
        constexpr int V = 4 / int(sizeof(T));
        stage_window<V, J1_TK, NT>(dst, src, rowoff, kcol + HK, tr, (tc + V - 1) / V, 1, t);
      }
    } else {
      stage_window<1, J1_TK, NT>(dst, src, rowoff, kcol + HK, tr, tc, 1, t);
    }
  };

  // this thread's points: tile rows tj0 .. tj0+R-1, columns k0+kk, k0+kk+1;
  // point 2r+c is row r, column c
  const int w = t >> 5;
  const int kk = 64 * (w % J1_WK) + 2 * (t & 31), tj0 = (w / J1_WK) * J1_R;
  const int xo = (tj0 + 1) * W + HK + kk;  // its first pair in an x slot
  const int bo = tj0 * J1_TK + kk;         // ... in a b slot
  unsigned mjk = 0, live = 0;              // bit 2r+c: masked in (j, k); inside the grid
#pragma unroll
  for (int r = 0; r < J1_R; ++r) {
    const int gj = j0 + tj0 + r;
    const bool mj = (q.mask & 2) && (gj == 0 || gj == q.N1 - 1);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int gk = k0 + kk + c;
      if (mj || ((q.mask & 4) && (gk == 0 || gk == q.N2 - 1))) mjk |= 1u << (2 * r + c);
      if (gj < q.N1 && gk < q.N2) live |= 1u << (2 * r + c);
    }
  }
  const bool pair_store = (q.N2 & 1) == 0;
  const int64_t orow = (int64_t)(j0 + tj0) * q.N2 + k0 + kk;  // its first point in a plane

  // prologue: x(i0-1), x(i0) now; then the groups G(p) = {x(p+1), b(p)}
  // for p = i0, i0+1, so that step p waits only for G(p)
  stage_x(i0 - 1);
  stage_x(i0);
  cp_async_commit();
  stage_x(i0 + 1);
  stage_b(i0);
  cp_async_commit();
  if (i0 + 2 <= i1) stage_x(i0 + 2);
  if (i0 + 1 < i1) stage_b(i0 + 1);
  cp_async_commit();
  cp_async_wait<2>();
  __syncthreads();

  C xm[R2], xc[R2];  // x(p-1), x(p) at this thread's points
  {
    const T* s0 = xs + ((i0 - 1) & 3) * XPL;
    const T* s1 = xs + (i0 & 3) * XPL;
#pragma unroll
    for (int r = 0; r < J1_R; ++r) {
      load2(s0 + xo + r * W, xm[2 * r], xm[2 * r + 1]);
      load2(s1 + xo + r * W, xc[2 * r], xc[2 * r + 1]);
    }
  }

  C prod = C(0);
  for (int p = i0; p < i1; ++p) {
    cp_async_wait<1>();  // G(p): x(p+1), b(p)
    __syncthreads();     // ... from every thread; step p-1 done with the slots
                         // refilled below (one barrier a step)
    if (p + 3 <= i1) stage_x(p + 3);
    if (p + 2 < i1) stage_b(p + 2);
    cp_async_commit();

    const bool mi = (q.mask & 1) && (p == 0 || p == q.N0 - 1);
    const T* xsc = xs + (p & 3) * XPL;        // x(p)
    const T* xsn = xs + ((p + 1) & 3) * XPL;  // x(p+1)
    const T* bsc = bs + (p & 3) * BPL;        // b(p)
    C xp[R2], bn[R2], above[2], below[2];
#pragma unroll
    for (int r = 0; r < J1_R; ++r) {
      load2(xsn + xo + r * W, xp[2 * r], xp[2 * r + 1]);
      load2(bsc + bo + r * J1_TK, bn[2 * r], bn[2 * r + 1]);
    }
    load2(xsc + xo - W, above[0], above[1]);
    load2(xsc + xo + J1_R * W, below[0], below[1]);
    T* dst = od + p * plane + orow;
#pragma unroll
    for (int r = 0; r < J1_R; ++r) {
      const int o = xo + r * W;
      const C kl = to_c(xsc[o - 1]), kr = to_c(xsc[o + 2]);  // beside the pair
      C v[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int u = 2 * r + c;
        const C jm = r == 0 ? above[c] : xc[u - 2], jp = r == J1_R - 1 ? below[c] : xc[u + 2];
        const C ks = c == 0 ? xc[u + 1] + kl : kr + xc[u - 1];
        v[c] = jacobi_point(q, xc[u], xp[u] + xm[u], jp + jm, ks, bn[u], mi || (mjk >> u & 1u));
      }
      const unsigned lv = live >> (2 * r) & 3u;
      if (lv == 3u && pair_store) {
        store2(dst, v[0], v[1]);
      } else {
        if (lv & 1u) store(dst, v[0]);
        if (lv & 2u) store(dst + 1, v[1]);
      }
      if constexpr (DOT) {
        if (lv & 1u) prod = fma(bn[2 * r], v[0], prod);
        if (lv & 2u) prod = fma(bn[2 * r + 1], v[1], prod);
      }
      dst += q.N2;
    }
#pragma unroll
    for (int u = 0; u < R2; ++u) {
      xm[u] = xc[u];
      xc[u] = xp[u];
    }
  }
  if constexpr (DOT) {
    const C s = pyapes::block_sum<NT>(prod);
    if (t == 0) {
      partial[((int64_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] = s;
    }
  }
}

// ---------------------------------------------------------------------------
// Double sweep: a 2.5-D plane march along axis 0 (the outermost, stride
// n1 n2; k is contiguous).
//
// Each block owns a TJ x TK column tile of outputs in (j, k) and a chunk of
// `ci` consecutive planes i0 .. i1-1 along i; its loop step p computes
//
//   y(p)    on the tile plus a +-1 ring in (j, k)   (needs x(p-1..p+1), b(p))
//   z(p-1)  on the tile                            (needs y(p-2..p), b(p-1))
//
// for p = i0-1 .. i1. x and b planes are staged in shared memory on a
// window of rows j0-2 .. j0+TJ+1 (b: j0-1 .. j0+TJ) and columns k0-HK ..
// k0+TK+HK-1, HK = 8 elements so every row segment starts on a 16-byte
// boundary: cp.async copies of 16 bytes where the rows allow (8 or 4
// where they do not, as on the 4^3 MG level in bf16; element loads, all
// issued before the first is stored, for bf16 rows of odd length). They land
// in 4-slot rings (slot = plane & 3), issued two steps ahead of use, so
// the loads of planes p+2, p+3 overlap the arithmetic of step p. y(p)
// goes into a 2-slot ring (slot = p & 1) for its in-plane neighbours.
//
// A thread owns two adjacent columns of R consecutive y rows: it reads
// and writes them as pairs (bf16x2, float2, double2) and keeps their x, y
// and b values in registers along the march (x(p-1), x(p), y(p-2),
// y(p-1), b(p-1)), so the i neighbours, the j neighbours inside its R
// rows and the k neighbour inside its pair come from registers. The y
// rows of a block are TJ + 2 (the tile and its ring rows); the ring's two
// columns are one point per thread of the last warp. The window's wrapped
// row offsets and columns are one table per block; the plane wrap and the
// axis-0 mask are one uniform scalar per step; the j/k mask bits are a
// register per thread: no % and no 64-bit index product in the per-point
// loop.
//
// A chunk recomputes y on the two planes before it (i0-1 and, as the
// neighbour chunk does, i0); y at a point is the same expression of the
// same operands wherever it is computed (sweep(), with explicit fma), so
// the seams and the ring repeat the neighbours' bits.
constexpr int X2_THREADS = 128;
constexpr int X2_R = 4;                              // y rows per thread
constexpr int X2_YJ = X2_THREADS / 32 * X2_R;        // y rows of a block (16)
constexpr int X2_TJ = X2_YJ - 2, X2_TK = 64;         // output tile (14 x 64)
constexpr int X2_HK = 8;                             // k halo of the x/b window
constexpr int X2_W = X2_TK + 2 * X2_HK;              // x/b window row (80)
constexpr int X2_XJ = X2_YJ + 2, X2_BJ = X2_YJ;      // x/b window rows
constexpr int X2_YP = X2_TK + 4;                     // y row pitch: y(k0-1+yk) at yk+1
constexpr int X2_NS = 2 * X2_YJ;                     // ring columns' points (32)
constexpr int X2_SLOTS = 4;
static_assert(X2_TK == 64 && X2_NS <= X2_THREADS, "a warp's pairs span the tile");

template <typename T>
constexpr size_t x2_smem_bytes() {
  using C = typename Compute<T>::type;
  return 2 * X2_YJ * X2_YP * sizeof(C) + X2_SLOTS * (X2_XJ + X2_BJ) * X2_W * sizeof(T) +
         (X2_XJ + X2_W) * sizeof(int);
}

// Stage `rows` window rows (from window row r0) of one plane (`src`: its
// first element) into dst, from the copy with index `from` on in steps of
// the block: BYTES per cp.async, or (BYTES == 0) element loads, every one
// issued before the first store.
template <int BYTES, typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, const int* rowoff,
                                           const int* kcol, int rows, int r0, int from) {
  constexpr int V = BYTES ? BYTES / int(sizeof(T)) : 1, NCH = X2_W / V;
  const int n = rows * NCH;
  if constexpr (BYTES > 0) {
    for (int c = from; c < n; c += X2_THREADS) {
      const int r = c / NCH, h = c - r * NCH;
      cp_async<BYTES>(dst + r * X2_W + h * V, src + rowoff[r0 + r] + kcol[h * V]);
    }
  } else {
    constexpr int NMAX = (X2_XJ * X2_W + X2_THREADS - 1) / X2_THREADS;
    T v[NMAX];
#pragma unroll
    for (int u = 0; u < NMAX; ++u) {
      const int e = from + u * X2_THREADS;
      if (e < n) {
        const int r = e / X2_W;
        v[u] = src[rowoff[r0 + r] + kcol[e - r * X2_W]];
      }
    }
#pragma unroll
    for (int u = 0; u < NMAX; ++u) {
      if (from + u * X2_THREADS < n) dst[from + u * X2_THREADS] = v[u];
    }
  }
}

// One damped-Jacobi update at a point from its centre value and the sums of
// its two neighbours along each axis: c + beta (b - A c), or c on a masked
// point. Explicit fma, so every caller rounds alike.
template <typename C>
__device__ __forceinline__ C sweep(const Params<C>& q, C c, C s0, C s1, C s2, C bv, bool masked) {
  C ax = q.inv0 * fma(C(-2), c, s0);
  ax = fma(q.inv1, fma(C(-2), c, s1), ax);
  ax = fma(q.inv2, fma(C(-2), c, s2), ax);
  return masked ? c : fma(q.beta, bv - ax, c);
}

template <typename T, bool FROM_ZERO, bool DOT>
__global__ void __launch_bounds__(X2_THREADS)
jacobi3d_x2_kernel(const T* __restrict__ x, const T* __restrict__ b, T* __restrict__ out,
                   typename Compute<T>::type* __restrict__ partial,
                   Params<typename Compute<T>::type> q, int ci, int cw) {
  using C = typename Compute<T>::type;
  constexpr int YPL = X2_YJ * X2_YP, XPL = X2_XJ * X2_W, BPL = X2_BJ * X2_W;
  constexpr int R2 = 2 * X2_R;  // a thread's y points (pairs of R rows)
  extern __shared__ __align__(16) unsigned char smem[];
  C* ys = reinterpret_cast<C*>(smem);
  T* xs = reinterpret_cast<T*>(ys + 2 * YPL);
  T* bs = xs + X2_SLOTS * XPL;
  int* rowoff = reinterpret_cast<int*>(bs + X2_SLOTS * BPL);  // window row -> j * n2
  int* kcol = rowoff + X2_XJ;                                  // window column -> k

  const int t = threadIdx.x;
  const int nch = (q.N0 + ci - 1) / ci;
  const int d = blockIdx.z / nch;
  const int i0 = (blockIdx.z - d * nch) * ci, i1 = min(i0 + ci, q.N0);
  const int j0 = blockIdx.y * X2_TJ, k0 = blockIdx.x * X2_TK;
  const int64_t plane = (int64_t)q.N1 * q.N2, vol = q.N0 * plane;
  const T* xd = FROM_ZERO ? nullptr : x + d * vol;
  const T* bd = b + d * vol;
  T* od = out + d * vol;

  for (int e = t; e < X2_XJ + X2_W; e += X2_THREADS) {
    if (e < X2_XJ) rowoff[e] = wrap(j0 - 2 + e, q.N1) * q.N2;
    else kcol[e - X2_XJ] = wrap(k0 - X2_HK + e - X2_XJ, q.N2);
  }
  __syncthreads();

  auto wrap_i = [&](int p) { return p < 0 ? p + q.N0 : (p >= q.N0 ? p - q.N0 : p); };
  // 16-byte copies (the aligned grids): this thread's first two copies of
  // an x and of a b plane, resolved once
  constexpr int V16 = 16 / int(sizeof(T)), N16 = X2_W / V16;
  int s16[2], gx16[2], gb16[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int c = t + u * X2_THREADS, r = c / N16, hh = c - r * N16;
    s16[u] = r * X2_W + hh * V16;
    gx16[u] = r < X2_XJ ? rowoff[r] + kcol[hh * V16] : 0;
    gb16[u] = r < X2_BJ ? rowoff[1 + r] + kcol[hh * V16] : 0;
  }
  // stage plane p of src (window rows r0 .. r0+rows-1) into dst, cw bytes
  // per copy (16, 8, 4; 0: element loads)
  auto stage = [&](T* dst, const T* src, int p, int rows, int r0, const int (&g16)[2]) {
    src += wrap_i(p) * plane;
    if (cw == 16) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (t + u * X2_THREADS < rows * N16) cp_async<16>(dst + s16[u], src + g16[u]);
      }
      stage_rows<16>(dst, src, rowoff, kcol, rows, r0, t + 2 * X2_THREADS);
    } else if (cw == 8) {
      stage_rows<8>(dst, src, rowoff, kcol, rows, r0, t);
    } else if (cw == 4) {
      if constexpr (sizeof(T) <= 4) stage_rows<4>(dst, src, rowoff, kcol, rows, r0, t);
    } else {
      stage_rows<0>(dst, src, rowoff, kcol, rows, r0, t);
    }
  };
  auto stage_x = [&](int p) {
    if constexpr (!FROM_ZERO) stage(xs + (p & 3) * XPL, xd, p, X2_XJ, 0, gx16);
  };
  auto stage_b = [&](int p) { stage(bs + (p & 3) * BPL, bd, p, X2_BJ, 1, gb16); };

  // this thread's y points: rows yj0 .. yj0+R-1, columns k0+kk, k0+kk+1
  // (y-plane columns kk+1, kk+2); point 2r+c is row r, column c
  const int kk = 2 * (t & 31), yj0 = (t >> 5) * X2_R;
  const int xo = (yj0 + 1) * X2_W + kk + X2_HK;  // its first pair in an x slot
  const int bo = yj0 * X2_W + kk + X2_HK;        // ... in a b slot
  const int yo = yj0 * X2_YP + kk + 2;           // ... in a y slot
  // the y rows next to its rows (clamped inside the y plane where unused)
  const int ya = yj0 > 0 ? yo - X2_YP : yo, yb = yj0 + X2_R < X2_YJ ? yo + X2_R * X2_YP : yo;
  unsigned mjk = 0, live = 0, zrow = 0;  // bit 2r+c: masked in (j, k); z stored. bit r: z row
#pragma unroll
  for (int r = 0; r < X2_R; ++r) {
    const int yj = yj0 + r, gj = j0 - 1 + yj, gjw = wrap(gj, q.N1);
    const bool mj = (q.mask & 2) && (gjw == 0 || gjw == q.N1 - 1);
    if (yj >= 1 && yj <= X2_YJ - 2) zrow |= 1u << r;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int gk = k0 + kk + c, gkw = wrap(gk, q.N2);
      if (mj || ((q.mask & 4) && (gkw == 0 || gkw == q.N2 - 1))) mjk |= 1u << (2 * r + c);
      if ((zrow >> r & 1u) && gj < q.N1 && gk < q.N2) live |= 1u << (2 * r + c);
    }
  }
  const bool pair_store = (q.N2 & 1) == 0;
  const int64_t orow = (int64_t)(j0 - 1 + yj0) * q.N2 + k0 + kk;  // its first point in a plane
  // one point of the ring columns (y-plane columns 0 and TK+1) per thread
  // of the last X2_NS, at y-plane coordinates (sj, sk)
  const int sn = t - (X2_THREADS - X2_NS);
  const bool ring = sn >= 0;
  const int sj = (sn + X2_YJ) % X2_YJ, sk = sn >= X2_YJ ? X2_TK + 1 : 0;
  const int hxo = (sj + 1) * X2_W + sk + X2_HK - 1, hbo = sj * X2_W + sk + X2_HK - 1;
  const int hyo = sj * X2_YP + sk + 1;
  bool mh;
  {
    const int gj = wrap(j0 - 1 + sj, q.N1), gk = wrap(k0 - 1 + sk, q.N2);
    mh = ((q.mask & 2) && (gj == 0 || gj == q.N1 - 1)) ||
         ((q.mask & 4) && (gk == 0 || gk == q.N2 - 1));
  }

  // prologue: x(i0-2), x(i0-1) now; then the groups G(p) = {x(p+3), b(p+2)}
  // for p = i0-3, i0-2, so that step p waits only for G(p-2)
  stage_x(i0 - 2);
  stage_x(i0 - 1);
  cp_async_commit();
  stage_x(i0);
  stage_b(i0 - 1);
  cp_async_commit();
  stage_x(i0 + 1);
  stage_b(i0);
  cp_async_commit();
  cp_async_wait<2>();
  __syncthreads();

  C xm[R2], xc[R2], ym[R2], yc[R2], bc[R2];  // x(p-1), x(p), y(p-2), y(p-1), b(p-1)
  C hxm = C(0), hxc = C(0);                  // x(p-1), x(p) at the ring point
#pragma unroll
  for (int u = 0; u < R2; ++u) {
    xm[u] = xc[u] = ym[u] = yc[u] = bc[u] = C(0);
  }
  if constexpr (!FROM_ZERO) {
    const T* s0 = xs + ((i0 - 2) & 3) * XPL;
    const T* s1 = xs + ((i0 - 1) & 3) * XPL;
#pragma unroll
    for (int r = 0; r < X2_R; ++r) {
      load2(s0 + xo + r * X2_W, xm[2 * r], xm[2 * r + 1]);
      load2(s1 + xo + r * X2_W, xc[2 * r], xc[2 * r + 1]);
    }
    if (ring) {
      hxm = to_c(s0[hxo]);
      hxc = to_c(s1[hxo]);
    }
  }

  C prod = C(0);
  bool mprev = false;  // axis-0 mask of plane p-1
  for (int p = i0 - 1; p <= i1; ++p) {
    cp_async_wait<1>();  // G(p-2): x(p+1), b(p)
    __syncthreads();     // ... from every thread; step p-1 done with the slots
                         // refilled below and with y slot p & 1 (one barrier a step)
    if (p + 3 <= i1 + 1) stage_x(p + 3);
    if (p + 2 <= i1) stage_b(p + 2);
    cp_async_commit();

    const int gi = wrap_i(p);
    const bool mi = (q.mask & 1) && (gi == 0 || gi == q.N0 - 1);
    const T* xsc = xs + (p & 3) * XPL;        // x(p)
    const T* xsn = xs + ((p + 1) & 3) * XPL;  // x(p+1)
    const T* bsc = bs + (p & 3) * BPL;        // b(p)
    C* ysp = ys + (p & 1) * YPL;              // y(p)
    C yn[R2], bn[R2];
#pragma unroll
    for (int r = 0; r < X2_R; ++r) load2(bsc + bo + r * X2_W, bn[2 * r], bn[2 * r + 1]);
    if constexpr (FROM_ZERO) {
#pragma unroll
      for (int u = 0; u < R2; ++u) yn[u] = (mi || (mjk >> u & 1u)) ? C(0) : q.beta * bn[u];
    } else {
      C xp[R2], above[2], below[2];
#pragma unroll
      for (int r = 0; r < X2_R; ++r) load2(xsn + xo + r * X2_W, xp[2 * r], xp[2 * r + 1]);
      load2(xsc + xo - X2_W, above[0], above[1]);
      load2(xsc + xo + X2_R * X2_W, below[0], below[1]);
#pragma unroll
      for (int r = 0; r < X2_R; ++r) {
        const int o = xo + r * X2_W;
        const C kl = to_c(xsc[o - 1]), kr = to_c(xsc[o + 2]);  // beside the pair
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int u = 2 * r + c;
          const C jm = r == 0 ? above[c] : xc[u - 2], jp = r == X2_R - 1 ? below[c] : xc[u + 2];
          const C ks = c == 0 ? xc[u + 1] + kl : kr + xc[u - 1];
          yn[u] = sweep(q, xc[u], xp[u] + xm[u], jp + jm, ks, bn[u], mi || (mjk >> u & 1u));
        }
      }
#pragma unroll
      for (int u = 0; u < R2; ++u) {
        xm[u] = xc[u];
        xc[u] = xp[u];
      }
    }
    if (p >= i0) {  // y(i0-1) is needed only at this thread's own points
#pragma unroll
      for (int r = 0; r < X2_R; ++r) store2(ysp + yo + r * X2_YP, yn[2 * r], yn[2 * r + 1]);
    }
    if (ring) {
      if constexpr (FROM_ZERO) {
        if (p >= i0) ysp[hyo] = (mi || mh) ? C(0) : q.beta * to_c(bsc[hbo]);
      } else {
        const C hxp = to_c(xsn[hxo]);
        if (p >= i0) {
          ysp[hyo] = sweep(q, hxc, hxp + hxm, to_c(xsc[hxo + X2_W]) + to_c(xsc[hxo - X2_W]),
                           to_c(xsc[hxo + 1]) + to_c(xsc[hxo - 1]), to_c(bsc[hbo]), mi || mh);
        }
        hxm = hxc;
        hxc = hxp;
      }
    }
    // z(p-1) from y(p-2..p): y(p-1) in the other slot (visible since the
    // barrier above), y(p-2), y(p) at this thread's points in registers
    if (p > i0) {
      const C* ysc = ys + ((p - 1) & 1) * YPL;
      C above[2], below[2];
      load2(ysc + ya, above[0], above[1]);
      load2(ysc + yb, below[0], below[1]);
      const int64_t pb = wrap_i(p - 1) * plane + orow;
#pragma unroll
      for (int r = 0; r < X2_R; ++r) {
        if (!(zrow >> r & 1u)) continue;  // a ring row (uniform across the warp)
        const int o = yo + r * X2_YP;
        const C kl = ysc[o - 1], kr = ysc[o + 2];
        C z[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int u = 2 * r + c;
          const C jm = r == 0 ? above[c] : yc[u - 2], jp = r == X2_R - 1 ? below[c] : yc[u + 2];
          const C ks = c == 0 ? yc[u + 1] + kl : kr + yc[u - 1];
          z[c] = sweep(q, yc[u], yn[u] + ym[u], jp + jm, ks, bc[u], mprev || (mjk >> u & 1u));
        }
        T* dst = od + pb + r * q.N2;
        const unsigned lv = live >> (2 * r) & 3u;
        if (lv == 3u && pair_store) {
          store2(dst, z[0], z[1]);
        } else {
          if (lv & 1u) store(dst, z[0]);
          if (lv & 2u) store(dst + 1, z[1]);
        }
        if constexpr (DOT) {
          if (lv & 1u) prod = fma(bc[2 * r], z[0], prod);
          if (lv & 2u) prod = fma(bc[2 * r + 1], z[1], prod);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < R2; ++u) {
      ym[u] = yc[u];
      yc[u] = yn[u];
      bc[u] = bn[u];
    }
    mprev = mi;
  }
  if constexpr (DOT) {
    const C s = pyapes::block_sum<X2_THREADS>(prod);
    if (t == 0) {
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

template <typename T, bool DOT, bool FULL>
cudaError_t j1_prepare() {
  static unsigned done = 0;
  return opt_in_smem(jacobi3d_kernel<T, DOT, FULL>, j1_smem_bytes<T>(), done);
}

// Every single-sweep tile lies inside an (n0, n1, n2) grid.
inline bool j1_full(const int* n) { return n[1] % J1_TJ == 0 && n[2] % J1_TK == 0; }

template <typename T, bool DOT, bool FULL>
cudaError_t launch_j1_kernel(dim3 grid, cudaStream_t s, const T* x, const T* b, T* out,
                             typename Compute<T>::type* partial,
                             const Params<typename Compute<T>::type>& q, int ci, int cw) {
  const cudaError_t e = j1_prepare<T, DOT, FULL>();
  if (e != cudaSuccess) return e;
  jacobi3d_kernel<T, DOT, FULL><<<grid, J1_THREADS, j1_smem_bytes<T>(), s>>>(
      x, b, out, partial, q, ci, cw);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_jacobi(int vdim, const int* n, const void* x, const void* b,
                          void* out, void* partial, const double* inv,
                          double alpha, double beta, int mask, int ci, int cw, cudaStream_t s) {
  using C = typename Compute<T>::type;
  if (!march_args_ok<T>(n, ci, cw)) return cudaErrorInvalidValue;
  const auto q = make_params<T>(n, inv, alpha, beta, mask);
  const dim3 grid((n[2] + J1_TK - 1) / J1_TK, (n[1] + J1_TJ - 1) / J1_TJ,
                  vdim * ((n[0] + ci - 1) / ci));
  const T* xp = static_cast<const T*>(x);
  const T* bp = static_cast<const T*>(b);
  T* op = static_cast<T*>(out);
  C* pp = static_cast<C*>(partial);
  if (j1_full(n)) {
    if (pp) return launch_j1_kernel<T, true, true>(grid, s, xp, bp, op, pp, q, ci, cw);
    return launch_j1_kernel<T, false, true>(grid, s, xp, bp, op, pp, q, ci, cw);
  }
  if (pp) return launch_j1_kernel<T, true, false>(grid, s, xp, bp, op, pp, q, ci, cw);
  return launch_j1_kernel<T, false, false>(grid, s, xp, bp, op, pp, q, ci, cw);
}

template <typename T, bool DOT, bool FULL>
cudaError_t j1_occupancy(int* blocks) {
  const cudaError_t e = j1_prepare<T, DOT, FULL>();
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, jacobi3d_kernel<T, DOT, FULL>,
                                                       J1_THREADS, j1_smem_bytes<T>());
}

template <typename T>
cudaError_t j1_occupancy(int dot, int full, int* blocks) {
  if (full) {
    return dot ? j1_occupancy<T, true, true>(blocks) : j1_occupancy<T, false, true>(blocks);
  }
  return dot ? j1_occupancy<T, true, false>(blocks) : j1_occupancy<T, false, false>(blocks);
}

// Opt the double-sweep kernel of (T, FROM_ZERO, DOT) in to its dynamic
// shared memory.
template <typename T, bool FROM_ZERO, bool DOT>
cudaError_t x2_prepare() {
  static unsigned done = 0;
  return opt_in_smem(jacobi3d_x2_kernel<T, FROM_ZERO, DOT>, x2_smem_bytes<T>(), done);
}

template <typename T, bool FROM_ZERO, bool DOT>
cudaError_t launch_x2_kernel(dim3 grid, cudaStream_t s, const T* x, const T* b, T* out,
                             typename Compute<T>::type* partial,
                             const Params<typename Compute<T>::type>& q, int ci, int cw) {
  const cudaError_t e = x2_prepare<T, FROM_ZERO, DOT>();
  if (e != cudaSuccess) return e;
  jacobi3d_x2_kernel<T, FROM_ZERO, DOT><<<grid, X2_THREADS, x2_smem_bytes<T>(), s>>>(
      x, b, out, partial, q, ci, cw);
  return cudaGetLastError();
}

template <typename T, bool FROM_ZERO, bool DOT>
cudaError_t x2_occupancy(int* blocks) {
  const cudaError_t e = x2_prepare<T, FROM_ZERO, DOT>();
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, jacobi3d_x2_kernel<T, FROM_ZERO, DOT>, X2_THREADS, x2_smem_bytes<T>());
}

template <typename T>
cudaError_t x2_occupancy(int from_zero, int dot, int* blocks) {
  if (from_zero) {
    return dot ? x2_occupancy<T, true, true>(blocks) : x2_occupancy<T, true, false>(blocks);
  }
  return dot ? x2_occupancy<T, false, true>(blocks) : x2_occupancy<T, false, false>(blocks);
}

template <typename T>
cudaError_t launch_x2(int vdim, const int* n, const void* x, const void* b,
                      void* out, void* partial, const double* inv, double beta,
                      int mask, int from_zero, int ci, int cw, cudaStream_t s) {
  using C = typename Compute<T>::type;
  if (!march_args_ok<T>(n, ci, cw)) return cudaErrorInvalidValue;
  const auto q = make_params<T>(n, inv, 1.0, beta, mask);
  const dim3 grid((n[2] + X2_TK - 1) / X2_TK, (n[1] + X2_TJ - 1) / X2_TJ,
                  vdim * ((n[0] + ci - 1) / ci));
  const T* xp = static_cast<const T*>(x);
  const T* bp = static_cast<const T*>(b);
  T* op = static_cast<T*>(out);
  C* pp = static_cast<C*>(partial);
  if (from_zero) {
    if (pp) return launch_x2_kernel<T, true, true>(grid, s, xp, bp, op, pp, q, ci, cw);
    return launch_x2_kernel<T, true, false>(grid, s, xp, bp, op, pp, q, ci, cw);
  }
  if (pp) return launch_x2_kernel<T, false, true>(grid, s, xp, bp, op, pp, q, ci, cw);
  return launch_x2_kernel<T, false, false>(grid, s, xp, bp, op, pp, q, ci, cw);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = float64, 2 = bfloat16. x, b, out: (vdim, n0, n1,
// n2) C-contiguous on the device. ci: planes per block along axis 0. cw:
// bytes per staging copy, 16, 8 or 4 (at least the dtype's size; n2 *
// sizeof(dtype) and the base pointers of x and b multiples of it), or 0
// for element loads. n1 * n2 must fit an int. partial: NULL, or one
// compute-dtype value (f32 for bf16/f32, f64 for f64) per block, vdim *
// ceil(n0/ci) * ceil(n1/16) * ceil(n2/128) of them, component-major.
// mask: bit a set masks axis a. Returns cudaGetLastError() after the
// launch (0 on success); launches on `stream`, does not synchronise and
// allocates nothing.
int pyapes_jacobi3d(int dtype, int vdim, int n0, int n1, int n2, const void* x,
                    const void* b, void* out, void* partial, double inv0,
                    double inv1, double inv2, double alpha, double beta,
                    int mask, int ci, int cw, void* stream) {
  const int n[3] = {n0, n1, n2};
  const double inv[3] = {inv0, inv1, inv2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_jacobi<float>(vdim, n, x, b, out, partial, inv, alpha, beta, mask, ci, cw, s);
  if (dtype == 1) return launch_jacobi<double>(vdim, n, x, b, out, partial, inv, alpha, beta, mask, ci, cw, s);
  if (dtype == 2) return launch_jacobi<__nv_bfloat16>(vdim, n, x, b, out, partial, inv, alpha, beta, mask, ci, cw, s);
  return cudaErrorInvalidValue;
}

// Blocks of the single sweep (dtype as above; dot: a partial is written;
// full: the kernel of grids whose every tile lies inside, n1 % 16 == 0 and
// n2 % 128 == 0) that one SM of the current device holds at once, into
// *blocks. Returns a CUDA error code (0 on success).
int pyapes_jacobi3d_blocks_per_sm(int dtype, int dot, int full, int* blocks) {
  if (dtype == 0) return j1_occupancy<float>(dot, full, blocks);
  if (dtype == 1) return j1_occupancy<double>(dot, full, blocks);
  if (dtype == 2) return j1_occupancy<__nv_bfloat16>(dot, full, blocks);
  return cudaErrorInvalidValue;
}

// As pyapes_jacobi3d for the double sweep; x is not read (may be NULL) when
// from_zero. ci: planes per block along axis 0. cw: bytes per staging copy,
// 16, 8 or 4 (at least the dtype's size; n2 * sizeof(dtype) and the base
// pointers of x and b multiples of it), or 0 for element loads. n1 * n2
// must fit an int. partial: NULL, or vdim * ceil(n0/ci) * ceil(n1/14) *
// ceil(n2/64) values (one per block), component-major.
int pyapes_jacobi3d_x2(int dtype, int vdim, int n0, int n1, int n2, const void* x,
                       const void* b, void* out, void* partial, double inv0,
                       double inv1, double inv2, double beta, int mask,
                       int from_zero, int ci, int cw, void* stream) {
  const int n[3] = {n0, n1, n2};
  const double inv[3] = {inv0, inv1, inv2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_x2<float>(vdim, n, x, b, out, partial, inv, beta, mask, from_zero, ci, cw, s);
  if (dtype == 1) return launch_x2<double>(vdim, n, x, b, out, partial, inv, beta, mask, from_zero, ci, cw, s);
  if (dtype == 2) return launch_x2<__nv_bfloat16>(vdim, n, x, b, out, partial, inv, beta, mask, from_zero, ci, cw, s);
  return cudaErrorInvalidValue;
}

// Blocks of the double sweep (dtype, from_zero, dot as above; dot: a
// partial is written) that one SM of the current device holds at once,
// into *blocks. Returns a CUDA error code (0 on success).
int pyapes_jacobi3d_x2_blocks_per_sm(int dtype, int from_zero, int dot, int* blocks) {
  if (dtype == 0) return x2_occupancy<float>(from_zero, dot, blocks);
  if (dtype == 1) return x2_occupancy<double>(from_zero, dot, blocks);
  if (dtype == 2) return x2_occupancy<__nv_bfloat16>(from_zero, dot, blocks);
  return cudaErrorInvalidValue;
}

}  // extern "C"
