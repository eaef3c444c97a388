// The per-axis stencil apply as a 2.5-D plane march on Hopper (sm_90a),
// for 3-D grids from the wrapper's threshold up (ops/axis_stencil.py
// chooses by shape; the per-point kernels of small, 1-D and 2-D grids are
// in csrc/axis_stencil.cu):
//
//   out[d, i, j, k] = sum_a sum_{o = -R..R} c_{a,o}[i_a] x[.., i_a + o mod n_a, ..]
//
// of radius R = 1 (3-point axes: axis_stencil; replaces
// pallas_stencil.py::pallas_axis_stencil, pallas_stencil_db.py::
// pallas_axis_stencil_db and pallas_stencil_v3.py::pallas_axis_stencil_v3)
// or R = 2 (5-point QUICK axes mixed with 3-point ones: axis_stencil5;
// replaces pallas_stencil_v3.py::pallas_axis_stencil_v5). Two more
// instances of the radius-1 march:
//
//   axis_march_dot_kernel   the apply plus one partial sum(x * A x) per
//     block, from the unrounded A x (axis_stencil_dot, the CG alpha-dot;
//     replaces pallas_stencil_db.py::pallas_axis_stencil_dot and
//     pallas_stencil_v3.py::pallas_axis_stencil_dot_v3);
//   axis_march_ext_kernel   the apply on one block of a domain
//     decomposition, x extended by one ghost row per side of axis 0 and/or
//     1 (no wrap on an extended axis), the output written through strides
//     into the block's view of the global result (axis_stencil_ext;
//     replaces pallas_stencil_v3.py::pallas_axis_stencil_ext).
//
// This file is built once per storage dtype and radius (-DAM_DTYPE=0 f32,
// 1 f64, 2 bf16; -DAM_R=1|2) and once per storage dtype for each of the two
// radius-1 instances (-DAM_R=1 -DAM_KIND=1 dot, 2 halo-extended), the
// builds started together, and linked with axis_stencil.cu into one
// library.
//
// What bounds it: 2R+1 multiply-adds per axis and point against 2 grids of
// compulsory traffic (read x, write out): HBM. The design is jacobi3d.cu's
// single sweep with a reach of R and per-axis coefficient vectors: a march
// along axis 0 (the outermost, stride n1 n2; k is contiguous). Each block
// owns a 16 x 128 column tile of outputs in (j, k) and a chunk of `ci`
// consecutive planes i0 .. i1-1 of ONE component (axis 0 wraps within its
// component). Per plane p it stages x, with 16-byte cp.async copies (8 or
// 4 where the rows allow no 16, element loads for bf16 rows of odd
// length), on the window of rows j0-R .. j0+16+R-1 and columns k0-HK ..
// k0+128+HK-1 (HK = 16 bytes of elements >= R) into a ring of 2R+2 slots,
// issued two steps before its first use (x(p+R+2) at step p; deeper rings
// and a 3-block register cap were no faster at 512^3). Where the grid ends
// inside the tile only its rows and columns (+-R) are staged. A thread
// owns two adjacent columns in 4 consecutive rows (2 warps side by side
// along k, 4 along j), reads x and writes out as pairs, and keeps x(p-R)
// .. x(p+R-1) of its points in registers along the march, so each plane of
// x is read from HBM about once (through its window 1.20x in f32 at R = 1,
// 1.33x at R = 2, the rest from L2). Coefficients are never read per
// point: axis 0's 2R+1 scalars once per plane (uniform, loaded a plane
// ahead), axis 1's for the thread's rows and axis 2's for its columns in
// registers for the whole march. The window's wrapped row offsets and
// columns are one table per block (a 3-node axis wraps the +-2 reach
// twice: the table's % gives what torch.roll gives); axis 0's wrap is one
// uniform scalar per plane: no % and no 64-bit index product in the
// per-point loop. A 3-point axis of a radius-2 march skips its +-2 taps on
// a block-uniform bit. A grid whose every tile lies inside it (n1 % 16 ==
// 0, n2 % 128 == 0) takes the FULL instance, whose window bounds are
// compile-time constants (as jacobi3d.cu records, runtime bounds slow the
// large march).
//
// A point is the per-point kernels' expression, term for term (am_point):
// axis 0, 1, 2 in the plain version's order, in promote(dtype, f32),
// rounded once on store; the same bits as the per-point kernel (checked on
// the card), so the shape's choice of kernel changes no solve, and the
// same bits at every chunk and on every call.

#include "axis_march.cuh"
#include "march.cuh"

#if !defined(AM_DTYPE) || !defined(AM_R)
#error "axis_march.cu is built with -DAM_DTYPE=0|1|2 -DAM_R=1|2 [-DAM_KIND=1|2] (ops/cuda_build.py)"
#endif
#ifndef AM_KIND
#define AM_KIND 0
#endif
#if AM_KIND != 0 && AM_R != 1
#error "the dot and halo-extended instances of axis_march.cu are radius 1"
#endif

namespace pyapes {
namespace {

constexpr int AM_WK = 2, AM_WJ = 4;                         // warps along k, along j
constexpr int AM_THREADS = 32 * AM_WK * AM_WJ;              // 256
constexpr int AM_ROWS = 4;                                  // rows per thread
constexpr int AM_TJ = AM_WJ * AM_ROWS, AM_TK = 64 * AM_WK;  // output tile (16 x 128)
constexpr int AM_AHEAD = 2;  // planes in flight beyond the one a step waits for
enum : int { AM_APPLY = 0, AM_DOT = 1, AM_EXT = 2 };  // the instances (-DAM_KIND)

template <typename T>
__host__ __device__ constexpr int am_hk() {  // k halo of the window: 16 bytes
  return 16 / int(sizeof(T));
}
template <typename T>
__host__ __device__ constexpr int am_w() {  // window row
  return AM_TK + 2 * am_hk<T>();
}
template <typename T>
__host__ __device__ constexpr int am_min_blocks() {  // per SM: <= 128 registers, f64 unbounded
  return sizeof(T) == 8 ? 1 : 2;
}
template <typename T, int R>
constexpr size_t am_smem_bytes() {  // the ring (2R + AM_AHEAD window slots) and the tables
  return (2 * R + AM_AHEAD) * size_t(AM_TJ + 2 * R) * am_w<T>() * sizeof(T) +
         (AM_TJ + 2 * R + am_w<T>()) * sizeof(int);
}

// One point of the apply from its coefficients cf[a][m] and neighbours
// xv[a][m] (axis a, offset R - m) and its centre xc, written term for term
// as the per-point kernels write it (csrc/axis_stencil.cu: stencil_at at
// R = 1, axis_stencil5_kernel at R = 2), so that nvcc contracts it into the
// same fma's: the same bits as the per-point kernel, whichever kernel the
// shape takes. five: bit a, axis a is 5-point.
template <int R, typename C>
__device__ __forceinline__ C am_point(const C (&cf)[3][2 * R + 1], const C (&xv)[3][2 * R + 1],
                                      C xc, unsigned five) {
  if constexpr (R == 1) {
    C acc = cf[0][0] * xv[0][0] + cf[0][1] * xc + cf[0][2] * xv[0][2];
    acc += cf[1][0] * xv[1][0] + cf[1][1] * xc + cf[1][2] * xv[1][2];
    acc += cf[2][0] * xv[2][0] + cf[2][1] * xc + cf[2][2] * xv[2][2];
    return acc;
  } else {
    C acc = C(0);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      acc += cf[a][1] * xv[a][1] + cf[a][2] * xc + cf[a][3] * xv[a][3];
      if (five >> a & 1u) acc += cf[a][0] * xv[a][0] + cf[a][4] * xv[a][4];
    }
    return acc;
  }
}

// The march of one block; KIND: AM_APPLY, AM_DOT (also the block's
// partial of sum(x * A x) into partial), AM_EXT (x halo-extended, the
// output through e's strides).
template <typename T, int R, bool FULL, int KIND>
__device__ __forceinline__ void am_body(const T* __restrict__ x, T* __restrict__ out,
                                        typename Compute<T>::type* __restrict__ partial,
                                        const AxisMarchParams<T>& q, const AxisMarchExt& e,
                                        int ci, int cw) {
  using C = typename Compute<T>::type;
  constexpr bool EXT = KIND == AM_EXT;
  constexpr int NT = AM_THREADS, RW = AM_ROWS, TJ = AM_TJ, TK = AM_TK;
  constexpr int HK = am_hk<T>(), W = am_w<T>(), XJ = TJ + 2 * R, XPL = XJ * W;
  constexpr int D = AM_AHEAD, S = 2 * R + D, M = 2 * R + 1;  // ring slots; taps per axis
  constexpr int NP = 2 * RW;  // a thread's points (pairs of RW rows)
  static_assert(HK >= R, "the window's k halo covers the reach");
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);
  int* rowoff = reinterpret_cast<int*>(xs + S * XPL);  // window row -> j * n2
  int* kcol = rowoff + XJ;                             // window column -> k

  const int t = threadIdx.x;
  const int n0 = q.n[0], n1 = q.n[1], n2 = q.n[2];
  const int nch = (n0 + ci - 1) / ci;
  const int d = blockIdx.z / nch;
  const int i0 = (blockIdx.z - d * nch) * ci, i1 = min(i0 + ci, n0);
  const int j0 = blockIdx.y * TJ, k0 = blockIdx.x * TK;
  const int64_t plane = (int64_t)n1 * n2, vol = n0 * plane;
  // ghost rows per side of axes 0 and 1 (EXT), x's plane stride
  const int e0 = EXT ? e.e0 : 0, e1 = EXT ? e.e1 : 0;
  const int64_t xplane = EXT ? (int64_t)(n1 + 2 * e1) * n2 : plane;
  const T* xd = x + d * (EXT ? (n0 + 2 * e0) * xplane : vol);
  // the output's plane and row strides
  const int64_t os0 = EXT ? e.os0 : plane, os1 = EXT ? e.os1 : n2;
  T* od = out + d * (EXT ? e.os_v : vol);

  // window row -> x row offset: the ghost rows of an extended axis 1, else
  // the wrap
  for (int h = t; h < XJ + W; h += NT) {
    if (h < XJ) rowoff[h] = (e1 ? j0 - R + e1 + h : wrap(j0 - R + h, n1)) * n2;
    else kcol[h - XJ] = wrap(k0 - HK + h - XJ, n2);
  }
  __syncthreads();

  auto wrap_i = [&](int p) { return p < 0 ? p + n0 : (p >= n0 ? p - n0 : p); };
  auto slot = [](int p) { return (p + S) % S; };  // p >= -R
  // the window the block's points need (jacobi3d.cu): rows and columns
  // inside the grid (+-R); FULL: the whole window, bounds known to the
  // compiler
  const int tr = FULL ? TJ : min(TJ, n1 - j0);
  const int tc = FULL ? TK : min(TK, n2 - k0);
  auto chunks = [&](int v) { return (HK + tc + R + v - 1) / v; };  // window copies per row
  constexpr int V16 = 16 / int(sizeof(T));
  constexpr int NXC = XPL / V16, NX16 = (NXC + NT - 1) / NT;
  int gx16[NX16];
  unsigned okx = 0;  // bit u: copy u is in the needed window
  {
    const int cx = chunks(V16);
#pragma unroll
    for (int u = 0; u < NX16; ++u) {
      const int c = t + u * NT, r = c / (W / V16), h = c - r * (W / V16);
      gx16[u] = c < NXC ? rowoff[r] + kcol[h * V16] : 0;
      if (c < NXC && r < tr + 2 * R && h < cx) okx |= 1u << u;
    }
  }
  // stage plane p of x on the window, cw bytes per copy (16, 8, 4; 0:
  // element loads)
  auto stage = [&](int p) {
    T* dst = xs + slot(p) * XPL;
    const T* src = xd + (e0 ? p + e0 : wrap_i(p)) * xplane;  // EXT axis 0: the ghost planes
    if (cw == 16) {
#pragma unroll
      for (int u = 0; u < NX16; ++u) {
        if (okx >> u & 1u) cp_async<16>(dst + (t + u * NT) * V16, src + gx16[u]);
      }
    } else if (cw == 8) {
      constexpr int V = 8 / int(sizeof(T));
      stage_window<V, W, NT>(dst, src, rowoff, kcol, tr + 2 * R, chunks(V), 0, t);
    } else if (cw == 4) {
      if constexpr (sizeof(T) <= 4) {
        constexpr int V = 4 / int(sizeof(T));
        stage_window<V, W, NT>(dst, src, rowoff, kcol, tr + 2 * R, chunks(V), 0, t);
      }
    } else {
      stage_window<1, W, NT>(dst, src, rowoff, kcol, tr + 2 * R, chunks(1), 0, t);
    }
  };

  // tap m = 0 .. 2R of an axis is the offset R - m (coefficient vector
  // m + 2 - R of the five); a 3-point axis of a radius-2 march has no taps
  // 0 and 2R (a block-uniform bit; their coefficients are not loaded)
  const unsigned five = R == 2 ? unsigned(q.five) : 0u;
  auto on = [&](int a, int m) { return R == 1 || (m != 0 && m != 2 * R) || (five >> a & 1u); };
  auto coeff = [&](int a, int m, int i) { return to_c(q.c[a][m + 2 - R][i]); };

  // this thread's points: tile rows tj0 .. tj0+RW-1, columns k0+kk,
  // k0+kk+1; point 2r+c is row r, column c
  const int w = t >> 5;
  const int kk = 64 * (w % AM_WK) + 2 * (t & 31), tj0 = (w / AM_WK) * RW;
  const int xo = (tj0 + R) * W + HK + kk;  // its first pair in a slot
  C c1[RW][M], c2[2][M];                   // axis 1 per row, axis 2 per column
  unsigned live = 0;                       // bit 2r+c: inside the grid
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int gj = j0 + tj0 + r;
#pragma unroll
    for (int m = 0; m < M; ++m) c1[r][m] = gj < n1 && on(1, m) ? coeff(1, m, gj) : C(0);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      if (gj < n1 && k0 + kk + c < n2) live |= 1u << (2 * r + c);
    }
  }
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int gk = k0 + kk + c;
#pragma unroll
    for (int m = 0; m < M; ++m) c2[c][m] = gk < n2 && on(2, m) ? coeff(2, m, gk) : C(0);
  }
  const bool pair_store = EXT ? e.pair != 0 : (n2 & 1) == 0;
  const int64_t orow = (int64_t)(j0 + tj0) * os1 + k0 + kk;  // its first point in a plane

  // prologue: x(i0-R) .. x(i0+R-1) now; then the groups G(p) = {x(p+R)}
  // for p = i0 .. i0+D-1, so that step p waits only for G(p)
#pragma unroll
  for (int m = 0; m < 2 * R; ++m) stage(i0 - R + m);
  cp_async_commit();
#pragma unroll
  for (int g = 0; g < D; ++g) {
    if (i0 + g < i1) stage(i0 + R + g);
    cp_async_commit();
  }
  cp_async_wait<D>();
  __syncthreads();

  C xr[2 * R][NP];  // x(p-R) .. x(p+R-1) at this thread's points
#pragma unroll
  for (int m = 0; m < 2 * R; ++m) {
    const T* s = xs + slot(i0 - R + m) * XPL + xo;
#pragma unroll
    for (int r = 0; r < RW; ++r) load2(s + r * W, xr[m][2 * r], xr[m][2 * r + 1]);
  }
  C ca[M];  // axis 0 at plane p
#pragma unroll
  for (int m = 0; m < M; ++m) ca[m] = on(0, m) ? coeff(0, m, i0) : C(0);

  C prod = C(0);  // DOT: sum x * A x over this thread's points
  for (int p = i0; p < i1; ++p) {
    cp_async_wait<D - 1>();  // G(p): x(p+R)
    __syncthreads();         // ... from every thread; step p-R done with the slot
                             // refilled below (one barrier a step)
    if (p + D < i1) stage(p + R + D);
    cp_async_commit();

    C cn[M];  // axis 0 at plane p+1, a plane ahead of use
    const int pn = p + 1 < i1 ? p + 1 : p;
#pragma unroll
    for (int m = 0; m < M; ++m) cn[m] = on(0, m) ? coeff(0, m, pn) : C(0);
    const T* xsc = xs + slot(p) * XPL + xo;      // x(p) at this thread's first pair
    const T* xsn = xs + slot(p + R) * XPL + xo;  // x(p+R)
    C xn[NP], ab[2 * R][2];  // x(p+R); x(p) on the R rows above and the R below
#pragma unroll
    for (int r = 0; r < RW; ++r) load2(xsn + r * W, xn[2 * r], xn[2 * r + 1]);
#pragma unroll
    for (int h = 0; h < R; ++h) {
      load2(xsc + (h - R) * W, ab[h][0], ab[h][1]);
      load2(xsc + (RW + h) * W, ab[R + h][0], ab[R + h][1]);
    }
    T* dst = od + p * os0 + orow;
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      // x(p) left and right of the pair: columns -2, -1 and 2, 3
      C lk[2] = {C(0), C(0)}, rk[2] = {C(0), C(0)};
      if constexpr (R == 1) {
        lk[1] = to_c(xsc[r * W - 1]);
        rk[0] = to_c(xsc[r * W + 2]);
      } else {
        load2(xsc + r * W - 2, lk[0], lk[1]);
        load2(xsc + r * W + 2, rk[0], rk[1]);
      }
      C v[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int u = 2 * r + c;
        C cf[3][M], xv[3][M];  // per axis and tap m: coefficient, x at offset R - m
#pragma unroll
        for (int m = 0; m < M; ++m) {
          const int rr = r + R - m, cc = c + R - m;
          cf[0][m] = ca[m];
          cf[1][m] = c1[r][m];
          cf[2][m] = c2[c][m];
          xv[0][m] = m == 0 ? xn[u] : xr[2 * R - m][u];  // plane p + R - m
          xv[1][m] = rr < 0 ? ab[rr + R][c] : (rr >= RW ? ab[R + rr - RW][c] : xr[R][2 * rr + c]);
          xv[2][m] = cc < 0 ? lk[cc + 2] : (cc > 1 ? rk[cc - 2] : xr[R][2 * r + cc]);
        }
        v[c] = am_point<R>(cf, xv, xr[R][u], five);
      }
      const unsigned lv = live >> (2 * r) & 3u;
      if (lv == 3u && pair_store) {
        store2(dst, v[0], v[1]);
      } else {
        if (lv & 1u) store(dst, v[0]);
        if (lv & 2u) store(dst + 1, v[1]);
      }
      if constexpr (KIND == AM_DOT) {  // x(p) times the unrounded A x
        if (lv & 1u) prod = fma(xr[R][2 * r], v[0], prod);
        if (lv & 2u) prod = fma(xr[R][2 * r + 1], v[1], prod);
      }
      dst += os1;
    }
#pragma unroll
    for (int u = 0; u < NP; ++u) {
#pragma unroll
      for (int m = 0; m + 1 < 2 * R; ++m) xr[m][u] = xr[m + 1][u];
      xr[2 * R - 1][u] = xn[u];
    }
#pragma unroll
    for (int m = 0; m < M; ++m) ca[m] = cn[m];
  }
  if constexpr (KIND == AM_DOT) {
    const C s = block_sum<NT>(prod);
    if (t == 0) {
      partial[((int64_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] = s;
    }
  }
}

template <typename T, int R, bool FULL>
__global__ void __launch_bounds__(AM_THREADS, am_min_blocks<T>())
axis_march_kernel(const T* __restrict__ x, T* __restrict__ out, AxisMarchParams<T> q, int ci,
                  int cw) {
  am_body<T, R, FULL, AM_APPLY>(x, out, nullptr, q, AxisMarchExt{}, ci, cw);
}

template <typename T, bool FULL>
__global__ void __launch_bounds__(AM_THREADS, am_min_blocks<T>())
axis_march_dot_kernel(const T* __restrict__ x, T* __restrict__ out,
                      typename Compute<T>::type* __restrict__ partial, AxisMarchParams<T> q,
                      int ci, int cw) {
  am_body<T, 1, FULL, AM_DOT>(x, out, partial, q, AxisMarchExt{}, ci, cw);
}

template <typename T, bool FULL>
__global__ void __launch_bounds__(AM_THREADS, am_min_blocks<T>())
axis_march_ext_kernel(const T* __restrict__ x, T* __restrict__ out, AxisMarchParams<T> q,
                      AxisMarchExt e, int ci, int cw) {
  am_body<T, 1, FULL, AM_EXT>(x, out, nullptr, q, e, ci, cw);
}

// The instance (T, R, FULL, KIND), opted in to its dynamic shared memory
// once per device.
template <typename T, int R, bool FULL, int KIND>
auto am_kernel() {
  if constexpr (KIND == AM_DOT) return axis_march_dot_kernel<T, FULL>;
  else if constexpr (KIND == AM_EXT) return axis_march_ext_kernel<T, FULL>;
  else return axis_march_kernel<T, R, FULL>;
}

template <typename T, int R, bool FULL, int KIND>
cudaError_t am_prepare() {
  static unsigned done = 0;
  return opt_in_smem(am_kernel<T, R, FULL, KIND>(), am_smem_bytes<T, R>(), done);
}

template <typename T, int R, bool FULL, int KIND, typename... A>
cudaError_t am_launch(dim3 grid, cudaStream_t s, A... args) {
  const cudaError_t e = am_prepare<T, R, FULL, KIND>();
  if (e != cudaSuccess) return e;
  constexpr size_t smem = am_smem_bytes<T, R>();
  if constexpr (KIND == AM_DOT) {
    axis_march_dot_kernel<T, FULL><<<grid, AM_THREADS, smem, s>>>(args...);
  } else if constexpr (KIND == AM_EXT) {
    axis_march_ext_kernel<T, FULL><<<grid, AM_THREADS, smem, s>>>(args...);
  } else {
    axis_march_kernel<T, R, FULL><<<grid, AM_THREADS, smem, s>>>(args...);
  }
  return cudaGetLastError();
}

template <typename T, int R, int KIND>
cudaError_t am_occupancy(bool full, int* blocks) {
  const cudaError_t e = full ? am_prepare<T, R, true, KIND>() : am_prepare<T, R, false, KIND>();
  if (e != cudaSuccess) return e;
  return full ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    blocks, am_kernel<T, R, true, KIND>(), AM_THREADS, am_smem_bytes<T, R>())
              : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    blocks, am_kernel<T, R, false, KIND>(), AM_THREADS, am_smem_bytes<T, R>());
}

// The launch of instance KIND on the (vdim, n0, n1, n2) output grid q.n:
// the FULL instance where every tile lies inside it.
template <typename T, int R, int KIND, typename... A>
cudaError_t am_dispatch(int vdim, const AxisMarchParams<T>& q, int ci, cudaStream_t s,
                        A... args) {
  const dim3 grid((q.n[2] + AM_TK - 1) / AM_TK, (q.n[1] + AM_TJ - 1) / AM_TJ,
                  vdim * ((q.n[0] + ci - 1) / ci));
  if (q.n[1] % AM_TJ == 0 && q.n[2] % AM_TK == 0) {
    return am_launch<T, R, true, KIND>(grid, s, args...);
  }
  return am_launch<T, R, false, KIND>(grid, s, args...);
}

}  // namespace

#if AM_KIND == 0
template <typename T, int R>
cudaError_t axis_march_launch(int vdim, const AxisMarchParams<T>& q, const void* x, void* out,
                              int ci, int cw, cudaStream_t s) {
  if (!march_args_ok<T>(q.n, ci, cw)) return cudaErrorInvalidValue;
  return am_dispatch<T, R, AM_APPLY>(vdim, q, ci, s, static_cast<const T*>(x),
                                     static_cast<T*>(out), q, ci, cw);
}

template <typename T, int R>
cudaError_t axis_march_occupancy(bool full, int* blocks) {
  return am_occupancy<T, R, AM_APPLY>(full, blocks);
}
#elif AM_KIND == 1
template <typename T>
cudaError_t axis_march_dot_launch(int vdim, const AxisMarchParams<T>& q, const void* x,
                                  void* out, void* partial, int ci, int cw, cudaStream_t s) {
  if (!march_args_ok<T>(q.n, ci, cw)) return cudaErrorInvalidValue;
  return am_dispatch<T, 1, AM_DOT>(vdim, q, ci, s, static_cast<const T*>(x), static_cast<T*>(out),
                                   static_cast<typename Compute<T>::type*>(partial), q, ci, cw);
}

template <typename T>
cudaError_t axis_march_dot_occupancy(bool full, int* blocks) {
  return am_occupancy<T, 1, AM_DOT>(full, blocks);
}
#else
template <typename T>
cudaError_t axis_march_ext_launch(int vdim, const AxisMarchParams<T>& q, const AxisMarchExt& e,
                                  const void* x, void* out, int ci, int cw, cudaStream_t s) {
  const int nx[3] = {q.n[0] + 2 * e.e0, q.n[1] + 2 * e.e1, q.n[2]};  // x's extents
  if (!march_args_ok<T>(nx, ci, cw) || ((e.e0 | e.e1) & ~1) != 0) return cudaErrorInvalidValue;
  return am_dispatch<T, 1, AM_EXT>(vdim, q, ci, s, static_cast<const T*>(x), static_cast<T*>(out),
                                   q, e, ci, cw);
}

template <typename T>
cudaError_t axis_march_ext_occupancy(bool full, int* blocks) {
  return am_occupancy<T, 1, AM_EXT>(full, blocks);
}
#endif

#if AM_DTYPE == 0
using AmStorage = float;
#elif AM_DTYPE == 1
using AmStorage = double;
#else
using AmStorage = __nv_bfloat16;
#endif
#if AM_KIND == 0
template cudaError_t axis_march_launch<AmStorage, AM_R>(int, const AxisMarchParams<AmStorage>&,
                                                        const void*, void*, int, int,
                                                        cudaStream_t);
template cudaError_t axis_march_occupancy<AmStorage, AM_R>(bool, int*);
#elif AM_KIND == 1
template cudaError_t axis_march_dot_launch<AmStorage>(int, const AxisMarchParams<AmStorage>&,
                                                      const void*, void*, void*, int, int,
                                                      cudaStream_t);
template cudaError_t axis_march_dot_occupancy<AmStorage>(bool, int*);
#else
template cudaError_t axis_march_ext_launch<AmStorage>(int, const AxisMarchParams<AmStorage>&,
                                                      const AxisMarchExt&, const void*, void*,
                                                      int, int, cudaStream_t);
template cudaError_t axis_march_ext_occupancy<AmStorage>(bool, int*);
#endif

}  // namespace pyapes
