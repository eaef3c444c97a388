// Per-point (spatially varying) advection as a 2.5-D plane march on Hopper
// (sm_90a), for 3-D grids from the wrapper's threshold up (ops/advect.py
// chooses by shape and limiter; the per-point kernel of 1-D, 2-D and small
// grids and of QUICK is csrc/advect.cu):
//
//   out[d] = sum_a  cp x_a(+1) + cc x_a + cm x_a(-1)
//
// with the coefficients of axis a built in registers from its base vectors
// (bp, bc, bm) and its advector u_a: central in the advective form (cp =
// bp u, cc = bc u, cm = bm u), central in the conservative form (cp = bp
// u(+1), cm = bm u(-1)) or upwind, and the boundary-row surgery applied
// in sequence, lower face first, as csrc/advect.cu. Conv (conv_component,
// replaces pallas_advect.py::pallas_conv_component): every target
// component read along every axis, axis a advected by adv[a]. Div
// (advect_pair, replaces pallas_advect.py::pallas_advect_pair): one
// output, a scalar target read along every axis with one advector, or a
// vector target with x[a] read along axis a only. Built once per storage
// dtype (-DAV_DTYPE=0 f32, 1 f64, 2 bf16) and linked with advect.cu.
//
// What bounds it: ~20 operations per point and axis against 3 (Div) to 5
// (Conv) grids of compulsory traffic: HBM. The design is
// csrc/axis_march.cu's at radius 1: a march along axis 0 (stride n1 n2).
// Each block owns a 16 x 128 column tile in (j, k) (8 x 128 in f64) and a
// chunk of `ci` consecutive planes of ONE output component. Per plane it
// stages, with 16-byte cp.async copies (8, 4 or element loads where the
// rows or operands allow no 16), the operands read at a neighbour into a
// 4-slot ring of shared memory (5 for the scalar Div's conservative form,
// whose advector is read from the ring at p-1 too), two planes ahead:
//
//   Conv, and the Div of a scalar target: x on the window of rows -1 ..
//     16 and columns -16 bytes .. 128 + 16 bytes; the conservative central
//     Div also its advector, on the same window;
//   the Div of a vector target: x[1] on the rows +-1 only, x[2] on the
//     columns +-16 bytes only (each component the halo of its own axis),
//     and in the conservative central form u[1] and u[2] likewise; x[0]
//     (and there u[0]) is read along axis 0 only, at the thread's points,
//     with pair loads from device memory, a plane ahead.
//
// An advector read only at the point (Conv; the Div's advective and upwind
// forms) is not staged: each thread reads it at its own points with pair
// loads, once. A thread owns two adjacent columns in 4 consecutive rows (2
// in f64) and keeps x(p-1), x(p) of its points in registers along the
// march, so each plane of x is read from HBM about once. The base vectors
// are never read per point: axis 0's once per plane (uniform, a plane
// ahead), axis 1's per row and axis 2's per column in registers for the
// whole march; the surgery of a row is resolved with them. The window's
// wrapped rows and columns are one table per block and axis 0's wrap one
// uniform scalar per plane: no % and no 64-bit index product in the
// per-point loop. The form and the operands are template arguments (no
// branch on the limiter inside the loop); a grid whose every tile lies
// inside it (n1 % 16 == 0, n2 % 128 == 0) takes the FULL instance, whose
// window bounds are compile-time constants.
//
// A point is the per-point kernel's expression, term for term (av_axis:
// csrc/advect.cu's coefficients, surgery and `t = cp x(+1) + cc x + cm
// x(-1)`, `acc += t` over axes 0, 1, 2), in promote(dtype, f32), rounded
// once on store: the same bits as the per-point kernel (checked on the
// card), so the shape's choice of kernel changes no solve, and the same
// bits at every chunk and on every call.

#include "advect_march.cuh"
#include "march.cuh"

#if !defined(AV_DTYPE)
#error "advect_march.cu is built with -DAV_DTYPE=0|1|2 (ops/cuda_build.py)"
#endif

namespace pyapes {
namespace {

enum Side { NONE = 0, NEUMANN = 1, PERIODIC = 2 };

constexpr int AV_WK = 2, AV_WJ = 4;             // warps along k, along j
constexpr int AV_THREADS = 32 * AV_WK * AV_WJ;  // 256
constexpr int AV_TK = 64 * AV_WK;               // tile columns (128)
constexpr int AV_AHEAD = 2;  // planes in flight beyond the one a step waits for

template <typename T>
__host__ __device__ constexpr int av_rows() {  // rows per thread
  return sizeof(T) == 8 ? 2 : 4;
}
template <typename T>
__host__ __device__ constexpr int av_tj() {  // tile rows
  return AV_WJ * av_rows<T>();
}
template <typename T>
__host__ __device__ constexpr int av_hk() {  // k halo of the window: 16 bytes
  return 16 / int(sizeof(T));
}
template <typename T>
__host__ __device__ constexpr int av_w() {  // window row
  return AV_TK + 2 * av_hk<T>();
}
// Staged operands: 1 (x) or 2 (x, u) full windows for Conv and the scalar
// Div; 2 (x[1] rows, x[2] columns) or 4 (and u[1], u[2]) for the vector Div.
__host__ __device__ constexpr int av_buffers(int kind, int form) {
  return (kind == AV_DIV_V ? 2 : 1) * (form == AV_CONSERVATIVE ? 2 : 1);
}
// Slots of a ring: planes p .. p+1 read and p+2, p+3 in flight at step p;
// the scalar Div's conservative form also keeps u(p-1) in the ring (its
// advector is read from the ring, not from registers).
__host__ __device__ constexpr int av_slots(int kind, int form) {
  return 2 + AV_AHEAD + (kind != AV_DIV_V && form == AV_CONSERVATIVE);
}
template <typename T, int KIND, int FORM>
constexpr size_t av_smem_bytes() {  // the rings and the tables
  return av_slots(KIND, FORM) * size_t(av_buffers(KIND, FORM)) * (av_tj<T>() + 2) * av_w<T>() *
             sizeof(T) +
         (av_tj<T>() + 2 + av_w<T>()) * sizeof(int);
}
// Blocks per SM the registers are capped for: 2 (<= 128 registers) where
// two blocks' rings fit, f64 too (on an H100 at 256^3 f64 the upwind Div
// took 147 µs capped, 184 uncapped; the Conv 240 either way)
template <typename T, int KIND, int FORM>
__host__ __device__ constexpr int av_min_blocks() {
  return av_smem_bytes<T, KIND, FORM>() > 110 * 1024 ? 1 : 2;
}
// Buffer b's operand (0 x, 1 u; of axis a = 0: every axis) and its halo
// (bit 0 rows +-1, bit 1 columns).
__host__ __device__ constexpr int av_buf_axis(int kind, int b) {
  return kind == AV_DIV_V ? 1 + (b & 1) : 0;
}
__host__ __device__ constexpr bool av_buf_is_u(int kind, int b) {
  return kind == AV_DIV_V ? b >= 2 : b == 1;
}
__host__ __device__ constexpr int av_buf_halo(int kind, int b) {
  return kind == AV_DIV_V ? 1 + (b & 1) : 3;
}

// The surgery of index i of an axis of n nodes: the lower face's kind on
// row 1 (bits 0-1), the upper face's on row n-2 (bits 2-3).
__device__ __forceinline__ int av_side(int i, int n, int lo, int up) {
  return (i == 1 ? lo : NONE) | (i == n - 2 ? up : NONE) << 2;
}

// One axis' term at one point, written term for term as the per-point
// kernel writes it (csrc/advect.cu, advect_kernel), so that nvcc contracts
// it into the same fma's: (bp, bc, bm) the axis' base vectors at the
// point's index, ua the advector at the point, uf / ub at +1 / -1 (the
// conservative form only), xf, xc, xb the target at +1, 0, -1, side its
// surgery (av_side).
template <int FORM, typename C>
__device__ __forceinline__ C av_axis(C bp, C bc, C bm, C ua, C uf, C ub, C xf, C xc, C xb,
                                     int side) {
  C cp, cc, cm;
  if constexpr (FORM == AV_UPWIND) {
    const C inv2 = bp < C(0) ? -bp : bp;  // |bp| == 1/(2 dx)
    const C g_min = ua < C(0) ? ua : C(0);
    const C g_max = ua > C(0) ? ua : C(0);
    cp = C(2) * inv2 * g_min;
    cc = C(2) * inv2 * (g_max - g_min) + bc * ua;
    cm = C(-2) * inv2 * g_max;
  } else {
    if constexpr (FORM == AV_CONSERVATIVE) {
      cp = bp * uf;
      cm = bm * ub;
    } else {
      cp = bp * ua;
      cm = bm * ua;
    }
    cc = bc * ua;
  }
  const int lo = side & 3, up = side >> 2;
  if (lo == NEUMANN) {
    const C c0 = cm;
    cc += C(4.0 / 3.0) * c0;
    cp += C(-1.0 / 3.0) * c0;
    cm = C(0);
  } else if (lo == PERIODIC) {
    cm = C(0);
  }
  if (up == NEUMANN) {
    const C c0 = cp;
    cc += C(4.0 / 3.0) * c0;
    cm += C(-1.0 / 3.0) * c0;
    cp = C(0);
  } else if (up == PERIODIC) {
    cp = C(0);
  }
  C t = cp * xf + cc * xc + cm * xb;
  return t;
}

template <typename T, int KIND, int FORM, bool FULL>
__global__ void __launch_bounds__(AV_THREADS, av_min_blocks<T, KIND, FORM>())
advect_march_kernel(T* __restrict__ out, AdvMarchParams<T> q, int ci, int cw) {
  using C = typename Compute<T>::type;
  constexpr int NT = AV_THREADS, RW = av_rows<T>(), TJ = av_tj<T>(), TK = AV_TK;
  constexpr int HK = av_hk<T>(), W = av_w<T>(), XJ = TJ + 2, XPL = XJ * W;
  constexpr int S = av_slots(KIND, FORM), D = AV_AHEAD, NP = 2 * RW;  // NP: a thread's points
  constexpr int NB = av_buffers(KIND, FORM);
  constexpr bool VEC = KIND == AV_DIV_V, CONS = FORM == AV_CONSERVATIVE;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);  // buffer b, slot s at ring + (b S + s) XPL
  int* rowoff = reinterpret_cast<int*>(ring + NB * S * XPL);  // window row -> j * n2
  int* kcol = rowoff + XJ;                                    // window column -> k

  const int t = threadIdx.x;
  const int n0 = q.n[0], n1 = q.n[1], n2 = q.n[2];
  const int nch = (n0 + ci - 1) / ci;
  const int d = blockIdx.z / nch;
  const int i0 = (blockIdx.z - d * nch) * ci, i1 = min(i0 + ci, n0);
  const int j0 = blockIdx.y * TJ, k0 = blockIdx.x * TK;
  const int64_t plane = (int64_t)n1 * n2, vol = n0 * plane;
  const T* xd = q.x[0] + (KIND == AV_CONV ? d * vol : 0);  // Conv / scalar Div: the target
  T* od = out + d * vol;

  for (int e = t; e < XJ + W; e += NT) {
    if (e < XJ) rowoff[e] = wrap(j0 - 1 + e, n1) * n2;
    else kcol[e - XJ] = wrap(k0 - HK + e - XJ, n2);
  }
  __syncthreads();

  auto wrap_i = [&](int p) { return p < 0 ? p + n0 : (p >= n0 ? p - n0 : p); };
  auto slot = [](int p) { return (p + S) % S; };  // p >= -1
  auto buf = [&](int b, int p) { return ring + (b * S + slot(p)) * XPL; };
  auto src = [&](int b) {
    const int a = av_buf_axis(KIND, b);
    return av_buf_is_u(KIND, b) ? q.u[a] : (VEC ? q.x[a] : xd);
  };
  // the window the block's points need (axis_march.cu): rows and columns
  // inside the grid (+-1); FULL: the whole window, bounds known to the
  // compiler
  const int tr = FULL ? TJ : min(TJ, n1 - j0);
  const int tc = FULL ? TK : min(TK, n2 - k0);
  // per halo (bit 0 rows, bit 1 columns): first window row and rows,
  // first copy and copies per row, in copies of v elements
  auto rows0 = [](int halo) { return halo & 1 ? 0 : 1; };
  auto nrows = [&](int halo) { return halo & 1 ? tr + 2 : tr; };
  auto chunk0 = [](int halo, int v) { return halo & 2 ? 0 : HK / v; };
  auto nchunks = [&](int halo, int v) {
    return halo & 2 ? (HK + tc + 1 + v - 1) / v : (HK + tc + v - 1) / v - HK / v;
  };
  constexpr int V16 = 16 / int(sizeof(T));
  constexpr int NXC = XPL / V16, NX16 = (NXC + NT - 1) / NT;
  int gx16[NX16];
  unsigned okx[NB];  // buffer b, bit u: copy u is in its needed window
#pragma unroll
  for (int b = 0; b < NB; ++b) okx[b] = 0;
#pragma unroll
  for (int u = 0; u < NX16; ++u) {
    const int c = t + u * NT, r = c / (W / V16), h = c - r * (W / V16);
    gx16[u] = c < NXC ? rowoff[r] + kcol[h * V16] : 0;
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const int halo = av_buf_halo(KIND, b), h0 = chunk0(halo, V16), r0 = rows0(halo);
      if (c < NXC && r >= r0 && r < r0 + nrows(halo) && h >= h0 && h < h0 + nchunks(halo, V16))
        okx[b] |= 1u << u;
    }
  }
  // stage plane p of every buffer on its window, cw bytes per copy (16,
  // 8, 4; 0: element loads)
  auto stage = [&](int p) {
    const int64_t po = wrap_i(p) * plane;
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      T* dst = buf(b, p);
      const T* s = src(b) + po;
      const int halo = av_buf_halo(KIND, b), r0 = rows0(halo), nr = nrows(halo);
      if (cw == 16) {
#pragma unroll
        for (int u = 0; u < NX16; ++u) {
          if (okx[b] >> u & 1u) cp_async<16>(dst + (t + u * NT) * V16, s + gx16[u]);
        }
      } else if (cw == 8) {
        constexpr int V = 8 / int(sizeof(T));
        const int h0 = chunk0(halo, V);
        stage_window<V, W, NT>(dst + r0 * W + h0 * V, s, rowoff, kcol + h0 * V, nr,
                               nchunks(halo, V), r0, t);
      } else if (cw == 4) {
        if constexpr (sizeof(T) <= 4) {
          constexpr int V = 4 / int(sizeof(T));
          const int h0 = chunk0(halo, V);
          stage_window<V, W, NT>(dst + r0 * W + h0 * V, s, rowoff, kcol + h0 * V, nr,
                                 nchunks(halo, V), r0, t);
        }
      } else {
        const int h0 = chunk0(halo, 1);
        stage_window<1, W, NT>(dst + r0 * W + h0, s, rowoff, kcol + h0, nr, nchunks(halo, 1),
                               r0, t);
      }
    }
  };

  // this thread's points: tile rows tj0 .. tj0+RW-1, columns k0+kk,
  // k0+kk+1; point 2r+c is row r, column c
  const int w = t >> 5;
  const int kk = 64 * (w % AV_WK) + 2 * (t & 31), tj0 = (w / AV_WK) * RW;
  const int xo = (tj0 + 1) * W + HK + kk;  // its first pair in a slot
  C c1[RW][3], c2[2][3];                   // base vectors: axis 1 per row, axis 2 per column
  int s1[RW], s2[2];                       // their surgery (av_side)
  unsigned live = 0;                       // bit 2r+c: inside the grid
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int gj = j0 + tj0 + r;
#pragma unroll
    for (int m = 0; m < 3; ++m) c1[r][m] = gj < n1 ? to_c(q.b[1][m][gj]) : C(0);
    s1[r] = gj < n1 ? av_side(gj, n1, q.lo[1], q.up[1]) : NONE;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      if (gj < n1 && k0 + kk + c < n2) live |= 1u << (2 * r + c);
    }
  }
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int gk = k0 + kk + c;
#pragma unroll
    for (int m = 0; m < 3; ++m) c2[c][m] = gk < n2 ? to_c(q.b[2][m][gk]) : C(0);
    s2[c] = gk < n2 ? av_side(gk, n2, q.lo[2], q.up[2]) : NONE;
  }
  const bool pair_store = (n2 & 1) == 0;
  const int64_t orow = (int64_t)(j0 + tj0) * n2 + k0 + kk;  // its first point in a plane
  // an operand at the thread's points of plane p, from device memory
  auto gload = [&](const T* base, int p, C (&v)[NP]) {
    const T* s = base + wrap_i(p) * plane + orow;
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const unsigned lv = live >> (2 * r) & 3u;
      if (lv == 3u && q.pairs) {
        load2(s + r * n2, v[2 * r], v[2 * r + 1]);
      } else {
        v[2 * r] = lv & 1u ? to_c(s[r * n2]) : C(0);
        v[2 * r + 1] = lv & 2u ? to_c(s[r * n2 + 1]) : C(0);
      }
    }
  };
  auto sload = [&](const T* s, C (&v)[NP]) {  // the same from a slot (s: its first pair)
#pragma unroll
    for (int r = 0; r < RW; ++r) load2(s + r * W, v[2 * r], v[2 * r + 1]);
  };

  // prologue: planes i0-1 and i0 now; then the groups G(p) = {plane p+1}
  // for p = i0 .. i0+D-1, so that step p waits only for G(p)
  stage(i0 - 1);
  stage(i0);
  cp_async_commit();
#pragma unroll
  for (int g = 0; g < D; ++g) {
    if (i0 + g < i1) stage(i0 + 1 + g);
    cp_async_commit();
  }
  // axis 0's operands at the thread's points: x(p-1), x(p) (and the vector
  // Div's u[0])
  C xr[2][NP], ur[2][NP];
  if constexpr (VEC) {
    gload(q.x[0], i0 - 1, xr[0]);
    gload(q.x[0], i0, xr[1]);
    if constexpr (CONS) {
      gload(q.u[0], i0 - 1, ur[0]);
      gload(q.u[0], i0, ur[1]);
    }
  }
  cp_async_wait<D>();
  __syncthreads();
  if constexpr (!VEC) {
    sload(buf(0, i0 - 1) + xo, xr[0]);
    sload(buf(0, i0) + xo, xr[1]);
  }
  C ca[3];  // axis 0 at plane p
#pragma unroll
  for (int m = 0; m < 3; ++m) ca[m] = to_c(q.b[0][m][i0]);

  for (int p = i0; p < i1; ++p) {
    C xn[NP], un[NP];  // axis 0's operands at plane p+1
    // the advector at the points of plane p where only the point reads it
    // (Conv: one per axis; scalar Div: one; vector Div: one per axis),
    // loaded before the step's wait so that the wait hides their latency
    // (loaded a plane ahead instead, the registers spilled: slower)
    constexpr int NU = CONS ? 0 : (KIND == AV_DIV_S ? 1 : 3);
    C uv[NU > 0 ? NU : 1][NP];
    if constexpr (VEC) {
      gload(q.x[0], p + 1, xn);
      if constexpr (CONS) gload(q.u[0], p + 1, un);
    }
#pragma unroll
    for (int a = 0; a < NU; ++a) gload(q.u[a], p, uv[a]);
    cp_async_wait<D - 1>();  // G(p): plane p+1
    __syncthreads();         // ... from every thread; step p-1 done with the slot
                             // refilled below (one barrier a step)
    if (p + D < i1) stage(p + 1 + D);
    cp_async_commit();

    C cn[3];  // axis 0 at plane p+1, a plane ahead of use
    const int pn = p + 1 < i1 ? p + 1 : p;
#pragma unroll
    for (int m = 0; m < 3; ++m) cn[m] = to_c(q.b[0][m][pn]);
    const int s0 = av_side(p, n0, q.lo[0], q.up[0]);
    if constexpr (!VEC) sload(buf(0, p + 1) + xo, xn);
    // scalar target: the staged x at plane p on the rows above and below
    // the thread's rows
    const T* xs = buf(0, p) + xo;
    C xab[2][2];
    if constexpr (!VEC) {
      load2(xs - W, xab[0][0], xab[0][1]);
      load2(xs + RW * W, xab[1][0], xab[1][1]);
    }
    T* dst = od + p * plane + orow;
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      // per point c of the row and axis: the target at +1, 0, -1 and the
      // advector at the point (ua) and at +1 / -1 (conservative form)
      C xf[3][2], xc[3][2], xb[3][2], ua[3][2], uf[3][2], ub[3][2];
      if constexpr (!VEC) {
        const C xl = to_c(xs[r * W - 1]), xrr = to_c(xs[r * W + 2]);  // columns -1 and 2
        // the scalar Div's conservative form: u on the ring at plane p
        // (rows r-1 .. r+1, columns -1 .. 2), p+1 and p-1
        C w1[3][2], w2[4], w0[2][2];
        if constexpr (CONS) {
          const T* us = buf(1, p) + xo + r * W;
          load2(us - W, w1[0][0], w1[0][1]);
          load2(us, w1[1][0], w1[1][1]);
          load2(us + W, w1[2][0], w1[2][1]);
          w2[0] = to_c(us[-1]);
          w2[1] = w1[1][0];
          w2[2] = w1[1][1];
          w2[3] = to_c(us[2]);
          load2(buf(1, p - 1) + xo + r * W, w0[0][0], w0[0][1]);
          load2(buf(1, p + 1) + xo + r * W, w0[1][0], w0[1][1]);
        }
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int u = 2 * r + c;
#pragma unroll
          for (int a = 0; a < 3; ++a) xc[a][c] = xr[1][u];
          xf[0][c] = xn[u];
          xb[0][c] = xr[0][u];
          xf[1][c] = r + 1 < RW ? xr[1][u + 2] : xab[1][c];
          xb[1][c] = r > 0 ? xr[1][u - 2] : xab[0][c];
          xf[2][c] = c == 1 ? xrr : xr[1][u + 1];
          xb[2][c] = c == 0 ? xl : xr[1][u - 1];
          if constexpr (CONS) {
#pragma unroll
            for (int a = 0; a < 3; ++a) ua[a][c] = w1[1][c];
            uf[0][c] = w0[1][c];
            ub[0][c] = w0[0][c];
            uf[1][c] = w1[2][c];
            ub[1][c] = w1[0][c];
            uf[2][c] = w2[2 + c];
            ub[2][c] = w2[c];
          } else {
#pragma unroll
            for (int a = 0; a < 3; ++a) {
              ua[a][c] = uv[KIND == AV_CONV ? a : 0][u];
              uf[a][c] = ub[a][c] = C(0);
            }
          }
        }
      } else {
        // x[1] (and u[1]) on rows r-1, r, r+1; x[2] (and u[2]) on columns
        // -1 .. 2 of the row
        const T* x1 = buf(0, p) + xo + r * W;
        const T* x2 = buf(1, p) + xo + r * W;
        C v1[3][2], v2[4];
        load2(x1 - W, v1[0][0], v1[0][1]);
        load2(x1, v1[1][0], v1[1][1]);
        load2(x1 + W, v1[2][0], v1[2][1]);
        v2[0] = to_c(x2[-1]);
        load2(x2, v2[1], v2[2]);
        v2[3] = to_c(x2[2]);
        C w1[3][2], w2[4];
        if constexpr (CONS) {
          const T* u1 = buf(2, p) + xo + r * W;
          const T* u2 = buf(3, p) + xo + r * W;
          load2(u1 - W, w1[0][0], w1[0][1]);
          load2(u1, w1[1][0], w1[1][1]);
          load2(u1 + W, w1[2][0], w1[2][1]);
          w2[0] = to_c(u2[-1]);
          load2(u2, w2[1], w2[2]);
          w2[3] = to_c(u2[2]);
        }
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int u = 2 * r + c;
          xc[0][c] = xr[1][u];
          xf[0][c] = xn[u];
          xb[0][c] = xr[0][u];
          xc[1][c] = v1[1][c];
          xf[1][c] = v1[2][c];
          xb[1][c] = v1[0][c];
          xc[2][c] = v2[1 + c];
          xf[2][c] = v2[2 + c];
          xb[2][c] = v2[c];
          if constexpr (CONS) {
            ua[0][c] = ur[1][u];
            uf[0][c] = un[u];
            ub[0][c] = ur[0][u];
            ua[1][c] = w1[1][c];
            uf[1][c] = w1[2][c];
            ub[1][c] = w1[0][c];
            ua[2][c] = w2[1 + c];
            uf[2][c] = w2[2 + c];
            ub[2][c] = w2[c];
          } else {
#pragma unroll
            for (int a = 0; a < 3; ++a) {
              ua[a][c] = uv[a][u];
              uf[a][c] = ub[a][c] = C(0);
            }
          }
        }
      }
      C v[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        C acc = C(0);
        acc += av_axis<FORM>(ca[0], ca[1], ca[2], ua[0][c], uf[0][c], ub[0][c], xf[0][c],
                             xc[0][c], xb[0][c], s0);
        acc += av_axis<FORM>(c1[r][0], c1[r][1], c1[r][2], ua[1][c], uf[1][c], ub[1][c],
                             xf[1][c], xc[1][c], xb[1][c], s1[r]);
        acc += av_axis<FORM>(c2[c][0], c2[c][1], c2[c][2], ua[2][c], uf[2][c], ub[2][c],
                             xf[2][c], xc[2][c], xb[2][c], s2[c]);
        v[c] = acc;
      }
      const unsigned lv = live >> (2 * r) & 3u;
      if (lv == 3u && pair_store) {
        store2(dst, v[0], v[1]);
      } else {
        if (lv & 1u) store(dst, v[0]);
        if (lv & 2u) store(dst + 1, v[1]);
      }
      dst += n2;
    }
#pragma unroll
    for (int u = 0; u < NP; ++u) {
      xr[0][u] = xr[1][u];
      xr[1][u] = xn[u];
      if constexpr (VEC && CONS) {
        ur[0][u] = ur[1][u];
        ur[1][u] = un[u];
      }
    }
#pragma unroll
    for (int m = 0; m < 3; ++m) ca[m] = cn[m];
  }
}

// The instance (T, KIND, FORM, FULL), opted in to its dynamic shared
// memory once per device.
template <typename T, int KIND, int FORM, bool FULL>
cudaError_t av_prepare() {
  static unsigned done = 0;
  return opt_in_smem(advect_march_kernel<T, KIND, FORM, FULL>, av_smem_bytes<T, KIND, FORM>(),
                     done);
}

// Launch the instance of (KIND, FORM) on `grid`, or with `blocks` report
// its blocks per SM instead.
template <typename T, int KIND, int FORM, bool FULL>
cudaError_t av_run(dim3 grid, cudaStream_t s, T* out, const AdvMarchParams<T>& q, int ci, int cw,
                   int* blocks) {
  const cudaError_t e = av_prepare<T, KIND, FORM, FULL>();
  if (e != cudaSuccess) return e;
  constexpr size_t smem = av_smem_bytes<T, KIND, FORM>();
  if (blocks) {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, advect_march_kernel<T, KIND, FORM, FULL>, AV_THREADS, smem);
  }
  advect_march_kernel<T, KIND, FORM, FULL><<<grid, AV_THREADS, smem, s>>>(out, q, ci, cw);
  return cudaGetLastError();
}

template <typename T, int KIND, int FORM>
cudaError_t av_full(bool full, dim3 grid, cudaStream_t s, T* out, const AdvMarchParams<T>& q,
                    int ci, int cw, int* blocks) {
  return full ? av_run<T, KIND, FORM, true>(grid, s, out, q, ci, cw, blocks)
              : av_run<T, KIND, FORM, false>(grid, s, out, q, ci, cw, blocks);
}

template <typename T>
cudaError_t av_dispatch(int kind, int form, bool full, dim3 grid, cudaStream_t s, T* out,
                        const AdvMarchParams<T>& q, int ci, int cw, int* blocks) {
  switch (kind * 3 + form) {
    case AV_CONV * 3 + AV_CENTRAL:
      return av_full<T, AV_CONV, AV_CENTRAL>(full, grid, s, out, q, ci, cw, blocks);
    case AV_CONV * 3 + AV_UPWIND:
      return av_full<T, AV_CONV, AV_UPWIND>(full, grid, s, out, q, ci, cw, blocks);
    case AV_DIV_S * 3 + AV_CENTRAL:
      return av_full<T, AV_DIV_S, AV_CENTRAL>(full, grid, s, out, q, ci, cw, blocks);
    case AV_DIV_S * 3 + AV_UPWIND:
      return av_full<T, AV_DIV_S, AV_UPWIND>(full, grid, s, out, q, ci, cw, blocks);
    case AV_DIV_S * 3 + AV_CONSERVATIVE:
      return av_full<T, AV_DIV_S, AV_CONSERVATIVE>(full, grid, s, out, q, ci, cw, blocks);
    case AV_DIV_V * 3 + AV_CENTRAL:
      return av_full<T, AV_DIV_V, AV_CENTRAL>(full, grid, s, out, q, ci, cw, blocks);
    case AV_DIV_V * 3 + AV_UPWIND:
      return av_full<T, AV_DIV_V, AV_UPWIND>(full, grid, s, out, q, ci, cw, blocks);
    case AV_DIV_V * 3 + AV_CONSERVATIVE:
      return av_full<T, AV_DIV_V, AV_CONSERVATIVE>(full, grid, s, out, q, ci, cw, blocks);
    default:
      return cudaErrorInvalidValue;  // the Conv has no conservative form
  }
}

}  // namespace

template <typename T>
cudaError_t advect_march_launch(int kind, int form, int ncomp, const AdvMarchParams<T>& q,
                                void* out, int ci, int cw, cudaStream_t s) {
  if (!march_args_ok<T>(q.n, ci, cw) || ncomp < 1 || (kind != AV_CONV && ncomp != 1))
    return cudaErrorInvalidValue;
  const dim3 grid((q.n[2] + AV_TK - 1) / AV_TK, (q.n[1] + av_tj<T>() - 1) / av_tj<T>(),
                  ncomp * ((q.n[0] + ci - 1) / ci));
  const bool full = q.n[1] % av_tj<T>() == 0 && q.n[2] % AV_TK == 0;
  return av_dispatch<T>(kind, form, full, grid, s, static_cast<T*>(out), q, ci, cw, nullptr);
}

template <typename T>
cudaError_t advect_march_occupancy(int kind, int form, bool full, int* blocks) {
  return av_dispatch<T>(kind, form, full, dim3(1, 1, 1), nullptr, nullptr, AdvMarchParams<T>{},
                        1, 0, blocks);
}

#if AV_DTYPE == 0
using AvStorage = float;
#elif AV_DTYPE == 1
using AvStorage = double;
#else
using AvStorage = __nv_bfloat16;
#endif
template cudaError_t advect_march_launch<AvStorage>(int, int, int,
                                                    const AdvMarchParams<AvStorage>&, void*,
                                                    int, int, cudaStream_t);
template cudaError_t advect_march_occupancy<AvStorage>(int, int, bool, int*);

}  // namespace pyapes
