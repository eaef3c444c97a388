// The variable-Γ plane march on Hopper (sm_90a): diff_jacobi's three modes
// and diff_field (APPLY) for 3-D grids from the wrapper's threshold up
// (ops/diff_field.py chooses by shape; the operator, the modes and the
// per-point kernel of small and 2-D grids are in csrc/diff_field.cu). This
// file is built once per storage dtype and Γ layout (-DVG_DTYPE=0 f32, 1
// f64, 2 bf16; -DVG_ISO=1 isotropic, 0 stacked), the builds started
// together, and linked with diff_field.cu into one library.
//
// The design is jacobi3d.cu's single sweep with Γ beside x: a 2.5-D plane
// march along axis 0 (the outermost, stride n1 n2; k is contiguous). Each
// block owns a TJ x 128 column tile of outputs in (j, k) (TJ = 16; 8 in
// f64, whose windows would not fit the shared memory) and a chunk of `ci`
// consecutive planes i0 .. i1-1 along i. Per plane p it stages, into
// 4-slot shared-memory rings (slot = plane & 3) with 16-byte cp.async
// copies (8 or 4 where the rows allow no 16, element loads for bf16 rows
// of odd length) issued up to three planes ahead of use:
//
//   x   on the window of rows j0-1 .. j0+TJ, columns k0-HK .. k0+128+HK-1
//       (HK = 16 bytes of elements; not in SMOOTH0, which reads no x);
//   G   isotropic (ISO): on the same window, one field for all axes;
//       stacked: G_1 and G_2 on the window, G_0 on the tile alone (its
//       axis-0 neighbours come from registers);
//   b   on the tile alone (not in APPLY).
//
// Where the grid ends inside the tile only its rows and columns (+-1) are
// staged. A thread owns two adjacent columns in R = TJ / 4 consecutive
// rows (2 warps side by side along k, 4 along j), reads x, G and b and
// writes out as pairs, and carries along the march, per point, x(p),
// x(p) - x(p-1), G_0(p) and the axis-0 face face(G_0(p-1), G_0(p)): each
// axis-0 face and flux is computed once (in harmonic mode a third of the
// divisions), as is each face and flux between two of its rows (carried
// down the rows) or its two columns; the rest come from the window (a
// pair above, a pair below, one value each side of every row pair). The
// window's wrapped row offsets and columns are one table per block; the
// axis-0 mask and surgery are uniform scalars per plane; the j/k mask and
// surgery bits and the bounds are registers per thread: no % and no
// 64-bit index product in the per-point loop. A grid whose every tile lies
// inside it (n1 % TJ == 0, n2 % 128 == 0) takes the FULL instance, whose
// window bounds are compile-time constants (as jacobi3d.cu records,
// runtime bounds slow the large march); isotropic Γ only, the Darcy
// cycle's layout.
//
// A point is computed by one expression (explicit fma, a fixed order),
// whatever the chunk and whichever thread computes a face it shares: the
// same bits at every chunk and on every call. f32 and bf16 divide with the
// fast reciprocal (__fdividef, 2 ulp), f64 exactly.

#include <type_traits>

#include "diff_field.cuh"
#include "march.cuh"

namespace pyapes {
namespace {

constexpr int VG_WK = 2, VG_WJ = 4;             // warps along k, along j
constexpr int VG_THREADS = 32 * VG_WK * VG_WJ;  // 256
constexpr int VG_TK = 64 * VG_WK;               // tile columns (128)
constexpr int VG_SLOTS = 4;

template <typename T>
__host__ __device__ constexpr int vg_rows() {  // rows per thread
  return sizeof(T) == 8 ? 2 : 4;
}
template <typename T>
__host__ __device__ constexpr int vg_min_blocks() {  // per SM: <= 128 registers, f64 unbounded
  return sizeof(T) == 8 ? 1 : 2;
}
template <typename T>
__host__ __device__ constexpr int vg_tj() {  // tile rows
  return VG_WJ * vg_rows<T>();
}
template <typename T>
__host__ __device__ constexpr int vg_hk() {  // k halo of the window: 16 bytes
  return 16 / int(sizeof(T));
}
template <typename T>
__host__ __device__ constexpr int vg_w() {  // window row
  return VG_TK + 2 * vg_hk<T>();
}
template <typename T, int MODE, bool ISO>
constexpr size_t vg_smem_bytes() {
  constexpr int XPL = (vg_tj<T>() + 2) * vg_w<T>(), BPL = vg_tj<T>() * VG_TK;
  constexpr int nx = MODE == SMOOTH0 ? 0 : XPL, nb = MODE == APPLY ? 0 : BPL;
  constexpr int ng = ISO ? XPL : 2 * XPL + BPL;
  return VG_SLOTS * size_t(nx + ng + nb) * sizeof(T) +
         (vg_tj<T>() + 2 + vg_w<T>()) * sizeof(int);
}

__device__ __forceinline__ float vg_div(float a, float b) { return __fdividef(a, b); }
__device__ __forceinline__ double vg_div(double a, double b) { return a / b; }

// The face value of G between two nodes, a at the lower index, scaled by
// its axis's 1 / dx^2 (h: inv_dx2 / 2 arithmetic, 2 inv_dx2 harmonic):
// h (a + b), or h a b / (a + b). Every thread that computes a face takes
// its nodes in this order, so a face it shares has the same bits.
template <bool HARM, typename C>
__device__ __forceinline__ C vg_face(C h, C a, C b) {
  if constexpr (HARM) {
    return vg_div((h * a) * b, a + b);
  } else {
    return h * (a + b);
  }
}

// The Neumann eliminations of `bits` (bit 0 lower, bit 1 upper face) on
// one axis of a point: the plain version's additive edits c0 (4/3 x - 1/3
// x(far) - x(boundary)) to t = F(+1/2) - F(-1/2) and 4/3 c0 to the
// diagonal (s = -diag), written with the scaled faces cm, cp, the
// differences dm = x - x(-1), dp = x(+1) - x and the fluxes Fm = cm dm,
// Fp = cp dp.
template <typename C>
__device__ __forceinline__ void vg_surgery(unsigned bits, C cm, C cp, C dm, C dp, C Fm, C Fp,
                                           C& t, C& s) {
  if (bits & 1u) {  // lower face: c0 = cm, far x(+1)
    t = fma(C(-1.0 / 3.0) * cm, dp, t + Fm);
    s = fma(C(-4.0 / 3.0), cm, s);
  }
  if (bits & 2u) {  // upper face: c0 = cp, far x(-1)
    t = fma(C(1.0 / 3.0) * cp, dm, t - Fp);
    s = fma(C(-4.0 / 3.0), cp, s);
  }
}

// The value of a point from its centre x and b, A x (ax) and the negated
// diagonal (s), and its mask.
template <int MODE, typename C>
__device__ __forceinline__ C vg_out(C omega, C xc, C bv, C ax, C s, bool masked) {
  if constexpr (MODE == APPLY) {
    return ax;
  } else if constexpr (MODE == RESID) {
    return masked ? C(0) : bv - ax;
  } else if constexpr (MODE == SMOOTH) {
    const C r = masked ? C(0) : bv - ax;
    return xc + vg_div(omega * r, -s);
  } else {
    const C r = masked ? C(0) : bv;
    return vg_div(omega * r, -s);
  }
}

template <typename T, int MODE, bool ISO, bool FULL, bool HARM>
__device__ __forceinline__ void vg_march(unsigned char* smem, const T* __restrict__ x,
                                         const T* __restrict__ b, T* __restrict__ out,
                                         const DiffParams<T>& q, int ci, int cw) {
  using C = typename Compute<T>::type;
  constexpr bool NEED_X = MODE != SMOOTH0, NEED_B = MODE != APPLY;
  constexpr int NT = VG_THREADS, R = vg_rows<T>(), TJ = vg_tj<T>(), TK = VG_TK;
  constexpr int HK = vg_hk<T>(), W = vg_w<T>(), XJ = TJ + 2;
  constexpr int XPL = XJ * W, BPL = TJ * TK;
  constexpr int R2 = 2 * R;  // a thread's points (pairs of R rows)
  // rings: [x][G window (ISO: G; stacked: G_1)][G_2][G_0 tile][b], then the tables
  T* xs = reinterpret_cast<T*>(smem);
  T* gws = xs + (NEED_X ? VG_SLOTS * XPL : 0);
  T* g2s = ISO ? gws : gws + VG_SLOTS * XPL;
  T* g0s = ISO ? gws : g2s + VG_SLOTS * XPL;
  T* bs = ISO ? gws + VG_SLOTS * XPL : g0s + VG_SLOTS * BPL;
  int* rowoff = reinterpret_cast<int*>(bs + (NEED_B ? VG_SLOTS * BPL : 0));  // row -> j * n2
  int* kcol = rowoff + XJ;                                                   // column -> k

  const int t = threadIdx.x;
  const int n0 = q.n[0], n1 = q.n[1], n2 = q.n[2];
  const int nch = (n0 + ci - 1) / ci;
  const int d = blockIdx.z / nch;
  const int i0 = (blockIdx.z - d * nch) * ci, i1 = min(i0 + ci, n0);
  const int j0 = blockIdx.y * TJ, k0 = blockIdx.x * TK;
  const int64_t plane = (int64_t)n1 * n2, vol = n0 * plane;
  const T* xd = NEED_X ? x + d * vol : nullptr;
  const T* bd = NEED_B ? b + d * vol : nullptr;
  T* od = out + d * vol;

  for (int e = t; e < XJ + W; e += NT) {
    if (e < XJ) rowoff[e] = wrap(j0 - 1 + e, n1) * n2;
    else kcol[e - XJ] = wrap(k0 - HK + e - XJ, n2);
  }
  __syncthreads();

  auto wrap_i = [&](int p) { return p < 0 ? p + n0 : (p >= n0 ? p - n0 : p); };
  // the window the block's points need (jacobi3d.cu): rows and columns
  // inside the grid (+-1); FULL: the whole window, bounds known to the
  // compiler
  const int tr = FULL ? TJ : min(TJ, n1 - j0);
  const int tc = FULL ? TK : min(TK, n2 - k0);
  auto chunks = [&](int v) { return (HK + tc + 1 + v - 1) / v; };  // window copies per row
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
      const int c = t + u * NT, r = c / (TK / V16), h = c - r * (TK / V16);
      gb16[u] = c < NBC ? rowoff[1 + r] + kcol[HK + h * V16] : 0;
      if (c < NBC && r < tr && h < cb) okb |= 1u << u;
    }
  }
  // stage plane p of `base` into `ring`: on the window / on the tile, cw
  // bytes per copy (16, 8, 4; 0: element loads)
  auto stage_win = [&](T* ring, const T* base, int p) {
    T* dst = ring + (p & 3) * XPL;
    const T* src = base + wrap_i(p) * plane;
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
  auto stage_tile = [&](T* ring, const T* base, int p) {
    T* dst = ring + (p & 3) * BPL;
    const T* src = base + wrap_i(p) * plane;
    if (cw == 16) {
#pragma unroll
      for (int u = 0; u < NB16; ++u) {
        if (okb >> u & 1u) cp_async<16>(dst + (t + u * NT) * V16, src + gb16[u]);
      }
    } else if (cw == 8) {
      constexpr int V = 8 / int(sizeof(T));
      stage_window<V, TK, NT>(dst, src, rowoff, kcol + HK, tr, (tc + V - 1) / V, 1, t);
    } else if (cw == 4) {
      if constexpr (sizeof(T) <= 4) {
        constexpr int V = 4 / int(sizeof(T));
        stage_window<V, TK, NT>(dst, src, rowoff, kcol + HK, tr, (tc + V - 1) / V, 1, t);
      }
    } else {
      stage_window<1, TK, NT>(dst, src, rowoff, kcol + HK, tr, tc, 1, t);
    }
  };
  // x and G of plane p (x(p+1) and G(p+1) are read at step p)
  auto stage_xg = [&](int p) {
    if constexpr (NEED_X) stage_win(xs, xd, p);
    if constexpr (ISO) {
      stage_win(gws, q.g[0], p);
    } else {
      stage_tile(g0s, q.g[0], p);
      stage_win(gws, q.g[1], p);
      stage_win(g2s, q.g[2], p);
    }
  };
  auto stage_b = [&](int p) {
    if constexpr (NEED_B) stage_tile(bs, bd, p);
  };

  // this thread's points: tile rows tj0 .. tj0+R-1, columns k0+kk, k0+kk+1;
  // point 2r+c is row r, column c
  const int w = t >> 5;
  const int kk = 64 * (w % VG_WK) + 2 * (t & 31), tj0 = (w / VG_WK) * R;
  const int xo = (tj0 + 1) * W + HK + kk;  // its first pair in a window slot
  const int bo = tj0 * TK + kk;            // ... in a tile slot
  constexpr int G0PL = ISO ? XPL : BPL, G0W = ISO ? W : TK;  // G_0 slot and row
  const int go = ISO ? xo : bo;
  // bit 2r+c: masked in (j, k); inside the grid. sjk: from bit 4u for
  // point u the lower / upper elimination on axis 1, then on axis 2
  unsigned mjk = 0, live = 0, sjk = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int gj = j0 + tj0 + r;
    const bool mj = (q.mask & 2) && (gj == 0 || gj == n1 - 1);
    const unsigned sj = ((q.lo & 2) && gj == 1 ? 1u : 0u) | ((q.up & 2) && gj == n1 - 2 ? 2u : 0u);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int u = 2 * r + c, gk = k0 + kk + c;
      if (mj || ((q.mask & 4) && (gk == 0 || gk == n2 - 1))) mjk |= 1u << u;
      if (gj < n1 && gk < n2) live |= 1u << u;
      const unsigned sk = ((q.lo & 4) && gk == 1 ? 4u : 0u) | ((q.up & 4) && gk == n2 - 2 ? 8u : 0u);
      sjk |= (sj | sk) << (4 * u);
    }
  }
  const bool pair_store = (n2 & 1) == 0;
  const int64_t orow = (int64_t)(j0 + tj0) * n2 + k0 + kk;  // its first point in a plane
  const C hf = HARM ? C(2) : C(0.5);
  const C h0 = hf * q.inv[0], h1 = hf * q.inv[1], h2 = hf * q.inv[2];  // vg_face's scales
  const C omega = q.omega;

  // prologue: x, G of planes i0-1, i0 now; then the groups
  // G(p) = {x(p+1), G(p+1), b(p)} for p = i0, i0+1, so that step p waits
  // only for G(p)
  stage_xg(i0 - 1);
  stage_xg(i0);
  cp_async_commit();
  stage_xg(i0 + 1);
  stage_b(i0);
  cp_async_commit();
  if (i0 + 2 <= i1) stage_xg(i0 + 2);
  if (i0 + 1 < i1) stage_b(i0 + 1);
  cp_async_commit();
  cp_async_wait<2>();
  __syncthreads();

  // along the march, per point: x(p), x(p) - x(p-1), G_0(p),
  // face(G_0(p-1), G_0(p))
  C xc[R2], dm[R2], gc[R2], f0m[R2];
  {
    const T* s0 = g0s + ((i0 - 1) & 3) * G0PL;
    const T* s1 = g0s + (i0 & 3) * G0PL;
    const T* x0 = xs + ((i0 - 1) & 3) * XPL;
    const T* x1 = xs + (i0 & 3) * XPL;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      C ga[2], xa[2] = {C(0), C(0)};
      load2(s0 + go + r * G0W, ga[0], ga[1]);
      load2(s1 + go + r * G0W, gc[2 * r], gc[2 * r + 1]);
      xc[2 * r] = xc[2 * r + 1] = C(0);
      if constexpr (NEED_X) {
        load2(x0 + xo + r * W, xa[0], xa[1]);
        load2(x1 + xo + r * W, xc[2 * r], xc[2 * r + 1]);
      }
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        f0m[2 * r + c] = vg_face<HARM>(h0, ga[c], gc[2 * r + c]);
        dm[2 * r + c] = xc[2 * r + c] - xa[c];
      }
    }
  }

  for (int p = i0; p < i1; ++p) {
    cp_async_wait<1>();  // G(p): x(p+1), G(p+1), b(p)
    __syncthreads();     // ... from every thread; step p-1 done with the slots
                         // refilled below (one barrier a step)
    if (p + 3 <= i1) stage_xg(p + 3);
    if (p + 2 < i1) stage_b(p + 2);
    cp_async_commit();

    // bit u: point u masked; axis-0 surgery bits; any surgery at a point
    const unsigned mu = (q.mask & 1) && (p == 0 || p == n0 - 1) ? 0xffu : mjk;
    const unsigned si = ((q.lo & 1) && p == 1 ? 1u : 0u) | ((q.up & 1) && p == n0 - 2 ? 2u : 0u);
    const bool surg = (si | sjk) != 0;
    const T* xsc = xs + (p & 3) * XPL;          // x(p)
    const T* xsn = xs + ((p + 1) & 3) * XPL;    // x(p+1)
    const T* g1c = gws + (p & 3) * XPL;         // G_1(p) (ISO: G(p))
    const T* g2c = g2s + (p & 3) * XPL;         // G_2(p)
    const T* g0n = g0s + ((p + 1) & 3) * G0PL;  // G_0(p+1)
    const T* bsc = bs + (p & 3) * BPL;          // b(p)

    // axis 1, carried down the rows: G_1 and x of the row above, the face,
    // difference and flux between it and the current row
    C g1a[2], xa[2] = {C(0), C(0)};
    load2(g1c + xo - W, g1a[0], g1a[1]);
    if constexpr (NEED_X) load2(xsc + xo - W, xa[0], xa[1]);
    C g1r[2];  // G_1 of the current row
    if constexpr (ISO) {
      g1r[0] = gc[0];
      g1r[1] = gc[1];
    } else {
      load2(g1c + xo, g1r[0], g1r[1]);
    }
    C f1m[2], d1m[2], F1m[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      f1m[c] = vg_face<HARM>(h1, g1a[c], g1r[c]);
      d1m[c] = xc[c] - xa[c];
      F1m[c] = f1m[c] * d1m[c];
    }
    T* dst = od + p * plane + orow;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int o = xo + r * W;
      // the row below: G_1 and x
      C g1b[2], xb[2];
      if (r + 1 < R) {
        if constexpr (ISO) {
          g1b[0] = gc[2 * r + 2];
          g1b[1] = gc[2 * r + 3];
        } else {
          load2(g1c + o + W, g1b[0], g1b[1]);
        }
        xb[0] = xc[2 * r + 2];
        xb[1] = xc[2 * r + 3];
      } else {
        load2(g1c + o + W, g1b[0], g1b[1]);
        xb[0] = xb[1] = C(0);
        if constexpr (NEED_X) load2(xsc + o + W, xb[0], xb[1]);
      }
      // axis 2: G_2 and x at columns -1 .. 2 of the row; the faces,
      // differences and fluxes between them
      C g2[4], x2[4] = {C(0), xc[2 * r], xc[2 * r + 1], C(0)};
      if constexpr (ISO) {
        g2[1] = gc[2 * r];
        g2[2] = gc[2 * r + 1];
      } else {
        load2(g2c + o, g2[1], g2[2]);
      }
      g2[0] = to_c(g2c[o - 1]);
      g2[3] = to_c(g2c[o + 2]);
      if constexpr (NEED_X) {
        x2[0] = to_c(xsc[o - 1]);
        x2[3] = to_c(xsc[o + 2]);
      }
      C f2[3], d2[3], F2[3];
#pragma unroll
      for (int h = 0; h < 3; ++h) {
        f2[h] = vg_face<HARM>(h2, g2[h], g2[h + 1]);
        d2[h] = x2[h + 1] - x2[h];
        F2[h] = f2[h] * d2[h];
      }
      // axis 0: G_0 and x of plane p+1
      C gn[2], xp[2] = {C(0), C(0)}, bv[2] = {C(0), C(0)};
      load2(g0n + go + r * G0W, gn[0], gn[1]);
      if constexpr (NEED_X) load2(xsn + o, xp[0], xp[1]);
      if constexpr (NEED_B) load2(bsc + bo + r * TK, bv[0], bv[1]);
      C v[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int u = 2 * r + c;
        const C f1p = vg_face<HARM>(h1, g1r[c], g1b[c]);
        const C d1p = xb[c] - xc[u];
        const C F1p = f1p * d1p;
        const C f0p = vg_face<HARM>(h0, gc[u], gn[c]);
        const C d0p = xp[c] - xc[u];
        const C F0m = f0m[u] * dm[u], F0p = f0p * d0p;
        // per axis t = F(+1/2) - F(-1/2) and s = -diag, then their sums
        C t0 = F0p - F0m, t1 = F1p - F1m[c], t2 = F2[c + 1] - F2[c];
        C s0 = f0m[u] + f0p, s1 = f1m[c] + f1p, s2 = f2[c] + f2[c + 1];
        if (surg) {
          const unsigned sb = sjk >> (4 * u);
          vg_surgery(si, f0m[u], f0p, dm[u], d0p, F0m, F0p, t0, s0);
          vg_surgery(sb & 3u, f1m[c], f1p, d1m[c], d1p, F1m[c], F1p, t1, s1);
          vg_surgery(sb >> 2 & 3u, f2[c], f2[c + 1], d2[c], d2[c + 1], F2[c], F2[c + 1], t2, s2);
        }
        v[c] = vg_out<MODE>(omega, xc[u], bv[c], t0 + t1 + t2, s0 + s1 + s2, mu >> u & 1u);
        // carry: down the rows (axis 1), along the march (axis 0)
        f1m[c] = f1p;
        d1m[c] = d1p;
        F1m[c] = F1p;
        f0m[u] = f0p;
        dm[u] = d0p;
        xc[u] = xp[c];
        gc[u] = gn[c];
      }
      g1r[0] = g1b[0];
      g1r[1] = g1b[1];
      const unsigned lv = live >> (2 * r) & 3u;
      if (lv == 3u && pair_store) {
        store2(dst, v[0], v[1]);
      } else {
        if (lv & 1u) store(dst, v[0]);
        if (lv & 2u) store(dst + 1, v[1]);
      }
      dst += n2;
    }
  }
}

template <typename T, int MODE, bool ISO, bool FULL, bool HARM>
__global__ void __launch_bounds__(VG_THREADS, vg_min_blocks<T>())
diff_jacobi_march_kernel(const T* __restrict__ x, const T* __restrict__ b, T* __restrict__ out,
                         DiffParams<T> q, int ci, int cw) {
  extern __shared__ __align__(16) unsigned char smem[];
  vg_march<T, MODE, ISO, FULL, HARM>(smem, x, b, out, q, ci, cw);
}

template <typename T, bool ISO, bool FULL, bool HARM>
__global__ void __launch_bounds__(VG_THREADS, vg_min_blocks<T>())
diff_field_march_kernel(const T* __restrict__ x, T* __restrict__ out, DiffParams<T> q, int ci,
                        int cw) {
  extern __shared__ __align__(16) unsigned char smem[];
  vg_march<T, APPLY, ISO, FULL, HARM>(smem, x, nullptr, out, q, ci, cw);
}

// The instance (T, MODE, ISO, FULL, HARM): its kernel, opted in to its
// dynamic shared memory once per device.
template <typename T, int MODE, bool ISO, bool FULL, bool HARM>
struct Vg {
  static constexpr size_t smem = vg_smem_bytes<T, MODE, ISO>();
  static auto kernel() {
    if constexpr (MODE == APPLY) {
      return diff_field_march_kernel<T, ISO, FULL, HARM>;
    } else {
      return diff_jacobi_march_kernel<T, MODE, ISO, FULL, HARM>;
    }
  }
  static cudaError_t prepare() {
    static unsigned done = 0;
    return opt_in_smem(kernel(), smem, done);
  }
  static cudaError_t launch(dim3 grid, cudaStream_t s, const T* x, const T* b, T* out,
                            const DiffParams<T>& q, int ci, int cw) {
    const cudaError_t e = prepare();
    if (e != cudaSuccess) return e;
    const auto k = kernel();
    if constexpr (MODE == APPLY) {
      k<<<grid, VG_THREADS, smem, s>>>(x, out, q, ci, cw);
    } else {
      k<<<grid, VG_THREADS, smem, s>>>(x, b, out, q, ci, cw);
    }
    return cudaGetLastError();
  }
  static cudaError_t occupancy(int* blocks) {
    const cudaError_t e = prepare();
    if (e != cudaSuccess) return e;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel(), VG_THREADS, smem);
  }
};

// f(Vg<T, MODE, ISO, FULL, HARM>{}) for the runtime mode and flags; the
// FULL instance exists for isotropic Γ only.
template <typename T, bool ISO, typename F>
cudaError_t vg_select(int mode, bool full, bool harm, F&& f) {
  auto pick = [&](auto m) -> cudaError_t {
    constexpr int M = decltype(m)::value;
    if (ISO && full) return harm ? f(Vg<T, M, ISO, ISO, true>{}) : f(Vg<T, M, ISO, ISO, false>{});
    return harm ? f(Vg<T, M, ISO, false, true>{}) : f(Vg<T, M, ISO, false, false>{});
  };
  switch (mode) {
    case SMOOTH: return pick(std::integral_constant<int, SMOOTH>{});
    case SMOOTH0: return pick(std::integral_constant<int, SMOOTH0>{});
    case RESID: return pick(std::integral_constant<int, RESID>{});
    case APPLY: return pick(std::integral_constant<int, APPLY>{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

template <typename T, bool ISO>
cudaError_t march_launch(int mode, int vdim, const DiffParams<T>& q, const void* x,
                         const void* b, void* out, int ci, int cw, cudaStream_t s) {
  if (!march_args_ok<T>(q.n, ci, cw)) return cudaErrorInvalidValue;
  const bool full = q.n[1] % vg_tj<T>() == 0 && q.n[2] % VG_TK == 0;
  const dim3 grid((q.n[2] + VG_TK - 1) / VG_TK, (q.n[1] + vg_tj<T>() - 1) / vg_tj<T>(),
                  vdim * ((q.n[0] + ci - 1) / ci));
  const T* xp = static_cast<const T*>(x);
  const T* bp = static_cast<const T*>(b);
  T* op = static_cast<T*>(out);
  return vg_select<T, ISO>(mode, full, q.harmonic != 0, [&](auto k) {
    return decltype(k)::launch(grid, s, xp, bp, op, q, ci, cw);
  });
}

template <typename T, bool ISO>
cudaError_t march_occupancy(int mode, bool full, bool harmonic, int* blocks) {
  return vg_select<T, ISO>(mode, full, harmonic,
                           [&](auto k) { return decltype(k)::occupancy(blocks); });
}

#if VG_DTYPE == 0
using VgStorage = float;
#elif VG_DTYPE == 1
using VgStorage = double;
#else
using VgStorage = __nv_bfloat16;
#endif
template cudaError_t march_launch<VgStorage, VG_ISO != 0>(int, int, const DiffParams<VgStorage>&,
                                                          const void*, const void*, void*, int,
                                                          int, cudaStream_t);
template cudaError_t march_occupancy<VgStorage, VG_ISO != 0>(int, bool, bool, int*);

}  // namespace pyapes
