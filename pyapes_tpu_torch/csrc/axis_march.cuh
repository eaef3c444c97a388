// What csrc/axis_stencil.cu (the per-point kernels and the C entries),
// csrc/axis_march.cu (the plane march, built once per storage dtype and
// radius, and once per storage dtype for its alpha-dot and its
// halo-extended instances) and csrc/axis_march2d.cu (the row march of 2-D
// grids) share: the parameters of a march launch and its launch functions,
// instantiated in axis_march.cu and axis_march2d.cu.
#pragma once

#include "common.cuh"

namespace pyapes {

template <typename T>
struct AxisMarchParams {
  // per mesh axis the coefficient vectors of the offsets +2, +1, 0, -1, -2
  // (app, ap, ac, am, amm); app = amm = null on a 3-point axis
  const T* c[3][5];
  int n[3];  // (n0, n1, n2): the output's extents
  int five;  // bit a: axis a is 5-point (radius 2 only)
};

// The halo-extended instance's input and output layout: x is (vdim, n0 +
// 2 e0, n1 + 2 e1, n2), C-contiguous; the output element (d, i, j, k) sits
// at d * os_v + i * os0 + j * os1 + k.
struct AxisMarchExt {
  int e0, e1;                // ghost rows per side of axes 0 and 1 (0 or 1)
  int64_t os_v, os0, os1;    // the output's element strides
  int pair;                  // the output takes pair stores (base and strides even)
};

// The plane march of radius R (1: 3-point axes; 2: 5-point axes mixed with
// 3-point ones) and storage dtype T: ci planes per block, cw bytes per
// staging copy (16, 8, 4; 0: element loads).
template <typename T, int R>
cudaError_t axis_march_launch(int vdim, const AxisMarchParams<T>& q, const void* x, void* out,
                              int ci, int cw, cudaStream_t s);

// The radius-1 march fused with the CG alpha-dot: also one partial
// sum(x * A x) per block (component-major, in block order) into partial.
template <typename T>
cudaError_t axis_march_dot_launch(int vdim, const AxisMarchParams<T>& q, const void* x,
                                  void* out, void* partial, int ci, int cw, cudaStream_t s);

// The radius-1 march on a halo-extended block (AxisMarchExt).
template <typename T>
cudaError_t axis_march_ext_launch(int vdim, const AxisMarchParams<T>& q, const AxisMarchExt& e,
                                  const void* x, void* out, int ci, int cw, cudaStream_t s);

// Blocks of that march (full: the instance of grids whose every tile lies
// inside) that one SM of the current device holds at once; the dot and
// halo-extended instances likewise.
template <typename T, int R>
cudaError_t axis_march_occupancy(bool full, int* blocks);
template <typename T>
cudaError_t axis_march_dot_occupancy(bool full, int* blocks);
template <typename T>
cudaError_t axis_march_ext_occupancy(bool full, int* blocks);

template <typename T>
struct RowMarchParams {
  const T* c[2][3];  // per mesh axis (ap, ac, am)
  int vdim, n0, n1;  // x and out are (vdim, n0, n1)
  int ci;            // rows per thread: 1, 2, 4 or 8
  int v16;           // x and out take 16-byte loads and stores (rows and bases aligned)
  int vc;            // so do the axis-1 coefficient vectors (their bases aligned)
};

// The row march of a 2-D grid (csrc/axis_march2d.cu).
template <typename T>
cudaError_t axis_row_march_launch(const RowMarchParams<T>& q, const void* x, void* out,
                                  cudaStream_t s);

}  // namespace pyapes
