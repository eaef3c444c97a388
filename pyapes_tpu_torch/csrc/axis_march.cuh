// What csrc/axis_stencil.cu (the per-point kernels and the C entries) and
// csrc/axis_march.cu (the plane march, built once per storage dtype and
// radius) share: the parameters of a march launch and its launch
// functions, instantiated in axis_march.cu.
#pragma once

#include "common.cuh"

namespace pyapes {

template <typename T>
struct AxisMarchParams {
  // per mesh axis the coefficient vectors of the offsets +2, +1, 0, -1, -2
  // (app, ap, ac, am, amm); app = amm = null on a 3-point axis
  const T* c[3][5];
  int n[3];  // (n0, n1, n2)
  int five;  // bit a: axis a is 5-point (radius 2 only)
};

// The plane march of radius R (1: 3-point axes; 2: 5-point axes mixed with
// 3-point ones) and storage dtype T: ci planes per block, cw bytes per
// staging copy (16, 8, 4; 0: element loads).
template <typename T, int R>
cudaError_t axis_march_launch(int vdim, const AxisMarchParams<T>& q, const void* x, void* out,
                              int ci, int cw, cudaStream_t s);

// Blocks of that march (full: the instance of grids whose every tile lies
// inside) that one SM of the current device holds at once.
template <typename T, int R>
cudaError_t axis_march_occupancy(bool full, int* blocks);

}  // namespace pyapes
