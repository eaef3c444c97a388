// What csrc/diff_field.cu (the per-point kernels and the C entries) and
// csrc/diff_march.cu (the plane march, built once per storage dtype and Γ
// layout) share: the parameters of a launch, the modes, and the march's
// launch functions, instantiated in diff_march.cu.
#pragma once

#include "common.cuh"

namespace pyapes {

enum DiffMode { SMOOTH = 0, SMOOTH0 = 1, RESID = 2, APPLY = 3 };

template <typename T>
struct DiffParams {
  using C = typename Compute<T>::type;
  const T* g[3];  // G of each axis
  C inv[3];       // 1 / dx^2 per axis (the march: 0 on the skipped axis 0 of a 2-D grid)
  C omega;
  int n[3];       // (n0, n1, n2)
  int first;      // first active axis: 0 (3-D) or 1 (2-D, n0 == 1)
  int lo, up;     // bit a: Neumann elimination at the lower / upper face of axis a
  int mask;       // bit a: zero the update on rows 0 and n-1 of axis a
  int harmonic;   // face rule: 0 arithmetic, 1 harmonic
};

// The plane march of one storage dtype T and Γ layout ISO (one G for all
// axes) in `mode` (SMOOTH, SMOOTH0, RESID; APPLY: diff_field): ci planes
// per block, cw bytes per staging copy (16, 8, 4; 0: element loads).
template <typename T, bool ISO>
cudaError_t march_launch(int mode, int vdim, const DiffParams<T>& q, const void* x,
                         const void* b, void* out, int ci, int cw, cudaStream_t s);

// Blocks of that march (full: the instance of grids whose every tile lies
// inside) that one SM of the current device holds at once.
template <typename T, bool ISO>
cudaError_t march_occupancy(int mode, bool full, bool harmonic, int* blocks);

}  // namespace pyapes
