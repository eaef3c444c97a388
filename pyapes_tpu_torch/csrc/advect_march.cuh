// What csrc/advect.cu (the per-point kernel and the C entries) and
// csrc/advect_march.cu (the plane march, built once per storage dtype)
// share: the parameters of a march launch and its launch functions,
// instantiated in advect_march.cu.
#pragma once

#include "common.cuh"

namespace pyapes {

// What a march reads. AV_CONV: the convection, one output per target
// component, each read along every axis, axis a advected by adv[a].
// AV_DIV_S: the Div of a scalar target, read along every axis with one
// advector. AV_DIV_V: the Div of a vector target, x[a] read along axis a
// only, advected by adv[a] (or adv[0] where adv has one component).
enum AdvMarchKind { AV_CONV = 0, AV_DIV_S = 1, AV_DIV_V = 2 };
// The coefficients of an axis: central in the advective form (the
// advector at the point), upwind, central in the conservative form (the
// advector at the neighbours).
enum AdvMarchForm { AV_CENTRAL = 0, AV_UPWIND = 1, AV_CONSERVATIVE = 2 };

template <typename T>
struct AdvMarchParams {
  const T* x[3];     // target read along axis a (Conv: component 0; output d reads + d vol)
  const T* u[3];     // advecting component of axis a
  const T* b[3][3];  // per axis a the geometry-only base vectors (bp, bc, bm), length n[a]
  int n[3];          // (n0, n1, n2)
  int lo[3], up[3];  // surgery of the lower / upper face of axis a: 0 none, 1 neumann, 2 periodic
  int pairs;         // 1: the operands read at the points are aligned to pairs (n2 even)
};

// The plane march of (kind, form) on storage dtype T, ncomp output
// components (Conv: the target's; Div: 1): ci planes per block, cw bytes
// per staging copy (16, 8, 4; 0: element loads).
template <typename T>
cudaError_t advect_march_launch(int kind, int form, int ncomp, const AdvMarchParams<T>& q,
                                void* out, int ci, int cw, cudaStream_t s);

// Blocks of that march (full: the instance of grids whose every tile lies
// inside) that one SM of the current device holds at once.
template <typename T>
cudaError_t advect_march_occupancy(int kind, int form, bool full, int* blocks);

}  // namespace pyapes
