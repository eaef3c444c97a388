// A loop whose exit the device decides, inside a captured CUDA graph: a
// conditional WHILE node (CUDA 12.3+) added to the graph a stream is
// capturing, its body captured from a second stream into the node's body
// graph. The condition is a 0-d bool on the device; a one-thread kernel
// copies it into the node's handle, once before the node (so a loop whose
// condition is already false runs zero times, as lax.while_loop does) and
// once at the end of every pass of the body.
//
// A solver loop's scalar bookkeeping at the end of a pass is one more
// one-thread kernel (loop_record_kernel): the pass's tolerance t becomes the
// loop's tolerance, enters the history, the count advances and the loop's
// condition is set, in one launch where torch takes a dozen (eager or as
// graph nodes).
//
// C interface (ctypes, ops/graph_loop.py):
//   pyapes_while_begin(stream, flag, &handle, &body)  on the capturing stream
//   pyapes_capture_to_graph(body_stream, body)        starts the body capture
//   pyapes_while_end(body_stream, handle, flag)       ends it
//   pyapes_loop_record(stream, dtype, t, tol, itr, hist, go, stop, max_it,
//                      tolerance, stall_ratio, flags)  one pass's bookkeeping
//   pyapes_graph_node_types(graph, counts[16])         its nodes by type
// Every entry returns a cudaError_t code (0: success).

#include "common.cuh"

namespace {

__global__ void set_conditional_kernel(cudaGraphConditionalHandle handle, const unsigned char* flag) {
  cudaGraphSetConditional(handle, *flag ? 1u : 0u);
}

int set_conditional(void* stream, unsigned long long handle, const void* flag) {
  set_conditional_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<cudaGraphConditionalHandle>(handle), static_cast<const unsigned char*>(flag));
  return static_cast<int>(cudaGetLastError());
}

// flags: 1 the tolerance test (t > tolerance), 2 the stall test (t >
// stall_ratio * the previous tolerance ends the loop), 4 the stop flag
// (*stop ends the loop). The double comparisons are the host's of a loop
// that reads t back; the history keeps t rounded to float.
constexpr int kCheckTol = 1, kCheckStall = 2, kCheckStop = 4;

template <typename T>
__global__ void loop_record_kernel(const T* t, double* tol, long long* itr, float* hist,
                                   unsigned char* go, const unsigned char* stop,
                                   long long max_it, double tolerance, double stall_ratio,
                                   int flags) {
  const double tn = static_cast<double>(*t);
  const double told = *tol;
  const long long k = *itr;
  if (k >= 0 && k < max_it) hist[k] = static_cast<float>(tn);
  *tol = tn;
  *itr = k + 1;
  bool g = k + 1 < max_it;
  if (flags & kCheckTol) g = g && tn > tolerance;
  if (flags & kCheckStall) g = g && !(tn > stall_ratio * told);
  if (flags & kCheckStop) g = g && !*stop;
  *go = g ? 1 : 0;
}

}  // namespace

extern "C" int pyapes_loop_record(void* stream, int dtype, const void* t, void* tol, void* itr,
                                  void* hist, void* go, const void* stop, long long max_it,
                                  double tolerance, double stall_ratio, int flags) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* tol_ = static_cast<double*>(tol);
  auto* itr_ = static_cast<long long*>(itr);
  auto* hist_ = static_cast<float*>(hist);
  auto* go_ = static_cast<unsigned char*>(go);
  const auto* stop_ = static_cast<const unsigned char*>(stop);
  if (dtype == 0) {
    loop_record_kernel<float><<<1, 1, 0, s>>>(static_cast<const float*>(t), tol_, itr_, hist_, go_,
                                              stop_, max_it, tolerance, stall_ratio, flags);
  } else if (dtype == 1) {
    loop_record_kernel<double><<<1, 1, 0, s>>>(static_cast<const double*>(t), tol_, itr_, hist_,
                                               go_, stop_, max_it, tolerance, stall_ratio, flags);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pyapes_while_begin(void* stream, const void* flag, unsigned long long* handle_out,
                                  void** body_out) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaError_t e = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &n_deps);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (status != cudaStreamCaptureStatusActive) return static_cast<int>(cudaErrorStreamCaptureImplicit);
  cudaGraphConditionalHandle handle;
  // flags 0: the value is not reset at launch; the kernel below sets it
  e = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  int err = set_conditional(stream, handle, flag);
  if (err != 0) return err;
  // the dependencies now end at the condition kernel
  e = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &n_deps);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeWhile;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  e = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaStreamUpdateCaptureDependencies(s, &node, 1, cudaStreamSetCaptureDependencies);
  if (e != cudaSuccess) return static_cast<int>(e);
  *handle_out = static_cast<unsigned long long>(handle);
  *body_out = static_cast<void*>(params.conditional.phGraph_out[0]);
  return 0;
}

extern "C" int pyapes_capture_to_graph(void* body_stream, void* body) {
  return static_cast<int>(cudaStreamBeginCaptureToGraph(
      static_cast<cudaStream_t>(body_stream), static_cast<cudaGraph_t>(body), nullptr, nullptr, 0,
      cudaStreamCaptureModeThreadLocal));
}

extern "C" int pyapes_while_end(void* body_stream, unsigned long long handle, const void* flag) {
  int err = set_conditional(body_stream, handle, flag);
  cudaGraph_t graph;
  cudaError_t e = cudaStreamEndCapture(static_cast<cudaStream_t>(body_stream), &graph);
  if (err != 0) return err;
  return static_cast<int>(e);
}

// Node counts by cudaGraphNodeType (out[0..13]; out[14] any other type) of
// a graph (what a loop's body holds), and in out[15] the memcpy nodes whose
// source and destination lie on two devices.
extern "C" int pyapes_graph_node_types(void* graph, unsigned long long* out) {
  size_t n = 0;
  cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  cudaError_t e = cudaGraphGetNodes(g, nullptr, &n);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaGraphNode_t* nodes = new cudaGraphNode_t[n > 0 ? n : 1];
  e = cudaGraphGetNodes(g, nodes, &n);
  for (size_t i = 0; e == cudaSuccess && i < n; ++i) {
    cudaGraphNodeType t;
    e = cudaGraphNodeGetType(nodes[i], &t);
    if (e != cudaSuccess) break;
    const int k = static_cast<int>(t);
    out[k >= 0 && k < 14 ? k : 14] += 1;
    if (t == cudaGraphNodeTypeMemcpy) {
      cudaMemcpy3DParms p = {};
      e = cudaGraphMemcpyNodeGetParams(nodes[i], &p);
      if (e != cudaSuccess) break;
      cudaPointerAttributes a = {}, b = {};
      if (p.srcPtr.ptr && p.dstPtr.ptr &&
          cudaPointerGetAttributes(&a, p.srcPtr.ptr) == cudaSuccess &&
          cudaPointerGetAttributes(&b, p.dstPtr.ptr) == cudaSuccess && a.device != b.device) {
        out[15] += 1;
      }
      (void)cudaGetLastError();
    }
  }
  delete[] nodes;
  return static_cast<int>(e);
}
