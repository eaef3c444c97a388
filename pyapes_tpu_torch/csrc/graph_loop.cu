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
//   pyapes_capture_graph(stream, &graph)              the graph a stream captures
//   pyapes_graph_census_init()                        looks up what the census reads
//   pyapes_graph_census(graph, out[26], names, len)   what a graph holds (below)
// Every entry returns a cudaError_t code (0: success).

#include <cuda.h>

#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

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

extern "C" int pyapes_capture_graph(void* stream, void** graph_out) {
  cudaStreamCaptureStatus status;
  cudaGraph_t graph = nullptr;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaError_t e = cudaStreamGetCaptureInfo(static_cast<cudaStream_t>(stream), &status, nullptr,
                                           &graph, &deps, &n_deps);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (status != cudaStreamCaptureStatusActive) return static_cast<int>(cudaErrorStreamCaptureImplicit);
  *graph_out = static_cast<void*>(graph);
  return 0;
}

namespace {

// driver entry points the runtime does not wrap: a kernel node's context
// and function, and a function's name
using KernelParamsFn = CUresult (*)(CUgraphNode, CUDA_KERNEL_NODE_PARAMS_v2*);
using CtxCurrentFn = CUresult (*)(CUcontext*);
using FuncNameFn = CUresult (*)(const char**, CUfunction);
using KernelNameFn = CUresult (*)(const char**, CUkernel);
using NodeTypeFn = CUresult (*)(CUgraphNode, CUgraphNodeType*);

template <typename F>
F entry(const char* name) {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult q;
  // the versions of CUDA 12.8 (the names need 12.3, a node's context 12.0)
  if (cudaGetDriverEntryPointByVersion(name, &p, 12080, cudaEnableDefault, &q) != cudaSuccess ||
      q != cudaDriverEntryPointSuccess) {
    (void)cudaGetLastError();
    return nullptr;
  }
  return reinterpret_cast<F>(p);
}

struct Entries {
  KernelParamsFn kernel_params = entry<KernelParamsFn>("cuGraphKernelNodeGetParams");
  CtxCurrentFn ctx_current = entry<CtxCurrentFn>("cuCtxGetCurrent");
  FuncNameFn func_name = entry<FuncNameFn>("cuFuncGetName");
  KernelNameFn kernel_name = entry<KernelNameFn>("cuKernelGetName");
  NodeTypeFn node_type = entry<NodeTypeFn>("cuGraphNodeGetType");
};

// looked up once, at the first call (census_init, before any capture)
const Entries& entries() {
  static const Entries e;
  return e;
}

int device_of(const void* p) {
  cudaPointerAttributes a = {};
  if (p == nullptr || cudaPointerGetAttributes(&a, p) != cudaSuccess) {
    (void)cudaGetLastError();
    return -2;
  }
  return a.type == cudaMemoryTypeDevice || a.type == cudaMemoryTypeManaged ? a.device : -1;
}

}  // namespace

// Looks up the census' driver entry points; returns 1 where a kernel
// node's context can be read, else 0.
extern "C" int pyapes_graph_census_init() { return entries().kernel_params != nullptr; }

// What a graph holds, for the census of a lane's top-level graph (taken
// from the graph its stream captures, before the capture ends) and of
// each loop body. out[0..13]: nodes by cudaGraphNodeType; out[14]: any
// other type; out[15]: memcpy nodes between two devices; out[16]: edges;
// out[17]: the longest dependency chain (nodes); out[18]: kernel nodes of
// another context than the current one (the lane's card's); out[19]:
// kernel nodes whose context could not be read; out[20]: memcpy nodes
// with an end on another device than the current one; out[21]: memset
// nodes into another device; out[22]: distinct kernel functions; out[23]:
// the most blocks of one kernel node; out[24]: root nodes; out[25]:
// queries that failed. `names` gets "count name" lines, one per kernel
// function (cut at names_len). Errors of the queries are cleared: a census
// leaves no error behind for the next launch check to find.
extern "C" int pyapes_graph_census(void* graph, unsigned long long* out, char* names,
                                   unsigned long long names_len) {
  const Entries& en = entries();
  cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  size_t n = 0;
  cudaError_t e = cudaGraphGetNodes(g, nullptr, &n);
  if (e != cudaSuccess) return static_cast<int>(e);
  std::vector<cudaGraphNode_t> nodes(n > 0 ? n : 1);
  e = cudaGraphGetNodes(g, nodes.data(), &n);
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0;
  cudaGetDevice(&dev);
  CUcontext here = nullptr;
  if (en.ctx_current) en.ctx_current(&here);
  std::unordered_map<cudaGraphNode_t, size_t> index;
  std::unordered_map<std::string, unsigned long long> by_name;
  std::unordered_set<const void*> funcs;
  for (size_t i = 0; i < n; ++i) {
    index[nodes[i]] = i;
    // the driver's type: the runtime's call refused a conditional node
    CUgraphNodeType ct;
    if (en.node_type == nullptr ||
        en.node_type(reinterpret_cast<CUgraphNode>(nodes[i]), &ct) != CUDA_SUCCESS) {
      out[25] += 1;
      continue;
    }
    const auto t = static_cast<cudaGraphNodeType>(ct);
    const int k = static_cast<int>(t);
    out[k >= 0 && k < 14 ? k : 14] += 1;
    if (t == cudaGraphNodeTypeKernel) {
      CUDA_KERNEL_NODE_PARAMS_v2 p = {};
      if (en.kernel_params == nullptr ||
          en.kernel_params(reinterpret_cast<CUgraphNode>(nodes[i]), &p) != CUDA_SUCCESS) {
        out[25] += 1;
        continue;
      }
      if (p.ctx == nullptr) {
        out[19] += 1;
      } else if (p.ctx != here) {
        out[18] += 1;
      }
      const unsigned long long grid = 1ull * p.gridDimX * p.gridDimY * p.gridDimZ;
      if (grid > out[23]) out[23] = grid;
      const void* f = p.func ? static_cast<const void*>(p.func) : static_cast<const void*>(p.kern);
      funcs.insert(f);
      const char* nm = nullptr;
      if (p.func && en.func_name) en.func_name(&nm, p.func);
      if (nm == nullptr && p.kern && en.kernel_name) en.kernel_name(&nm, p.kern);
      by_name[nm ? nm : "?"] += 1;
    } else if (t == cudaGraphNodeTypeMemcpy) {
      cudaMemcpy3DParms p = {};
      if (cudaGraphMemcpyNodeGetParams(nodes[i], &p) != cudaSuccess) {
        out[25] += 1;
        continue;
      }
      const int a = device_of(p.srcPtr.ptr), b = device_of(p.dstPtr.ptr);
      if (a >= 0 && b >= 0 && a != b) out[15] += 1;
      if ((a >= 0 && a != dev) || (b >= 0 && b != dev)) out[20] += 1;
    } else if (t == cudaGraphNodeTypeMemset) {
      cudaMemsetParams p = {};
      if (cudaGraphMemsetNodeGetParams(nodes[i], &p) != cudaSuccess) {
        out[25] += 1;
        continue;
      }
      const int b = device_of(p.dst);
      if (b >= 0 && b != dev) out[21] += 1;
    }
  }
  out[22] = funcs.size();
  // the longest chain: nodes in topological order (Kahn), depth by edges
  size_t n_edges = 0;
  if (cudaGraphGetEdges(g, nullptr, nullptr, &n_edges) == cudaSuccess) {
    std::vector<cudaGraphNode_t> from(n_edges > 0 ? n_edges : 1), to(n_edges > 0 ? n_edges : 1);
    if (cudaGraphGetEdges(g, from.data(), to.data(), &n_edges) == cudaSuccess) {
      out[16] = n_edges;
      std::vector<std::vector<size_t>> succ(n);
      std::vector<size_t> indeg(n, 0), depth(n, 1), ready;
      for (size_t j = 0; j < n_edges; ++j) {
        auto a = index.find(from[j]), b = index.find(to[j]);
        if (a == index.end() || b == index.end()) continue;
        succ[a->second].push_back(b->second);
        indeg[b->second] += 1;
      }
      for (size_t i = 0; i < n; ++i) {
        if (indeg[i] == 0) ready.push_back(i);
      }
      out[24] = ready.size();
      unsigned long long longest = n > 0 ? 1 : 0;
      while (!ready.empty()) {
        const size_t i = ready.back();
        ready.pop_back();
        if (depth[i] > longest) longest = depth[i];
        for (size_t j : succ[i]) {
          if (depth[i] + 1 > depth[j]) depth[j] = depth[i] + 1;
          if (--indeg[j] == 0) ready.push_back(j);
        }
      }
      out[17] = longest;
    } else {
      out[25] += 1;
    }
  } else {
    out[25] += 1;
  }
  std::string lines;
  for (const auto& kv : by_name) lines += std::to_string(kv.second) + " " + kv.first + "\n";
  if (names != nullptr && names_len > 0) {
    const size_t m = lines.size() < names_len - 1 ? lines.size() : names_len - 1;
    lines.copy(names, m);
    names[m] = '\0';
  }
  (void)cudaGetLastError();  // the queries' errors, if any, are counted in out[25]
  return 0;
}
