// A minimal reproducer of the port's graphs per card, on the CUDA runtime
// alone (no torch, no port code): for each of `lanes` lanes (lane d on
// card d % devices, each on a stream of its own), one graph captured from
// one thread, every lane's capture begun before any work (relaxed mode, as
// ops/graph_loop.py's GraphedCall(lanes=...)):
//
//   top_nodes one-thread kernels, with `top_pairs` put/wait pairs spread
//   among them (lane d puts into lane d+1's memory and waits for lane
//   d-1's put, as ops/peer.py's kernels do), then a WHILE node (a
//   conditional handle set by a one-thread kernel before the node and at
//   the end of each pass, its body captured from a second stream into the
//   node's body graph, thread-local mode: csrc/graph_loop.cu's sequence)
//   whose body holds body_nodes kernels and body_pairs pairs, `passes`
//   passes, then the end of the capture, instantiation with torch's flag
//   (cudaGraphInstantiateFlagAutoFreeOnLaunch) and the capture graph
//   destroyed, as torch's CUDAGraph::capture_end does.
//
// Then every lane's graph is launched on its own stream, `replays` times,
// with a synchronisation after each round: from one thread, back to back
// (threads 0), or each lane's from a thread of its own (threads 1).
// `with_while` 0 leaves the WHILE node out (the body's work then follows
// the top-level work once, in the top-level graph). A wait traps after
// `wait_s` seconds of spinning. Prints one line: "ok" with the seconds of
// capture, instantiation and each round, or the first CUDA error; each
// launch is announced on the error stream with the seconds since the
// start. A fault inside cudaGraphLaunch ends the process (SIGSEGV), which
// its caller (graph_launch_repro.py) reports.
//
//   graph_launch_repro lanes top_nodes top_pairs body_nodes body_pairs passes replays
//                      threads with_while wait_s devices
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O2 -o
// graph_launch_repro graph_launch_repro.cu

#include <cuda_runtime.h>

#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <thread>
#include <vector>

#define CHECK(x)                                                                      \
  do {                                                                                \
    cudaError_t e_ = (x);                                                             \
    if (e_ != cudaSuccess) {                                                          \
      std::printf("error %s (%d) at line %d: %s\n", cudaGetErrorString(e_), (int)e_, \
                  __LINE__, #x);                                                      \
      std::fflush(stdout);                                                            \
      return 1;                                                                       \
    }                                                                                 \
  } while (0)

namespace {

__global__ void add_one(float* x) { x[threadIdx.x] += 1.0f; }

__device__ unsigned long long load_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// card d's put: 64 floats into card d+1's buffer, then one more landed
__global__ void put(const float* src, float* dst, unsigned long long* arrived) {
  dst[threadIdx.x] = src[threadIdx.x];
  __threadfence_system();
  __syncthreads();
  if (threadIdx.x == 0) atomicAdd(arrived, 1ull);
}

__device__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// card d's wait for card d-1's put: one more seen, then spin until landed
// (trap after timeout_ns)
__global__ void wait(const unsigned long long* arrived, unsigned long long* seen,
                     long long timeout_ns) {
  const unsigned long long want = ++*seen;
  const unsigned long long t0 = now_ns();
  while (load_acquire(arrived) < want) {
    if (now_ns() - t0 > static_cast<unsigned long long>(timeout_ns)) __trap();
    __nanosleep(64);
  }
}

__global__ void set_cond(cudaGraphConditionalHandle h, int* count, int passes, int reset) {
  if (reset) *count = 0;
  const int c = reset ? 0 : ++*count;
  cudaGraphSetConditional(h, c < passes ? 1u : 0u);
}

struct Card {
  int dev;
  float *x, *inbox;
  unsigned long long *arrived, *seen;
  int* count;
  cudaStream_t s, body;
  cudaGraph_t graph, body_graph;
  cudaGraphExec_t exec;
  cudaGraphConditionalHandle handle;
};

long long g_timeout_ns = 10000000000ll;

// n kernels on card d's stream `s`, with `pairs` put/wait pairs among them
void work(std::vector<Card>& c, int d, cudaStream_t s, long long n, long long pairs) {
  const int k = static_cast<int>(c.size());
  const long long every = pairs > 0 ? (n / pairs > 0 ? n / pairs : 1) : n + 1;
  long long done = 0;
  for (long long i = 0; i < n; ++i) {
    add_one<<<1, 64, 0, s>>>(c[d].x);
    if (k > 1 && (i + 1) % every == 0 && done < pairs) {
      put<<<1, 64, 0, s>>>(c[d].x, c[(d + 1) % k].inbox, c[(d + 1) % k].arrived);
      wait<<<1, 1, 0, s>>>(c[d].arrived, c[d].seen, g_timeout_ns);
      ++done;
    }
  }
}

double since(std::chrono::steady_clock::time_point t) {
  return std::chrono::duration<double>(std::chrono::steady_clock::now() - t).count();
}

}  // namespace

int main(int argc, char** argv) {
  if (argc != 12) {
    std::printf("usage: %s lanes top_nodes top_pairs body_nodes body_pairs passes replays "
                "threads with_while wait_s devices\n", argv[0]);
    return 2;
  }
  const auto start = std::chrono::steady_clock::now();
  const int k = std::atoi(argv[1]);
  const long long top = std::atoll(argv[2]), top_pairs = std::atoll(argv[3]);
  const long long body = std::atoll(argv[4]), body_pairs = std::atoll(argv[5]);
  const int passes = std::atoi(argv[6]), replays = std::atoi(argv[7]);
  const bool threads = std::atoi(argv[8]) != 0, with_while = std::atoi(argv[9]) != 0;
  g_timeout_ns = static_cast<long long>(std::atof(argv[10]) * 1e9);
  const int n_dev = std::atoi(argv[11]);
  std::vector<Card> c(k);
  for (int d = 0; d < k; ++d) {
    c[d].dev = d % n_dev;
    CHECK(cudaSetDevice(c[d].dev));
    for (int p = 0; p < n_dev && d < n_dev; ++p) {
      if (p == d) continue;
      cudaError_t e = cudaDeviceEnablePeerAccess(p, 0);
      if (e == cudaErrorPeerAccessAlreadyEnabled) (void)cudaGetLastError();
      else CHECK(e);
    }
    CHECK(cudaMalloc(&c[d].x, 64 * sizeof(float)));
    CHECK(cudaMalloc(&c[d].inbox, 64 * sizeof(float)));
    CHECK(cudaMalloc(&c[d].arrived, sizeof(unsigned long long)));
    CHECK(cudaMalloc(&c[d].seen, sizeof(unsigned long long)));
    CHECK(cudaMalloc(&c[d].count, sizeof(int)));
    CHECK(cudaMemset(c[d].x, 0, 64 * sizeof(float)));
    CHECK(cudaMemset(c[d].arrived, 0, sizeof(unsigned long long)));
    CHECK(cudaMemset(c[d].seen, 0, sizeof(unsigned long long)));
    CHECK(cudaStreamCreateWithFlags(&c[d].s, cudaStreamNonBlocking));
    CHECK(cudaStreamCreateWithFlags(&c[d].body, cudaStreamNonBlocking));
    CHECK(cudaDeviceSynchronize());
  }
  auto t0 = std::chrono::steady_clock::now();
  for (int d = 0; d < k; ++d) {
    CHECK(cudaSetDevice(c[d].dev));
    CHECK(cudaStreamBeginCapture(c[d].s, cudaStreamCaptureModeRelaxed));
  }
  for (int d = 0; d < k; ++d) {
    CHECK(cudaSetDevice(c[d].dev));
    work(c, d, c[d].s, top / 2, top_pairs / 2);
    CHECK(cudaGetLastError());
  }
  if (!with_while) {
    for (int d = 0; d < k; ++d) {
      CHECK(cudaSetDevice(c[d].dev));
      work(c, d, c[d].s, body, body_pairs);
      CHECK(cudaGetLastError());
    }
  }
  // the WHILE node on every card, then every body captured, then ended
  for (int d = 0; with_while && d < k; ++d) {
    CHECK(cudaSetDevice(c[d].dev));
    cudaStreamCaptureStatus st;
    const cudaGraphNode_t* deps = nullptr;
    size_t n_deps = 0;
    cudaGraph_t g;
    CHECK(cudaStreamGetCaptureInfo(c[d].s, &st, nullptr, &g, &deps, &n_deps));
    CHECK(cudaGraphConditionalHandleCreate(&c[d].handle, g, 0, 0));
    set_cond<<<1, 1, 0, c[d].s>>>(c[d].handle, c[d].count, passes, 1);
    CHECK(cudaGetLastError());
    CHECK(cudaStreamGetCaptureInfo(c[d].s, &st, nullptr, &g, &deps, &n_deps));
    cudaGraphNodeParams params = {};
    params.type = cudaGraphNodeTypeConditional;
    params.conditional.handle = c[d].handle;
    params.conditional.type = cudaGraphCondTypeWhile;
    params.conditional.size = 1;
    cudaGraphNode_t node;
    CHECK(cudaGraphAddNode(&node, g, deps, n_deps, &params));
    CHECK(cudaStreamUpdateCaptureDependencies(c[d].s, &node, 1, cudaStreamSetCaptureDependencies));
    c[d].body_graph = params.conditional.phGraph_out[0];
  }
  for (int d = 0; with_while && d < k; ++d) {
    CHECK(cudaSetDevice(c[d].dev));
    CHECK(cudaStreamBeginCaptureToGraph(c[d].body, c[d].body_graph, nullptr, nullptr, 0,
                                        cudaStreamCaptureModeThreadLocal));
  }
  for (int d = 0; with_while && d < k; ++d) {
    CHECK(cudaSetDevice(c[d].dev));
    work(c, d, c[d].body, body, body_pairs);
    CHECK(cudaGetLastError());
  }
  for (int d = 0; with_while && d < k; ++d) {
    CHECK(cudaSetDevice(c[d].dev));
    set_cond<<<1, 1, 0, c[d].body>>>(c[d].handle, c[d].count, passes, 0);
    cudaGraph_t g;
    CHECK(cudaStreamEndCapture(c[d].body, &g));
  }
  for (int d = 0; d < k; ++d) {
    CHECK(cudaSetDevice(c[d].dev));
    work(c, d, c[d].s, top - top / 2, top_pairs - top_pairs / 2);
    CHECK(cudaGetLastError());
  }
  for (int d = 0; d < k; ++d) {
    CHECK(cudaSetDevice(c[d].dev));
    CHECK(cudaStreamEndCapture(c[d].s, &c[d].graph));
  }
  const double capture_s = since(t0);
  t0 = std::chrono::steady_clock::now();
  for (int d = 0; d < k; ++d) {
    CHECK(cudaSetDevice(c[d].dev));
    CHECK(cudaGraphInstantiateWithFlags(&c[d].exec, c[d].graph,
                                        cudaGraphInstantiateFlagAutoFreeOnLaunch));
    CHECK(cudaGraphDestroy(c[d].graph));
  }
  const double instantiate_s = since(t0);
  std::printf("captured %.3f s, instantiated %.3f s; launching\n", capture_s, instantiate_s);
  std::fflush(stdout);
  std::vector<double> rounds;
  for (int r = 0; r < replays; ++r) {
    t0 = std::chrono::steady_clock::now();
    if (threads) {
      std::vector<std::thread> ts;
      std::vector<cudaError_t> errs(k, cudaSuccess);
      for (int d = 0; d < k; ++d) {
        std::fprintf(stderr, "launch round %d lane %d (its thread) at %.3f s\n", r, d,
                     since(start));
        ts.emplace_back([&, d] {
          errs[d] = cudaSetDevice(c[d].dev);
          if (errs[d] == cudaSuccess) errs[d] = cudaGraphLaunch(c[d].exec, c[d].s);
        });
      }
      for (auto& t : ts) t.join();
      for (int d = 0; d < k; ++d) CHECK(errs[d]);
    } else {
      for (int d = 0; d < k; ++d) {
        CHECK(cudaSetDevice(c[d].dev));
        std::fprintf(stderr, "launch round %d lane %d at %.3f s\n", r, d, since(start));
        CHECK(cudaGraphLaunch(c[d].exec, c[d].s));
      }
    }
    for (int d = 0; d < k; ++d) {
      CHECK(cudaSetDevice(c[d].dev));
      CHECK(cudaStreamSynchronize(c[d].s));
    }
    rounds.push_back(since(t0));
  }
  float x0 = 0.0f;
  CHECK(cudaSetDevice(c[0].dev));
  CHECK(cudaMemcpy(&x0, c[0].x, sizeof(float), cudaMemcpyDeviceToHost));
  const double want = 1.0 * replays * (top + 1.0 * body * (with_while ? passes : 1));
  std::printf("ok capture_s %.3f instantiate_s %.3f x %.0f want %.0f rounds", capture_s,
              instantiate_s, x0, want);
  for (double s : rounds) std::printf(" %.4f", s);
  std::printf("\n");
  return 0;
}
