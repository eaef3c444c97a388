// Copies between cards inside CUDA graphs, one graph per card: the port's
// counterpart of the ppermute / psum transfers XLA inserts between the
// chips of the JAX package's decomposed solve. It replaces no Pallas
// kernel. A graph of one card cannot hold a memcpy node or an event of
// another card inside a WHILE body, so the data moves through kernels:
// peer_put on the source card stores straight into the destination
// card's memory (a UVA pointer, peer access enabled), and peer_wait on
// the destination card holds its stream until the data has landed.
//
// One transfer site is a channel of five 64-bit counters in device memory,
// zeroed once and never reset (they only grow, so a channel works across
// the passes of a WHILE loop and across replays):
//   on the source card       cts   the destination's waits so far (clear to send)
//                            sent  the puts of this site so far
//                            done  the blocks of the running put that finished
//   on the destination card  arrived  the puts that have landed
//                            seen     the waits of this site so far
// The wait runs at the transfer's place in the destination card's stream,
// so when it starts every earlier kernel there has ended: it first adds
// one to the source's cts (its memory is free to be written), then spins
// until arrived passes seen. The put spins until cts passes sent, copies,
// and its last block adds one to arrived. A put therefore never writes
// memory that its destination still reads for an earlier use (the
// write-after-read of pass k+1 over pass k, or of an allocation reused
// inside one pass): the design is the acknowledgement counter, not double
// buffering. Every wait points back to a transfer at the same or an
// earlier place of the one program that all cards run, so the cards
// cannot wait on each other in a ring.
//
// A spin is bounded by %globaltimer (timeout_ns): on expiry the kernel
// traps, the context fails and the next host synchronisation raises. A
// lost peer never hangs the process.
//
// What bounds them: peer_put moves its slab's bytes once over NVLink
// (450 GB/s each way on an H100 SXM) with one store per element; peer_wait
// is one thread and a few remote words (its time is the handshake's
// latency). Simple first: element stores, no TMA, one face per launch.
//
// C interface (ctypes, ops/peer.py):
//   pyapes_peer_put(stream, src, dst, elem_size, shape[4], src_strides[4],
//                   dst_strides[4], cts, sent, done, arrived, timeout_ns, blocks)
//   pyapes_peer_wait(stream, cts, arrived, seen, timeout_ns)
//   pyapes_peer_enable(device, peer)   enables peer access (already enabled: 0)
//   pyapes_peer_preload()              loads every kernel of this file on the
//                                      current device
// Every entry returns a cudaError_t code (0: success).
//
// The kernels are loaded before their first launch: under CUDA's lazy
// module loading (the default since 12.2) the first launch of a put behind
// a spinning wait must load its module, and that load waits for the
// running kernel, which waits for the put (a deadlock the timeout ends).

#include "common.cuh"

namespace {

struct Slab {
  long long n[4];   // extents, outermost first (unused leading ones are 1)
  long long ss[4];  // source strides, in elements
  long long ds[4];  // destination strides, in elements
};

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned long long load_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void add_release(unsigned long long* p, unsigned long long v) {
  asm volatile("red.release.sys.global.add.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// Spin until *counter > past; trap once timeout_ns have gone by.
__device__ __forceinline__ void spin_past(const unsigned long long* counter,
                                          unsigned long long past, long long timeout_ns) {
  const unsigned long long t0 = now_ns();
  while (load_acquire(counter) <= past) {
    if (now_ns() - t0 > static_cast<unsigned long long>(timeout_ns)) __trap();
    __nanosleep(64);
  }
}

template <typename E>
__global__ void peer_put_kernel(const E* __restrict__ src, E* __restrict__ dst, Slab s,
                                unsigned long long* cts, unsigned long long* sent,
                                unsigned long long* done, unsigned long long* arrived,
                                long long timeout_ns) {
  // sent is read before any block's done increment, and only the last block
  // advances it, after every block's increment: all blocks read one value
  const unsigned long long k = *reinterpret_cast<volatile unsigned long long*>(sent);
  if (threadIdx.x == 0) spin_past(cts, k, timeout_ns);
  __syncthreads();
  const long long n3 = s.n[3], n23 = s.n[2] * n3, n123 = s.n[1] * n23;
  const long long total = s.n[0] * n123;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long i0 = i / n123, r0 = i - i0 * n123;
    const long long i1 = r0 / n23, r1 = r0 - i1 * n23;
    const long long i2 = r1 / n3, i3 = r1 - i2 * n3;
    dst[i0 * s.ds[0] + i1 * s.ds[1] + i2 * s.ds[2] + i3 * s.ds[3]] =
        src[i0 * s.ss[0] + i1 * s.ss[1] + i2 * s.ss[2] + i3 * s.ss[3]];
  }
  __threadfence_system();  // this block's stores, seen by every card before its count
  __syncthreads();
  if (threadIdx.x == 0) {
    if (atomicAdd(done, 1ull) == gridDim.x - 1) {  // the last block of the put
      *done = 0;
      *sent = k + 1;
      __threadfence_system();
      add_release(arrived, 1ull);
    }
  }
}

__global__ void peer_wait_kernel(unsigned long long* cts, unsigned long long* arrived,
                                 unsigned long long* seen, long long timeout_ns) {
  const unsigned long long k = *seen;
  add_release(cts, 1ull);  // this card's stream is here: the put may write
  spin_past(arrived, k, timeout_ns);
  *seen = k + 1;
  __threadfence_system();
}

template <typename E>
int launch_put(cudaStream_t st, const void* src, void* dst, const Slab& s, void* cts, void* sent,
               void* done, void* arrived, long long timeout_ns, int blocks) {
  peer_put_kernel<E><<<blocks, 256, 0, st>>>(
      static_cast<const E*>(src), static_cast<E*>(dst), s,
      static_cast<unsigned long long*>(cts), static_cast<unsigned long long*>(sent),
      static_cast<unsigned long long*>(done), static_cast<unsigned long long*>(arrived),
      timeout_ns);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int pyapes_peer_put(void* stream, const void* src, void* dst, int elem_size,
                               const long long* shape, const long long* src_strides,
                               const long long* dst_strides, void* cts, void* sent, void* done,
                               void* arrived, long long timeout_ns, int blocks) {
  Slab s;
  for (int d = 0; d < 4; ++d) {
    s.n[d] = shape[d];
    s.ss[d] = src_strides[d];
    s.ds[d] = dst_strides[d];
  }
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // an element moves as raw bits of its size: a copy of any dtype
  switch (elem_size) {
    case 1:
      return launch_put<unsigned char>(st, src, dst, s, cts, sent, done, arrived, timeout_ns,
                                       blocks);
    case 2:
      return launch_put<unsigned short>(st, src, dst, s, cts, sent, done, arrived, timeout_ns,
                                        blocks);
    case 4:
      return launch_put<unsigned int>(st, src, dst, s, cts, sent, done, arrived, timeout_ns,
                                      blocks);
    case 8:
      return launch_put<unsigned long long>(st, src, dst, s, cts, sent, done, arrived,
                                            timeout_ns, blocks);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int pyapes_peer_wait(void* stream, void* cts, void* arrived, void* seen,
                                long long timeout_ns) {
  peer_wait_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(cts), static_cast<unsigned long long*>(arrived),
      static_cast<unsigned long long*>(seen), timeout_ns);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pyapes_peer_preload() {
  cudaFuncAttributes a;
  const void* fns[] = {
      reinterpret_cast<const void*>(&peer_put_kernel<unsigned char>),
      reinterpret_cast<const void*>(&peer_put_kernel<unsigned short>),
      reinterpret_cast<const void*>(&peer_put_kernel<unsigned int>),
      reinterpret_cast<const void*>(&peer_put_kernel<unsigned long long>),
      reinterpret_cast<const void*>(&peer_wait_kernel),
  };
  for (const void* f : fns) {
    cudaError_t e = cudaFuncGetAttributes(&a, f);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

extern "C" int pyapes_peer_enable(int device, int peer) {
  int prev = 0;
  cudaError_t e = cudaGetDevice(&prev);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaDeviceEnablePeerAccess(peer, 0);
  if (e == cudaErrorPeerAccessAlreadyEnabled) {
    (void)cudaGetLastError();  // clear it: already enabled is what is asked
    e = cudaSuccess;
  }
  cudaSetDevice(prev);
  return static_cast<int>(e);
}
