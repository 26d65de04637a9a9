// CPU emulation of the parts of the CUDA runtime that the port's kernels
// (mpi4py_fft_torch/ops/csrc) use, for tests/test_torch_kernel_emu.py.
//
// A launch runs its blocks one after another; each block runs as
// blockDim.x real threads that share one shared-memory array and meet at
// __syncthreads() on a std::barrier, so a missing barrier or a race on
// the tile shows up as a wrong result.  Each warp of 32 threads has a
// barrier of its own for __syncwarp().  A cluster launch
// (cudaLaunchKernelEx with a cluster dimension) runs the CTAs of one
// cluster at once, each with its own shared memory, and the whole cluster
// meets at the cluster barrier of cooperative_groups.h (this directory),
// which also maps an address to the same object in a peer CTA.  Shared
// memory starts filled with garbage, as on the card.  Compile with
// g++ -std=c++20 -pthread.
#pragma once

#include <algorithm>
#include <atomic>
#include <barrier>
#include <cstdint>
#include <deque>
#include <cstddef>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
};
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
// this thread's block, warp and cluster barriers, its block's shared
// memory, and the shared memory of each CTA of its cluster by rank
inline thread_local std::barrier<>* emu_barrier = nullptr;
inline thread_local std::barrier<>* emu_warp_barrier = nullptr;
inline thread_local std::barrier<>* emu_cluster_barrier = nullptr;
inline thread_local unsigned char* emu_smem = nullptr;
inline thread_local unsigned char* const* emu_cluster_smem = nullptr;
inline thread_local unsigned emu_cluster_rank = 0;

// what a test reads to tell which kernel ran: the cluster launches, the
// __syncwarp() calls and the __ldcg() loads since the library was loaded
// (each library is one translation unit, so these are defined once in it)
inline std::atomic<long long> emu_clusters{0}, emu_warp_syncs{0},
    emu_ldcgs{0};
extern "C" long long emu_cluster_launches() { return emu_clusters; }
extern "C" long long emu_syncwarps() { return emu_warp_syncs; }
extern "C" long long emu_ldcg_loads() { return emu_ldcgs; }

#define __syncthreads() emu_barrier->arrive_and_wait()
inline void __syncwarp(unsigned = 0xffffffffu) {
  ++emu_warp_syncs;
  emu_warp_barrier->arrive_and_wait();
}
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(x)

struct alignas(16) float4 {
  float x, y, z, w;
};
struct alignas(8) float2 {
  float x, y;
};
inline float2 make_float2(float x, float y) { return float2{x, y}; }
struct alignas(16) double2 {
  double x, y;
};
inline float4 make_float4(float x, float y, float z, float w) {
  return float4{x, y, z, w};
}
inline double2 make_double2(double x, double y) { return double2{x, y}; }

template <class T>
inline T __ldg(const T* p) {
  return *p;
}
template <class T>
inline T __ldcg(const T* p) {
  ++emu_ldcgs;
  return *p;
}

// device-wide atomics and fences (the blocks of a launch run one after
// another, the threads of a block at once)
inline int atomicAdd(int* p, int v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
inline void __threadfence() { __atomic_thread_fence(__ATOMIC_SEQ_CST); }
inline void __nanosleep(unsigned) { std::this_thread::yield(); }
inline void __trap() { std::abort(); }

typedef void* cudaStream_t;
typedef int cudaError_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorInvalidConfiguration = 9,
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
  cudaDevAttrMultiProcessorCount = 16
};
constexpr std::size_t kEmuMaxShared = 232448;   // an H100 block's limit

inline const char* cudaGetErrorString(cudaError_t e) {
  return e ? "emulated launch error" : "no error";
}
inline int emu_last_error = 0;
inline cudaError_t cudaGetLastError() {
  const int e = emu_last_error;
  emu_last_error = 0;
  return e;
}
template <class F>
inline cudaError_t cudaFuncSetAttribute(F, int, int bytes) {
  return static_cast<std::size_t>(bytes) > kEmuMaxShared
             ? cudaErrorInvalidValue : cudaSuccess;
}

// an emulated device of two SMs
inline cudaError_t cudaGetDevice(int* dev) {
  *dev = 0;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* value, int, int) {
  *value = 2;
  return cudaSuccess;
}

// The launch of `ctas` CTAs at once (one cluster, or one block when
// ctas = 1), blocks first..first+ctas-1, each with `threads` threads and
// `shared` bytes of its own shared memory.
template <class F>
inline void emu_run_ctas(F body, unsigned first, unsigned ctas, int threads,
                         std::size_t shared) {
  std::vector<std::vector<unsigned char>> mem(ctas);
  std::vector<unsigned char*> bases(ctas);
  std::deque<std::barrier<>> blocks, warps;
  for (unsigned r = 0; r < ctas; ++r) {
    mem[r].resize(shared + 16, 0xff);
    auto a = reinterpret_cast<std::uintptr_t>(mem[r].data());
    bases[r] = mem[r].data() + (16 - a % 16) % 16;
    blocks.emplace_back(threads);
    for (int w = 0; w < threads; w += 32)
      warps.emplace_back(std::min(32, threads - w));
  }
  std::barrier<> cluster(static_cast<std::ptrdiff_t>(ctas) * threads);
  const int nw = (threads + 31) / 32;
  std::vector<std::thread> ts;
  ts.reserve(ctas * threads);
  for (unsigned r = 0; r < ctas; ++r)
    for (int t = 0; t < threads; ++t)
      ts.emplace_back([&, r, t] {
        threadIdx.x = t;
        blockIdx.x = first + r;
        emu_barrier = &blocks[r];
        emu_warp_barrier = &warps[r * nw + t / 32];
        emu_cluster_barrier = &cluster;
        emu_smem = bases[r];
        emu_cluster_smem = bases.data();
        emu_cluster_rank = r;
        body();
      });
  for (auto& th : ts) th.join();
}

// kernel<<<grid, threads, shared, stream>>>(args...) becomes
// emu_launch(kernel, grid, threads, shared, stream, args...)
template <class F, class... A>
inline void emu_launch(F f, unsigned grid, int threads, std::size_t shared,
                       cudaStream_t, A... args) {
  if (threads < 1 || threads > 1024 || shared > kEmuMaxShared) {
    emu_last_error = cudaErrorInvalidConfiguration;
    return;
  }
  gridDim.x = grid;
  blockDim.x = threads;
  for (unsigned b = 0; b < grid; ++b)
    emu_run_ctas([&] { f(args...); }, b, 1, threads, shared);
}

// cudaLaunchKernelEx with the one attribute the kernels use: a cluster
// dimension along x.  The clusters run one after another, the CTAs of a
// cluster at once.
enum { cudaLaunchAttributeClusterDimension = 4 };
struct cudaLaunchAttributeValue {
  struct {
    unsigned x, y, z;
  } clusterDim;
};
struct cudaLaunchAttribute {
  int id;
  cudaLaunchAttributeValue val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  std::size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};

inline unsigned emu_cluster_size(const cudaLaunchConfig_t* cfg) {
  unsigned n = 1;
  for (unsigned i = 0; i < cfg->numAttrs; ++i)
    if (cfg->attrs[i].id == cudaLaunchAttributeClusterDimension)
      n = cfg->attrs[i].val.clusterDim.x;
  return n;
}

template <class... E, class... A>
inline cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg,
                                      void (*f)(E...), A&&... args) {
  const unsigned cl = emu_cluster_size(cfg);
  const int threads = static_cast<int>(cfg->blockDim.x);
  if (threads < 1 || threads > 1024 || cfg->dynamicSmemBytes > kEmuMaxShared
      || cl < 1 || cl > 8 || cfg->gridDim.x % cl != 0)
    return cudaErrorInvalidConfiguration;
  gridDim = cfg->gridDim;
  blockDim = cfg->blockDim;
  if (cl > 1) ++emu_clusters;
  for (unsigned b = 0; b < cfg->gridDim.x; b += cl)
    emu_run_ctas([&] { f(args...); }, b, cl, threads,
                 cfg->dynamicSmemBytes);
  return cudaSuccess;
}

// an emulated device that holds one cluster, or one block an SM, at a
// time
inline cudaError_t cudaOccupancyMaxActiveClusters(
    int* count, const void*, const cudaLaunchConfig_t* cfg) {
  *count = cfg->dynamicSmemBytes <= kEmuMaxShared ? 1 : 0;
  return cudaSuccess;
}
template <class F>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(
    int* count, F, int, std::size_t shared) {
  *count = shared <= kEmuMaxShared ? 1 : 0;
  return cudaSuccess;
}
