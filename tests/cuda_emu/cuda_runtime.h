// CPU emulation of the parts of the CUDA runtime that the port's kernels
// (mpi4py_fft_torch/ops/csrc) use, for tests/test_torch_kernel_emu.py.
//
// A launch runs its blocks one after another; each block runs as
// blockDim.x real threads that share one shared-memory array and meet at
// __syncthreads() on a std::barrier, so a missing barrier or a race on
// the tile shows up as a wrong result.  Shared memory starts filled with
// garbage, as on the card.  Compile with g++ -std=c++20 -pthread.
#pragma once

#include <barrier>
#include <cstddef>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
};
inline thread_local dim3 threadIdx;
inline dim3 blockIdx, blockDim, gridDim;
inline std::barrier<>* emu_barrier = nullptr;

#define __syncthreads() emu_barrier->arrive_and_wait()
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(x)

template <class T>
inline T __ldg(const T* p) {
  return *p;
}
template <class T>
inline T __ldcg(const T* p) {
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

alignas(16) inline unsigned char emu_smem[kEmuMaxShared];

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
  for (unsigned b = 0; b < grid; ++b) {
    blockIdx.x = b;
    std::memset(emu_smem, 0xff, shared);
    std::barrier<> bar(threads);
    emu_barrier = &bar;
    std::vector<std::thread> ts;
    ts.reserve(threads);
    for (int t = 0; t < threads; ++t)
      ts.emplace_back([&, t] {
        threadIdx.x = t;
        f(args...);
      });
    for (auto& th : ts) th.join();
  }
}
