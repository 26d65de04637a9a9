// FMA probe: for each element, acc <- acc * a + b, `iters` times, with no
// device-memory traffic inside the loop; float32 and float64 builds.
//
// Replaces the TPU kernel of scripts/tpu_vpu_peak.py:86 (`_call`, body
// `kern` :45-65: chained whole-block FMAs on a block held in VMEM).  The
// per-element function stays; the TPU's grid of 2 (its core count) does
// not: the launch fills every SM.
//
// Bound on an H100: operations, 2 flops an FMA (the script's count),
// against the card's non-tensor f32 or f64 peak.  Each thread keeps
// kAcc independent accumulators, so the loop measures the FMA pipe's
// throughput and not its latency; the loop is unrolled so that its own
// counter costs few issue slots.
#include <cmath>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float fma_of(float x, float a, float b) {
  return fmaf(x, a, b);
}

__device__ __forceinline__ double fma_of(double x, double a, double b) {
  return fma(x, a, b);
}

// Thread t of block g owns elements (g * kAcc + j) * blockDim + t, j <
// kAcc: neighbouring threads on neighbouring addresses.
template <class T, int kAcc>
__global__ void __launch_bounds__(kThreads)
fma_chain_kernel(const T* x, T* y, long long n,
                 long long iters, T a, T b) {
  const long long base =
      static_cast<long long>(blockIdx.x) * kAcc * blockDim.x + threadIdx.x;
  T acc[kAcc];
#pragma unroll
  for (int j = 0; j < kAcc; ++j) {
    const long long e = base + static_cast<long long>(j) * blockDim.x;
    acc[j] = e < n ? x[e] : T(0);
  }
#pragma unroll 16
  for (long long i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < kAcc; ++j) acc[j] = fma_of(acc[j], a, b);
  }
#pragma unroll
  for (int j = 0; j < kAcc; ++j) {
    const long long e = base + static_cast<long long>(j) * blockDim.x;
    if (e < n) y[e] = acc[j];
  }
}

template <class T, int kAcc>
int launch(const T* x, T* y, long long n, long long iters, T a, T b,
           void* stream) {
  const long long per = 1ll * kThreads * kAcc;
  const long long blocks = (n + per - 1) / per;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const unsigned threads =
      n < kThreads ? static_cast<unsigned>((n + 31) / 32 * 32) : kThreads;
  auto kern = &fma_chain_kernel<T, kAcc>;
  kern<<<static_cast<unsigned>(blocks), threads, 0,
         static_cast<cudaStream_t>(stream)>>>(x, y, n, iters, a, b);
  return cudaGetLastError();
}

template <class T>
int fma_chain(const T* x, T* y, long long n, long long iters, int acc, T a,
              T b, void* stream) {
  if (n < 1 || iters < 0) return cudaErrorInvalidValue;
  switch (acc) {
    case 1: return launch<T, 1>(x, y, n, iters, a, b, stream);
    case 4: return launch<T, 4>(x, y, n, iters, a, b, stream);
    case 8: return launch<T, 8>(x, y, n, iters, a, b, stream);
    case 16: return launch<T, 16>(x, y, n, iters, a, b, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// y[e] = x[e] after `iters` steps of acc * a + b, for n contiguous
// elements; `acc` (1, 4, 8 or 16) accumulators a thread.  y may be x.
extern "C" int mff_fma_chain_f32(const float* x, float* y, long long n,
                                 long long iters, int acc, float a, float b,
                                 void* stream) {
  return fma_chain(x, y, n, iters, acc, a, b, stream);
}

extern "C" int mff_fma_chain_f64(const double* x, double* y, long long n,
                                 long long iters, int acc, double a,
                                 double b, void* stream) {
  return fma_chain(x, y, n, iters, acc, a, b, stream);
}
