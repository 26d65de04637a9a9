// fft_plane_p (H) and fft_plane_large_p (I): unnormalized planar c2c FFT
// over the last two axes of (2, P, N1, N2) float32 data in one launch,
// N1 and N2 powers of two up to 1024, either sign, with an optional scale
// folded into the last write.  The last axis (N2) is transformed first,
// then the second-to-last (N1), as the JAX kernels order the two stages.
//
// Replaces the TPU kernels of mpi4py_fft_tpu/ops/pallas_butterfly.py
// reached from fft_plane_p :1056 through _dispatch_plane :1018
// (_kern_plane :981, planes of N1, N2 <= 256 packed T to a block) and from
// fft_plane_large_p :1167 through _dispatch_plane_large :1139
// (_kern_plane_large :1095, one full plane of N1*N2 <= 2^20 a block).
// One kernel serves both entries: they compute the same function.
//
// Bound on an H100: bytes, as fft_axis.cu (about 3 flops a byte a pass).
// A plane does not fit one block's shared memory (256 x 256 complex f32
// is 512 KB, 1024 x 1024 is 8 MB, against 227 KB), so the two axes take
// two tiles each: the saving over two passes of A is that the plane goes
// from the first axis to the second through L2 (50 MB) instead of HBM
// while a few planes are in flight.  The least the card can take is one
// read and one write of the volume.
//
// Design: a persistent grid (the SMs times the blocks an SM holds) takes
// work items from a counter in device memory, in order.  Plane q gives
// first its row items (C2 whole rows of N2 points each, A's tile with
// neighbours along the line, from x into y), then its column items (C1
// adjacent columns of N1 points, stride N2, read from y, transformed and
// written back in place with the scale).  A row item, once written, adds
// one to q's counter (every thread fences its stores first); a column item
// of q waits until that counter holds q's row items, then reads through
// L2 (__ldcg).  An item only waits on items taken before it, by blocks
// that are running, and a row item waits on nothing: no deadlock, and a
// grid whose blocks run one after another runs the queue in order.
#include <algorithm>
#include <climits>
#include <cstdint>

#include "butterfly.cuh"

namespace {

constexpr int kThreads = mff::Budget<float>::kTile / 16;

// counters: [0] the next item, [1 + q] the row items of plane q done.
template <int kBlocks>
__global__ void __launch_bounds__(kThreads, kBlocks)
fft_plane_kernel(const float* __restrict__ x, float* y,
                 const float* __restrict__ tw2, long long tw2_len,
                 const float* __restrict__ tw1, long long tw1_len,
                 long long P, int n1, int n2, float sign, mff::Plan plan2,
                 mff::Plan plan1, float scale, int* counters, int lc2,
                 int lc1) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* slot = reinterpret_cast<int*>(smem);
  float* tile = reinterpret_cast<float*>(smem + 16);
  const int rows = n1 >> lc2;          // row items a plane
  const int per = rows + (n2 >> lc1);  // items a plane
  const long long total = P * per;
  const long long area = static_cast<long long>(n1) * n2;
  const long long plane = P * area;    // offset of the imaginary parts
  int* next = counters;
  int* done = counters + 1;

  for (;;) {
    if (threadIdx.x == 0) slot[0] = atomicAdd(next, 1);
    __syncthreads();
    const int item = slot[0];
    __syncthreads();
    if (item >= total) break;
    const long long q = item / per;
    const int j = item - static_cast<int>(q * per);
    const long long base = q * area;
    mff::Tile<float> t;
    t.re = tile;
    if (j < rows) {
      // rows j*C2 .. of plane q: lines of n2 contiguous points, x -> y
      t.lc = lc2;
      t.cp = (1 << lc2) + 1;
      t.im = t.re + n2 * t.cp;
      const long long r0 = base + static_cast<long long>(j << lc2) * n2;
      const int count = n2 << lc2;
      for (int idx = threadIdx.x; idx < count; idx += blockDim.x) {
        const int c = idx / n2;
        const int k = idx - c * n2;
        t.re[k * t.cp + c] = x[r0 + idx];
        t.im[k * t.cp + c] = x[plane + r0 + idx];
      }
      __syncthreads();
      mff::run_plan(t, n2, plan2, tw2, tw2 + tw2_len, sign);
      for (int idx = threadIdx.x; idx < count; idx += blockDim.x) {
        const int c = idx / n2;
        const int k = idx - c * n2;
        y[r0 + idx] = t.re[k * t.cp + c];
        y[plane + r0 + idx] = t.im[k * t.cp + c];
      }
      __threadfence();
      __syncthreads();
      if (threadIdx.x == 0) atomicAdd(done + q, 1);
    } else {
      // columns (j - rows)*C1 .. of plane q: lines of n1 points, stride
      // n2, read from y once q's rows are all written, and written back
      if (threadIdx.x == 0) {
        // the row items were taken before this one and wait on nothing;
        // a count that never comes is a fault: stop, do not hang
        long long spins = 0;
        while (atomicAdd(done + q, 0) < rows) {
          __nanosleep(128);
          if (++spins > (1LL << 26)) __trap();
        }
        __threadfence();
      }
      __syncthreads();
      t.lc = lc1;
      t.cp = (1 << lc1) + 1;
      t.im = t.re + n1 * t.cp;
      const long long c0 = base + (static_cast<long long>(j - rows) << lc1);
      const int count = n1 << lc1;
      const int cmask = (1 << lc1) - 1;
      for (int idx = threadIdx.x; idx < count; idx += blockDim.x) {
        const int c = idx & cmask;
        const int k = idx >> lc1;
        const long long a = c0 + static_cast<long long>(k) * n2 + c;
        t.re[k * t.cp + c] = __ldcg(y + a);
        t.im[k * t.cp + c] = __ldcg(y + plane + a);
      }
      __syncthreads();
      mff::run_plan(t, n1, plan1, tw1, tw1 + tw1_len, sign);
      for (int idx = threadIdx.x; idx < count; idx += blockDim.x) {
        const int c = idx & cmask;
        const int k = idx >> lc1;
        const long long a = c0 + static_cast<long long>(k) * n2 + c;
        y[a] = t.re[k * t.cp + c] * scale;
        y[plane + a] = t.im[k * t.cp + c] * scale;
      }
      __syncthreads();
    }
  }
}

int log2_of(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return l;
}

}  // namespace

// x, y: (2, P, n1, n2) float32, contiguous and distinct, on the current
// device; tw2/tw1: the (2, len) tables of _tw_pack(n2, sign) and
// _tw_pack(n1, sign); plan2/plan1 their stage radices; counters: P + 1
// ints set to 0.  Returns cudaGetLastError() after the launch.
extern "C" int mff_fft_plane_f32(const float* x, float* y, const float* tw2,
                                 long long tw2_len, const float* tw1,
                                 long long tw1_len, long long P, int n1,
                                 int n2, int sign, const int* plan2,
                                 int nst2, const int* plan1, int nst1,
                                 float scale, int* counters, void* stream) {
  mff::Plan p2, p1;
  if (!mff::make_plan(plan2, nst2, n2, &p2) ||
      !mff::make_plan(plan1, nst1, n1, &p1) || P <= 0 ||
      n1 < 2 || n2 < 2 || n1 > 1024 || n2 > 1024 || (n1 & (n1 - 1)) ||
      (n2 & (n2 - 1)) || (sign != 1 && sign != -1))
    return cudaErrorInvalidValue;
  // C2 rows of n2 and C1 columns of n1 a tile, at most the plane's
  const int lc2 = std::min(mff::tile_log2_lines<float>(n2), log2_of(n1));
  const int lc1 = std::min(mff::tile_log2_lines<float>(n1), log2_of(n2));
  const long long per = (n1 >> lc2) + (n2 >> lc1);
  // the item counter passes the last item once a block
  if (P * per > INT_MAX / 2) return cudaErrorInvalidValue;
  const size_t cells = std::max(static_cast<size_t>(n2) * ((1 << lc2) + 1),
                                static_cast<size_t>(n1) * ((1 << lc1) + 1));
  const size_t smem = 16 + 2 * sizeof(float) * cells;
  using B = mff::Budget<float>;
  const bool narrow = mff::fits_blocks(smem, B::kMinBlocks);
  auto kern = narrow ? &fft_plane_kernel<B::kMinBlocks>
                     : &fft_plane_kernel<B::kWideMinBlocks>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const long long grid = std::min<long long>(
      P * per, static_cast<long long>(sms) *
                   (narrow ? B::kMinBlocks : B::kWideMinBlocks));
  kern<<<static_cast<unsigned>(grid), kThreads, smem,
         static_cast<cudaStream_t>(stream)>>>(
      x, y, tw2, tw2_len, tw1, tw1_len, P, n1, n2, static_cast<float>(sign),
      p2, p1, scale, counters, lc2, lc1);
  return cudaGetLastError();
}
