// fft_axis_p: unnormalized planar c2c Stockham FFT along one axis, for
// N = 2^a or 3*2^a <= 1024, either sign, with an optional scale folded into
// the last write; built for float32 and for float64.
//
// Replaces the TPU kernels of mpi4py_fft_tpu/ops/pallas_butterfly.py
// reached from fft_axis_p :795 through _dispatch :680: _kern_lead :623,
// _kern_lead1 :631, _kern_mid :521, _kern_last :598, _kern_last2 :610 and
// _kern_lead_w/_kern_mid_w :586/:570.  One strided kernel covers every
// axis position: it works on the (2, pre, N, post) view of a contiguous
// tensor and computes its offsets from pre and post.
//
// The float64 build replaces the double-single kernels of
// mpi4py_fft_tpu/ops/pallas_ds.py reached from fft_axis_ds :368 through
// _dispatch_ds/_dispatch_ds_mid/_dispatch_ds_last :325-365 (_kern_lead_ds,
// _kern_mid_ds, _kern_last_ds :255-288): the same kernel in native f64,
// with the f64 tile budget of butterfly.cuh.
//
// Bound on an H100: bytes.  One pass reads and writes the volume once
// (16 bytes per complex point, 32 at f64); 5 N log2 N flops per line is
// about 3 flops per byte at N = 1024 (1.6 at f64), below the card's ratio
// of peak flops to bandwidth (about 20 at f32, 10 at f64).
// Design: one block takes a tile of C lines (C adjacent post columns of
// one pre index, or C whole lines when post == 1), loads it with
// neighbouring threads on neighbouring addresses, runs every Stockham
// stage in shared memory and writes the tile once: the two unavoidable
// passes over device memory and nothing else.
#include <cstdint>

#include "butterfly.cuh"

namespace {

// Offset of element 0 of each tile line; -1 past the last line.
__device__ __forceinline__ void line_bases(long long* base, long long l0,
                                           long long nlines, int C, int n,
                                           long long post) {
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const long long l = l0 + c;
    base[c] = l < nlines ? (l / post) * n * post + l % post : -1;
  }
}

template <class T, int kBlocks>
__global__ void __launch_bounds__(mff::Budget<T>::kTile / 16, kBlocks)
fft_axis_kernel(const T* __restrict__ x, T* __restrict__ y,
                const T* __restrict__ tw, long long tw_len, long long pre,
                int n, long long post, T sign, mff::Plan plan, T scale,
                int lc) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = 1 << lc;
  long long* base = reinterpret_cast<long long*>(smem);
  mff::Tile<T> t;
  t.lc = lc;
  t.cp = C + 1;
  t.re = reinterpret_cast<T*>(base + C);
  t.im = t.re + n * t.cp;
  const long long nlines = pre * post;
  const long long plane = nlines * n;
  line_bases(base, static_cast<long long>(blockIdx.x) << lc, nlines, C, n,
             post);
  __syncthreads();

  const int total = n << lc;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    int c, k;
    if (post == 1) {        // whole lines: neighbours along the line
      c = idx / n;
      k = idx - c * n;
    } else {                // neighbours across lines (post columns)
      c = idx & (C - 1);
      k = idx >> lc;
    }
    const long long b = base[c];
    T vr = 0, vi = 0;
    if (b >= 0) {
      const long long a = b + k * post;
      vr = x[a];
      vi = x[plane + a];
    }
    t.re[k * t.cp + c] = vr;
    t.im[k * t.cp + c] = vi;
  }
  __syncthreads();

  mff::run_plan(t, n, plan, tw, tw + tw_len, sign);

  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    int c, k;
    if (post == 1) {
      c = idx / n;
      k = idx - c * n;
    } else {
      c = idx & (C - 1);
      k = idx >> lc;
    }
    const long long b = base[c];
    if (b >= 0) {
      const long long a = b + k * post;
      y[a] = t.re[k * t.cp + c] * scale;
      y[plane + a] = t.im[k * t.cp + c] * scale;
    }
  }
}

template <class T>
int launch_fft_axis(const T* x, T* y, const T* tw, long long tw_len,
                    long long pre, int n, long long post, int sign,
                    const int* plan, int nstages, T scale, void* stream) {
  mff::Plan p;
  if (!mff::make_plan(plan, nstages, n, &p)) return cudaErrorInvalidValue;
  const int lc = mff::tile_log2_lines<T>(n);
  const int C = 1 << lc;
  const long long nlines = pre * post;
  const long long blocks = (nlines + C - 1) / C;
  if (nlines <= 0 || blocks > 0x7fffffffLL || ((n << lc) % 16) != 0)
    return cudaErrorInvalidValue;
  const int threads = (n << lc) / 16;
  const size_t smem = sizeof(long long) * C +
                      2 * sizeof(T) * static_cast<size_t>(n) * (C + 1);
  using B = mff::Budget<T>;
  auto kern = mff::pick_bound<T>(smem, &fft_axis_kernel<T, B::kMinBlocks>,
                                 &fft_axis_kernel<T, B::kWideMinBlocks>);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kern<<<static_cast<unsigned>(blocks), threads, smem,
         static_cast<cudaStream_t>(stream)>>>(
      x, y, tw, tw_len, pre, n, post, static_cast<T>(sign), p, scale, lc);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* mff_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}

// x, y: (2, pre, n, post) float32, contiguous, on the current device.
// tw: the (2, tw_len) table of _tw_pack(n, sign).  Returns
// cudaGetLastError() after the launch.
extern "C" int mff_fft_axis_f32(const float* x, float* y, const float* tw,
                                long long tw_len, long long pre, int n,
                                long long post, int sign, const int* plan,
                                int nstages, float scale, void* stream) {
  return launch_fft_axis(x, y, tw, tw_len, pre, n, post, sign, plan,
                         nstages, scale, stream);
}

// The same for float64 x, y and tw, with a double scale.
extern "C" int mff_fft_axis_f64(const double* x, double* y, const double* tw,
                                long long tw_len, long long pre, int n,
                                long long post, int sign, const int* plan,
                                int nstages, double scale, void* stream) {
  return launch_fft_axis(x, y, tw, tw_len, pre, n, post, sign, plan,
                         nstages, scale, stream);
}
