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
//
// At N = 512, 768 and 1024 (the lengths timed against the tile on the
// card) both builds take two other kernels, chosen by shape and alignment
// before the launch; the tile kernel keeps every other call.  The tile's
// stages hold 16 points a thread across a block barrier (float32: 40
// registers and 968 B of spill stores a thread; float64: 80 and 1852 B at
// W = 512, 128 and 1408 B at 1024), and its loads move one element a
// thread: 64- or 32-byte row segments at the lead and mid positions
// (1.45 TB/s on the 1024^3 lead axis of an H100, where copies of the
// same boxes reach 2.7), misaligned at the DNS's odd post = 257.
// * Whole lines (post == 1), x and y 16-byte aligned: the line kernel
//   (lines.cuh's line body, as fft_axis2.cu's, on the tensor's two
//   halves).  A group of G = N / P threads inside one warp holds a line
//   in registers, P points a thread (float64 16, 24 at 768, B64's, 32 at
//   1024, 255 registers and no spill; float32 32, 24 at 768, D's lines),
//   loads it as 16-byte vectors of adjacent points, and runs Stockham
//   stages (radix 8, 16, then the rest; 3, 8, 8, .. at 768) with the
//   exchange through the group's buffer behind __syncwarp.  At N = 1024
//   a float64 line on a 64-thread block (16 points a thread, the exchange
//   behind __syncthreads) ran as fast on an H100 (PERF.md §6).
// * post > 1: the column band kernel (lines.cuh's band body).  A CTA
//   (256 threads, three an SM; up to 4096 points of each component in
//   float64, 8192 in float32, D's band's, which runs them on 512 threads,
//   two an SM)
//   holds R = N / K rows of C adjacent lines (the most C with R C within
//   those points) on a cluster of K = band_cluster(N) CTAs, with one
//   radix-K step across it (float64: 4 at 1024, 2 at 512, the fastest of
//   1, 2 and 4 on an H100, 768 on 4 as 1024; float32: 4, D's).  Its loads
//   and stores move 16-byte vectors of adjacent columns where post is a
//   multiple of the vector and x and y are 16-byte aligned (no vector
//   then straddles two pre rows), else single elements (the DNS's mid
//   pass and the dealiased 'f' plan's, post = 257).  The columns run as
//   H's in-place radix-8 stages (after a radix-3 stage at 768), one
//   butterfly a thread at a time, and the store writes row segments with
//   the scale.
// Every kernel reads each line whole before it writes any of it, and no
// two blocks or clusters share a line, so y may be x.
#include <cstdint>

#include "lines.cuh"

namespace {

using mff::AxisBandBudget;
using mff::axis_line_points;
using mff::Half;
using mff::band_cluster;

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

// ---------------------------------------------------------------------------
// N = 512, 768, 1024: the line kernel (post == 1) and the band kernel
// (post > 1)
// ---------------------------------------------------------------------------

template <class T, int N>
__global__ void __launch_bounds__(mff::LineLaunch<T>::kThreads,
                                  mff::LineLaunch<T>::kMinBlocks)
fft_lines_kernel(Half<const T> a, Half<const T> b, Half<T> oa, Half<T> ob,
                 const T* __restrict__ twr, const T* __restrict__ twi,
                 long long lines, T sign, T scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  mff::line_body<T, N, axis_line_points<T>(N)>(
      a, b, oa, ob, twr, twi, lines, sign, scale,
      reinterpret_cast<T*>(smem));
}

template <class T, int N>
int launch_lines(Half<const T> a, Half<const T> b, Half<T> oa, Half<T> ob,
                 const T* twr, const T* twi, long long lines, T sign,
                 T scale, cudaStream_t stream) {
  constexpr int G = N / axis_line_points<T>(N);
  constexpr int threads = mff::LineLaunch<T>::kThreads;
  const long long blocks = (lines + threads / G - 1) / (threads / G);
  return mff::launch_ex(&fft_lines_kernel<T, N>, blocks, threads,
                        sizeof(T) * 2 * mff::row_buf(N) * (threads / G), 1,
                        stream, a, b, oa, ob, twr, twi, lines, sign, scale);
}

template <class T, int K, bool kVec, int kB>
__global__ void __launch_bounds__(AxisBandBudget<T>::kThreads,
                                  AxisBandBudget<T>::kMinBlocks)
fft_band_kernel(Half<const T> a, Half<const T> b, Half<T> oa, Half<T> ob,
                const T* __restrict__ twr, const T* __restrict__ twi,
                long long pre, long long post, int lr, int lc, T sign,
                T scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  mff::axis_band<T, K, kVec, kB, AxisBandBudget<T>>(
      a, b, oa, ob, twr, twi, pre, post, lr, lc, sign, scale,
      reinterpret_cast<T*>(smem));
}

template <class T, int K, int kB>
auto band_kernel(bool vec) {
  return vec ? &fft_band_kernel<T, K, true, kB>
             : &fft_band_kernel<T, K, false, kB>;
}

// The line or band kernel for an n-point pass of x into y, or -1 if
// neither takes it (the tile kernel does); twr, twi: the powers of w_n.
template <class T>
int launch_lines_bands(const T* x, T* y, const T* twr, const T* twi,
                       long long pre, int n, long long post, T sign,
                       T scale, cudaStream_t stream) {
  const auto mis = [](const void* p) {
    return reinterpret_cast<std::uintptr_t>(p) % 16 != 0;
  };
  const long long plane = pre * n * post;
  const long long h = (n / 2) * post;
  const Half<const T> a{x, plane, n * post}, b{x + h, plane, n * post};
  const Half<T> oa{y, plane, n * post}, ob{y + h, plane, n * post};
  if (n != 512 && n != 768 && n != 1024) return -1;
  if (post == 1) {
    if (mis(x) || mis(y)) return -1;
    return n == 512   ? launch_lines<T, 512>(a, b, oa, ob, twr, twi, pre,
                                             sign, scale, stream)
           : n == 768 ? launch_lines<T, 768>(a, b, oa, ob, twr, twi, pre,
                                             sign, scale, stream)
                      : launch_lines<T, 1024>(a, b, oa, ob, twr, twi, pre,
                                              sign, scale, stream);
  }
  const bool k3 = n == 768;
  const int K = band_cluster<T>(n);
  const int R = n / K;                       // kB 2^lr rows a CTA
  const int lr = mff::log2_of(R / (k3 ? 3 : 1));
  const int lc = mff::band_log2_cols<T>(R);
  const long long grid = K * ((pre * post + (1 << lc) - 1) >> lc);
  const bool vec = post % mff::kVec16<T> == 0 && !mis(x) && !mis(y);
  auto kern = k3 ? band_kernel<T, 4, 3>(vec) : band_kernel<T, 4, 1>(vec);
  if constexpr (band_cluster<T>(512) == 2) {
    if (K == 2) kern = band_kernel<T, 2, 1>(vec);
  }
  return mff::launch_ex(kern, grid, AxisBandBudget<T>::kThreads,
                        mff::band_smem<T>(R, lc), K, stream, a, b, oa, ob,
                        twr, twi, pre, post, lr, lc, sign, scale);
}

template <class T>
int launch_fft_axis(const T* x, T* y, const T* tw, long long tw_len,
                    long long pre, int n, long long post, int sign,
                    const int* plan, int nstages, T scale, void* stream) {
  mff::Plan p;
  if (!mff::make_plan(plan, nstages, n, &p) || tw_len < n)
    return cudaErrorInvalidValue;
  if (pre > 0 && post > 0) {
    const T* twr = tw + (tw_len - n);
    const int rc = launch_lines_bands(x, y, twr, twr + tw_len, pre, n, post,
                                      static_cast<T>(sign), scale,
                                      static_cast<cudaStream_t>(stream));
    if (rc >= 0) return rc;
  }
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

// x, y: (2, pre, n, post) float32, contiguous, on the current device (y
// may be x).  tw: the (2, tw_len) table of _tw_pack_axis(n, sign), the
// stage twiddles of _tw_pack(n, sign) (the tile kernel's) then the n
// powers of w_n (the line and band kernels').  Returns the error of a
// refused launch, else cudaGetLastError() after the launch.
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
