// fft_axis_tp: planar c2c Stockham FFT along one axis with the 3/2-rule
// dealiasing boundary fused into the pass, for N = 2^a or 3*2^a <= 1024,
// either sign, with an optional scale folded into the write; built for
// float32 and for float64.
//
// * trunc: an N-row input, an Nt-row output (0 < Nt < N).  The spectrum
//   is truncated in the write: rows 0..Nt/2 and the top rows N-(Nt-1)/2..
//   N-1 are kept, and for even Nt row N-Nt/2 is folded onto row Nt/2.
// * pad: an Nt-row input, an N-row output.  The spectrum is zero-padded
//   in the read: for even Nt, row Nt/2 is split in halves between rows
//   Nt/2 and N-Nt/2.
// The maps are _trunc_rows and _pad_rows of the JAX package
// (pallas_butterfly.py:455-481), the reference's 3/2 rule
// (libfft.py:263-311).
//
// Replaces the TPU kernels of mpi4py_fft_tpu/ops/pallas_butterfly.py
// reached from fft_axis_tp :938 through _dispatch_tp :858: _kern_lead_t
// and _kern_lead_pd :553/:561, _kern_mid_t and _kern_mid_pd :530/:542,
// and the ragged-lane wrapper _kern_lead1_tp :918.  One strided kernel
// covers every axis position, the last one too (the JAX gate's exclusion
// of the last axis and its (8, 128) conditions are TPU layout).  The JAX
// kernel is float32 only; the float64 build computes the same function as
// the JAX package's unfused f64 path (transform, then truncate_planar or
// pad_planar).
//
// Bound on an H100: bytes.  A pass reads (2, pre, Nin, post) and writes
// (2, pre, Nout, post) once, (Nin + Nout) * pre * post * 2 * sizeof(T)
// bytes; at about 3 flops a byte (1.6 at f64) it sits below the card's
// ratio of peak flops to bandwidth, as fft_axis.cu does.  The fused
// boundary saves the separate truncation or padding pass, which would
// read and write the smaller volume once more, and the scale pass.
// Design: fft_axis.cu's tile of C lines (butterfly.cuh), with input and
// output line bases of their own (Nin != Nout).  The load reads only the
// input rows the map takes and writes zeros, or the halves of the split
// row, into the rest of the tile; the store writes Nout rows, reading two
// tile rows for the folded one.  Nothing but the two unavoidable passes
// over device memory.
//
// At N = 768 (the dealiased plans' 512 -> 768 axes) two other kernels
// take the pass, chosen by shape and alignment before the launch.  The
// tile holds 16 points a thread across block barriers (float32 40
// registers and 968 B of spill stores a thread; float64 80 and 1852 B)
// and its loads move one element a thread.
// * Inner axes (post > 1: the 'f' and 'd' plans' axis-1 and axis-0
//   passes, 72 a step of the reference DNS solver; the 'F' plan's too):
//   the column band kernel, A's and A64's band at 768 (fft_axis.cu;
//   lines.cuh's band body).  A cluster of K = 4 CTAs (256 threads, three
//   CTAs an SM, lines.cuh's AxisBandBudget; loads in rounds of eight
//   chunks, four on float32 padding reads of single elements) holds
//   R = 192 = 3 * 64 rows each of C = 16 (float64) or 32 (float32)
//   adjacent columns, one radix-4 step across the cluster, a radix-3
//   stage and radix-8/4 stages in place on each CTA's columns, 16-byte
//   vectors of adjacent columns where post is a multiple of a vector and
//   both tensors are aligned (the lead axis, post = 512 * 257; the 'F'
//   plan's post = 512 and 512^2), else single elements (the mid axis,
//   post = 257).  The row map (lines.cuh's PadRows, TruncRows) sits in
//   its read or its write: the pad read loads each input row the map
//   takes (the split row twice, halved) and no zero row; the truncating
//   write stores the nt kept rows, the folded row as the sum of band
//   rows h' and h' + top, which one CTA holds when K divides N - nt (at
//   the 3/2 rule N - nt = N / 3 = 256).  A truncation to an even nt with
//   N - nt not a multiple of K keeps the tile.
// * Whole lines at float32 (post == 1: the 'F' plan's last axis): the
//   line kernel, A's float32 line at 768 (fft_axis.cu; lines.cuh's line
//   body): a warp a line, 24 points a thread in registers, radix-3, 8
//   and 16 Stockham stages through the warp's buffer, 16-byte vectors.
//   The pad read starts the loads of the vectors its points map to (the
//   vector at h' holds the split row and three zero rows, the one at
//   top + h' the split row and input rows h' + 1 ..), and loads no zero
//   vector; then it halves the first lane of those two.  The truncating
//   write reads the nt kept rows back from the buffer in natural order,
//   the fold added to lane 0 of vector h'.  It takes h' and N - nt
//   multiples of 4 (every vector of the map one vector of memory) and
//   16-byte-aligned tensors.
// Every other length, float64 whole lines and the cases above keep the
// tile.  The bound is the bytes: at the 768^3 grid's four passes of the
// 512^3 'f' or 'd' plan (axis 1: 768 <-> 512 rows of 768 x 257 lines;
// axis 0: 768 <-> 512 rows of 512 x 257), (768 + 512) rows x 8 bytes
// (16 at float64) x (768 + 512) x 257 lines x 2 passes = 6.7 GB, 2.01 ms
// at 3.35 TB/s (13.5 GB, 4.02 ms at float64); the 'F' plan's three
// passes a direction (768^2, 768 x 512 and 512^2 lines of 768 <-> 512
// rows) 12.75 GB, 3.81 ms.
#include <cstdint>
#include <type_traits>

#include "lines.cuh"

namespace {

using mff::Half;

// Offsets of element 0 of each tile line in the input (rows n_in) and the
// output (rows n_out); -1 past the last line.
__device__ __forceinline__ void line_bases2(long long* bin, long long* bout,
                                            long long l0, long long nlines,
                                            int C, int n_in, int n_out,
                                            long long post) {
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const long long l = l0 + c;
    if (l < nlines) {
      const long long a = l / post, b = l % post;
      bin[c] = a * n_in * post + b;
      bout[c] = a * n_out * post + b;
    } else {
      bin[c] = -1;
      bout[c] = -1;
    }
  }
}

// Element (line c, row k) of a flat index over a tile of rows x C lines:
// neighbours along a line when post == 1, across lines otherwise.
__device__ __forceinline__ void tile_index(int idx, int rows, int lc,
                                           long long post, int* c, int* k) {
  if (post == 1) {
    *c = idx / rows;
    *k = idx - *c * rows;
  } else {
    *c = idx & ((1 << lc) - 1);
    *k = idx >> lc;
  }
}

// (2, pre, Nin, post) -> (2, pre, Nout, post) along an n-point transform;
// pad == 0: Nin = n, Nout = nt; pad == 1: Nin = nt, Nout = n.
template <class T, int kBlocks>
__global__ void __launch_bounds__(mff::Budget<T>::kTile / 16, kBlocks)
fft_axis_tp_kernel(const T* __restrict__ x, T* __restrict__ y,
                   const T* __restrict__ tw, long long tw_len,
                   long long pre, int n, int nt, int pad, long long post,
                   T sign, mff::Plan plan, T scale, int lc) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = 1 << lc;
  const int n_in = pad ? nt : n;
  const int n_out = pad ? n : nt;
  long long* bin = reinterpret_cast<long long*>(smem);
  long long* bout = bin + C;
  mff::Tile<T> t;
  t.lc = lc;
  t.cp = C + 1;
  t.re = reinterpret_cast<T*>(bout + C);
  t.im = t.re + n * t.cp;
  const long long nlines = pre * post;
  line_bases2(bin, bout, static_cast<long long>(blockIdx.x) << lc, nlines,
              C, n_in, n_out, post);
  __syncthreads();

  // the head keeps rows 0..h (h = nt/2); the top nt-1-h rows of the
  // spectrum sit at n-(nt-1-h)..n-1; for even nt row h is the one split
  // between rows h and n-h (pad) or folded from row n-h (trunc)
  const int h = nt / 2;
  const bool even = (nt & 1) == 0;
  const int top = n - nt;           // shift of the top rows

  const long long pin = nlines * n_in;
  for (int idx = threadIdx.x; idx < (n << lc); idx += blockDim.x) {
    int c, k;
    tile_index(idx, n, lc, post, &c, &k);
    const long long b = bin[c];
    T vr = 0, vi = 0;
    if (b >= 0) {
      int src = k;                  // trunc: the whole line
      T f = 1;
      if (pad) {
        if (k < h || (!even && k == h)) {
          src = k;
        } else if (k > top + h) {
          src = k - top;
        } else if (even && (k == h || k == top + h)) {
          src = h;
          f = T(0.5);
        } else {
          src = -1;
        }
      }
      if (src >= 0) {
        const long long a = b + src * post;
        vr = x[a] * f;
        vi = x[pin + a] * f;
      }
    }
    t.re[k * t.cp + c] = vr;
    t.im[k * t.cp + c] = vi;
  }
  __syncthreads();

  mff::run_plan(t, n, plan, tw, tw + tw_len, sign);

  const long long pout = nlines * n_out;
  for (int idx = threadIdx.x; idx < (n_out << lc); idx += blockDim.x) {
    int c, j;
    tile_index(idx, n_out, lc, post, &c, &j);
    const long long b = bout[c];
    if (b < 0) continue;
    T r, i;
    if (pad || j < h || (!even && j == h)) {
      r = t.re[j * t.cp + c] * scale;
      i = t.im[j * t.cp + c] * scale;
    } else if (j > h) {
      r = t.re[(j + top) * t.cp + c] * scale;
      i = t.im[(j + top) * t.cp + c] * scale;
    } else {                        // even nt, j == h: fold row n-h on h
      const int s = (h + top) * t.cp + c;
      r = t.re[h * t.cp + c] * scale + t.re[s] * scale;
      i = t.im[h * t.cp + c] * scale + t.im[s] * scale;
    }
    const long long a = b + j * post;
    y[a] = r;
    y[pout + a] = i;
  }
}

// ---------------------------------------------------------------------------
// N = 768: the column band kernel (post > 1) and, at float32, the line
// kernel (post == 1)
// ---------------------------------------------------------------------------

// CTAs a band (a cluster) and the length the band and line kernels take:
// A's and A64's band at 768 (fft_axis.cu), 4 CTAs of R = 192 = 3 * 64
// rows and 16 (float64) or 32 (float32) columns, a radix-3 column stage
// first.
constexpr int kTpBandN = 768;
constexpr int kTpBandK = 4;

// The band CTA's budget: A's (lines.cuh's AxisBandBudget: float64 4096
// points, float32 8192, on 256 threads, three CTAs an SM), with eight
// chunks a load round in place of A's two (float64) or four (float32),
// except on float32 padding reads of single elements.  On an H100, at
// float64 eight ran the dealiased 512^3 'd' plan's four passes faster
// than two or four (80 registers, 24-36 B of spill stores), as clusters
// of 4 CTAs did against 8; at float32 eight ran the 'f' and 'F' plans'
// band passes faster than four (80 registers, no spill), but for the
// padding read of single elements (the 'f' plan's mid axis), and D's
// 512 threads, two CTAs an SM, slower (tools/line_band_ab.py, PERF.md
// §6).
template <class T, bool kVec = true, class Map = mff::AllRows>
struct TpBandBudget : mff::AxisBandBudget<T> {
  static constexpr int kRound =
      sizeof(T) == 4 && !kVec && Map::kMode == mff::PadRows::kMode ? 4 : 8;
};

// lines.cuh's band body with the row map Map in its read (PadRows) or its
// write (TruncRows), on TpBandBudget.
template <class T, int K, bool kVec, int kB, class Map>
__global__ void __launch_bounds__(TpBandBudget<T, kVec, Map>::kThreads,
                                  TpBandBudget<T, kVec, Map>::kMinBlocks)
fft_axis_tp_band_kernel(Half<const T> a, Half<const T> b, Half<T> oa,
                        Half<T> ob, const T* __restrict__ twr,
                        const T* __restrict__ twi, long long pre,
                        long long post, int lr, int lc, T sign, T scale,
                        Map map) {
  extern __shared__ __align__(16) unsigned char smem[];
  mff::axis_band<T, K, kVec, kB, TpBandBudget<T, kVec, Map>, Map>(
      a, b, oa, ob, twr, twi, pre, post, lr, lc, sign, scale,
      reinterpret_cast<T*>(smem), map);
}

template <class T, class Map>
auto tp_band_kernel(bool vec) {
  return vec ? &fft_axis_tp_band_kernel<T, kTpBandK, true, 3, Map>
             : &fft_axis_tp_band_kernel<T, kTpBandK, false, 3, Map>;
}

// The operands of a pass of x into y on the band or line body: the side
// of n rows in two halves, the other of nt rows in `a` (pad) or `oa`
// (trunc) alone.
template <class T>
struct TpOperands {
  Half<const T> a, b;
  Half<T> oa, ob;
  TpOperands(const T* x, T* y, long long pre, int n, int nt, int pad,
             long long post) {
    const int n_in = pad ? nt : n, n_out = pad ? n : nt;
    const long long pin = pre * n_in * post, pout = pre * n_out * post;
    const long long h = (n / 2) * post;
    a = {x, pin, n_in * post};
    b = {x + h, pin, n_in * post};
    oa = {y, pout, n_out * post};
    ob = {y + h, pout, n_out * post};
  }
};

inline bool misaligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 != 0;
}

// The band kernel for a pass of x into y, or -1 if it does not take it:
// n = 768, post > 1, and for a truncation of even nt the folded rows h'
// and h' + top in one CTA (K divides n - nt).  16-byte vectors of
// adjacent columns when post is a multiple of a vector and x and y are
// 16-byte aligned, else single elements.  twr, twi: the powers of w_n.
template <class T>
int launch_tp_band(const T* x, T* y, const T* twr, const T* twi,
                   long long pre, int n, int nt, int pad, long long post,
                   T sign, T scale, cudaStream_t stream) {
  if (n != kTpBandN || post <= 1) return -1;
  if (!pad && nt % 2 == 0 && (n - nt) % kTpBandK != 0) return -1;
  const bool vec = post % mff::kVec16<T> == 0 && !misaligned16(x) &&
                   !misaligned16(y);
  const int R = n / kTpBandK;                  // 3 * 2^lr rows a CTA
  const int lr = mff::log2_of(R / 3);
  const int lc = mff::band_log2_cols<T>(R);
  const long long grid = kTpBandK * ((pre * post + (1 << lc) - 1) >> lc);
  const std::size_t smem = mff::band_smem<T>(R, lc);
  const int threads = TpBandBudget<T>::kThreads;
  const TpOperands<T> o(x, y, pre, n, nt, pad, post);
  if (pad)
    return mff::launch_ex(tp_band_kernel<T, mff::PadRows>(vec), grid,
                          threads, smem, kTpBandK, stream, o.a, o.b, o.oa,
                          o.ob, twr, twi, pre, post, lr, lc, sign, scale,
                          mff::PadRows{nt});
  return mff::launch_ex(tp_band_kernel<T, mff::TruncRows>(vec), grid,
                        threads, smem, kTpBandK, stream, o.a, o.b, o.oa,
                        o.ob, twr, twi, pre, post, lr, lc, sign, scale,
                        mff::TruncRows{nt});
}

// Points a thread of the line kernel holds: A's float32 line at 768
// (fft_axis.cu), 24, so that a warp holds a line.
constexpr int kTpLineP = 24;

// lines.cuh's line body with the row map Map in its read (PadRows) or its
// write (TruncRows), on A's launch (LineLaunch: 128 threads, four blocks
// an SM at float32).
template <class T, int N, class Map>
__global__ void __launch_bounds__(mff::LineLaunch<T>::kThreads,
                                  mff::LineLaunch<T>::kMinBlocks)
fft_axis_tp_lines_kernel(Half<const T> a, Half<const T> b, Half<T> oa,
                         Half<T> ob, const T* __restrict__ twr,
                         const T* __restrict__ twi, long long lines, T sign,
                         T scale, Map map) {
  extern __shared__ __align__(16) unsigned char smem[];
  mff::line_body<T, N, kTpLineP, Map>(a, b, oa, ob, twr, twi, lines, sign,
                                      scale, reinterpret_cast<T*>(smem),
                                      map);
}

// The line kernel for a pass of x into y, or -1 if it does not take it:
// float32, n = 768, whole lines (post == 1), h' = nt/2 and n - nt
// multiples of a 16-byte vector (so every vector of the map is one
// vector of the input or the output), x and y 16-byte aligned.
template <class T>
int launch_tp_lines(const T* x, T* y, const T* twr, const T* twi,
                    long long pre, int n, int nt, int pad, long long post,
                    T sign, T scale, cudaStream_t stream) {
  if constexpr (!std::is_same<T, float>::value) {
    return -1;
  } else {
    constexpr int V = mff::kVec16<T>, G = kTpBandN / kTpLineP;
    constexpr int threads = mff::LineLaunch<T>::kThreads;
    if (n != kTpBandN || post != 1) return -1;
    if ((nt / 2) % V != 0 || (n - nt) % V != 0) return -1;
    if (misaligned16(x) || misaligned16(y)) return -1;
    const long long blocks = (pre + threads / G - 1) / (threads / G);
    const std::size_t smem =
        sizeof(T) * 2 * mff::row_buf(kTpBandN) * (threads / G);
    const TpOperands<T> o(x, y, pre, n, nt, pad, post);
    if (pad)
      return mff::launch_ex(
          &fft_axis_tp_lines_kernel<T, kTpBandN, mff::PadRows>, blocks,
          threads, smem, 1, stream, o.a, o.b, o.oa, o.ob, twr, twi, pre,
          sign, scale, mff::PadRows{nt});
    return mff::launch_ex(
        &fft_axis_tp_lines_kernel<T, kTpBandN, mff::TruncRows>, blocks,
        threads, smem, 1, stream, o.a, o.b, o.oa, o.ob, twr, twi, pre, sign,
        scale, mff::TruncRows{nt});
  }
}

template <class T>
int launch_fft_axis_tp(const T* x, T* y, const T* tw, long long tw_len,
                       long long pre, int n, int nt, int pad, long long post,
                       int sign, const int* plan, int nstages, T scale,
                       void* stream) {
  mff::Plan p;
  if (!mff::make_plan(plan, nstages, n, &p) || tw_len < n)
    return cudaErrorInvalidValue;
  if (nt < 1 || nt >= n || (pad != 0 && pad != 1))
    return cudaErrorInvalidValue;
  if (pre > 0 && post > 0) {
    const T* twr = tw + (tw_len - n);
    const auto st = static_cast<cudaStream_t>(stream);
    int rc = launch_tp_band(x, y, twr, twr + tw_len, pre, n, nt, pad, post,
                            static_cast<T>(sign), scale, st);
    if (rc < 0)
      rc = launch_tp_lines(x, y, twr, twr + tw_len, pre, n, nt, pad, post,
                           static_cast<T>(sign), scale, st);
    if (rc >= 0) return rc;
  }
  const int lc = mff::tile_log2_lines<T>(n);
  const int C = 1 << lc;
  const long long nlines = pre * post;
  const long long blocks = (nlines + C - 1) / C;
  if (nlines <= 0 || blocks > 0x7fffffffLL || ((n << lc) % 16) != 0)
    return cudaErrorInvalidValue;
  const int threads = (n << lc) / 16;
  const size_t smem = 2 * sizeof(long long) * C +
                      2 * sizeof(T) * static_cast<size_t>(n) * (C + 1);
  using B = mff::Budget<T>;
  auto kern = mff::pick_bound<T>(smem,
                                 &fft_axis_tp_kernel<T, B::kMinBlocks>,
                                 &fft_axis_tp_kernel<T, B::kWideMinBlocks>);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kern<<<static_cast<unsigned>(blocks), threads, smem,
         static_cast<cudaStream_t>(stream)>>>(
      x, y, tw, tw_len, pre, n, nt, pad, post, static_cast<T>(sign), p,
      scale, lc);
  return cudaGetLastError();
}

}  // namespace

// x: (2, pre, n, post) (pad == 0) or (2, pre, nt, post) (pad == 1);
// y: (2, pre, nt, post) or (2, pre, n, post); float32, contiguous, on the
// current device.  tw: the (2, tw_len) table of _tw_pack_axis(n, sign),
// the stage twiddles (the tile kernel's) then the n powers of w_n (the
// band and line kernels').  Returns the error of a refused launch, else
// cudaGetLastError() after the launch.
extern "C" int mff_fft_axis_tp_f32(const float* x, float* y, const float* tw,
                                   long long tw_len, long long pre, int n,
                                   int nt, int pad, long long post, int sign,
                                   const int* plan, int nstages, float scale,
                                   void* stream) {
  return launch_fft_axis_tp(x, y, tw, tw_len, pre, n, nt, pad, post, sign,
                            plan, nstages, scale, stream);
}

// The same for float64 x, y and tw, with a double scale.
extern "C" int mff_fft_axis_tp_f64(const double* x, double* y,
                                   const double* tw, long long tw_len,
                                   long long pre, int n, int nt, int pad,
                                   long long post, int sign, const int* plan,
                                   int nstages, double scale, void* stream) {
  return launch_fft_axis_tp(x, y, tw, tw_len, pre, n, nt, pad, post, sign,
                            plan, nstages, scale, stream);
}
